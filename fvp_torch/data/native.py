"""ctypes bridge to the port's native (C++) host heatmap renderer.

`csrc/heatmap_renderer.cc` is the reference package's
native/heatmap_renderer.cc, its code byte for byte
(tests/test_torch_native.py checks it): the gaussian renderer of data/heatmaps.py with its
augmentation drawn from a seeded xorshift stream. The reference's data
pipeline renders host heatmaps through it where it is built
(fvp_tpu/data/native.py), and so does the port's (data/base.py), from the
seed it draws from the sample's RNG: a seeded sample is then bit for bit
the reference's with its native renderer on.

The library is built with g++ and the reference's flags on first use,
into `build/fvp_torch/` at the repo root, under a name that carries a
hash of the source and flags. A build that fails raises with the
compiler's output: nothing falls back to numpy quietly, which would
change the augmentation's draws. `ENABLED = False` switches the native
path off (the numpy renderer then draws from the sample's RNG, as the
reference package does when its library is missing).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

PKG = Path(__file__).resolve().parents[1]
SRC = PKG / "csrc" / "heatmap_renderer.cc"
BUILD_DIR = PKG.parent / "build" / "fvp_torch"
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

# the native path; tests switch it off to compare with the numpy renderer
ENABLED = True

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    h = hashlib.sha256(repr(FLAGS).encode() + SRC.read_bytes())
    return BUILD_DIR / f"libfvp_native_{h.hexdigest()[:12]}.so"


def build(compiler: str = "g++") -> Path:
    """Compile the renderer (if it is not built yet); returns the
    library's path. Raises RuntimeError with the compiler's output when
    the build fails."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    try:
        proc = subprocess.run([compiler, *FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"native heatmap renderer: cannot run "
                           f"{compiler!r}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"native heatmap renderer: {compiler} failed "
                           f"(exit {proc.returncode}) on {SRC}:\n"
                           f"{proc.stdout}{proc.stderr}")
    tmp.replace(lib)
    return lib


def get_lib() -> ctypes.CDLL:
    """The renderer's library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.render_heatmaps.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_float, ctypes.c_float,
                ctypes.c_int, ctypes.c_uint64]
            lib.render_heatmaps.restype = None
            _lib = lib
        return _lib


def generate_input_heatmap_native(cfg, joints, joints_vis=None,
                                  augment: bool = False, seed: int = 0
                                  ) -> np.ndarray | None:
    """data/heatmaps.py::generate_input_heatmap on the native renderer,
    its augmentation from the seeded native stream. joints: a list of (J,
    >= 2) arrays in working-image coords. Returns (J, hm_h, hm_w), or None
    where the native path is switched off or there is nobody (the caller
    then renders with numpy, as the reference does)."""
    if not ENABLED or len(joints) == 0:
        return None
    lib = get_lib()
    n_people = len(joints)
    n_joints = joints[0].shape[0]
    hm_w, hm_h = cfg.heatmap_size
    jarr = np.ascontiguousarray(
        np.stack([np.asarray(j)[:, :2] for j in joints]), np.float32)
    vptr = None
    if joints_vis is not None:
        varr = np.ascontiguousarray(
            np.stack([np.asarray(v) for v in joints_vis]) > 0
        ).astype(np.uint8)
        vptr = varr.ctypes.data_as(ctypes.c_void_p)
    out = np.zeros((n_joints, hm_h, hm_w), np.float32)
    sx = cfg.image_size[0] / cfg.heatmap_size[0]
    sy = cfg.image_size[1] / cfg.heatmap_size[1]
    lib.render_heatmaps(
        jarr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), vptr,
        n_people, n_joints,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        hm_w, hm_h, ctypes.c_float(sx), ctypes.c_float(sy),
        ctypes.c_float(cfg.sigma), int(bool(augment)),
        ctypes.c_uint64(seed & (2 ** 64 - 1)))
    return out
