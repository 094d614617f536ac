"""Build the port's CUDA kernels and load them with ctypes.

Every `fvp_torch/csrc/*.cu` file is compiled by its own `nvcc` process (all
started together) for `sm_90a` into an object file, and the objects are
linked into one shared library with a plain C interface under
`build/fvp_torch/` at the repo root. The library's name carries a hash of
the sources and flags, so an edited source builds anew. Nothing is built
when this module is imported: the first kernel launch calls `load()`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD_DIR = PKG.parent / "build" / "fvp_torch"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = [ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points and their argument types (pointers, ints, floats, stream)
SIGNATURES = {
    "fvp_whole_sample": [_P, _P, _P] + [_I] * 7 + [_P],
    "fvp_person_layout": [_P, _P] + [_I] * 5 + [_P],
    "fvp_person_planes": [_P] * 6 + [_I] * 8 + [_F] * 7 + [_P],
    "fvp_centernet": [_P] * 5 + [_I] * 5 + [_P],
    "fvp_centernet_bf16": [_P] * 7 + [_I] * 7 + [_P],
    "fvp_soft_argmax": [_P] * 6 + [_I] * 6 + [_F, _P],
    "fvp_weightnet_pool": [_P] * 7 + [_I] * 11 + [_P],
    "fvp_weightnet_pool_bf16": [_P] * 6 + [_I] * 11 + [_P],
    "fvp_stem": [_P] * 4 + [_I] * 10 + [_P],
    "fvp_deconv_stage": [_P] * 4 + [_I] * 10 + [_P],
    "fvp_conv_bf16": [_P, _I, _P, _P, _P, _I, _P] + [_I] * 9 + [_P],
    "fvp_conv_wgmma": [_P] * 4 + [_I, _P] + [_I] * 15 + [_P],
    "fvp_maxpool2_bf16": [_P, _P] + [_I] * 4 + [_P],
    "fvp_c2cnet": [_P] * 6 + [_I] * 11 + [_P],
}

_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build fvp_torch's kernels")
    return path


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(repr(FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libfvp_kernels_{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the sources in parallel and link the library (if it is not
    already built). Returns its path; the compilers' -Xptxas -v reports go
    to `ptxas.log` beside it."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in sources():
        obj = BUILD_DIR / (src.stem + ".o")
        procs.append((src, subprocess.Popen(
            [nvcc, *FLAGS, "-I", str(CSRC),
             "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    (BUILD_DIR / "ptxas.log").write_text("\n".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = lib.with_suffix(".tmp.so")
    objs = [str(BUILD_DIR / (s.stem + ".o")) for s in sources()]
    subprocess.run([nvcc, ARCH, "-shared", "-o", str(tmp), *objs],
                   check=True)
    tmp.replace(lib)
    return lib


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.fvp_error_string.argtypes = [ctypes.c_int]
        lib.fvp_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
