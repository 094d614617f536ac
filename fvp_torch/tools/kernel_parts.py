"""Where a kernel's time goes: scratch builds of one `fvp_torch/csrc`
source with parts switched off, each timed on the card at chip_smoke.py's
inputs (flagship widths, seeded weights, frame 0's heatmaps).

    python -m fvp_torch.tools.kernel_parts --kernel person_planes
        [--set old|new] [--source FILE]
    python -m fvp_torch.tools.kernel_parts --kernel centernet
        [--variants shipped,no_compute,...]

Each variant is the source with text substitutions (each must match once,
or the script fails) and its own nvcc flags, built by its own nvcc (all in
parallel) into `build/parts/`, loaded with ctypes, and timed through its
entry point alone (chip_smoke.time_ms: CUDA events behind a ~1 ms spin of
the card, median of 20). The variants compute wrong values on purpose;
only their device time counts.

- person_planes, at 10 people with full 64^3 cubes: `--set old` is PR 1's
  kernel (scalar gathers from (B, V, J, H, W) maps, built with
  --fmad=false; `git show <parent>:fvp_torch/csrc/person_planes.cu`),
  `--set new` the tree's pixel-major kernel, on its layout made once
  (the planes kernel alone).
- centernet, the one cooperative launch at (1, 80, 80, 15).

Prints one JSON line per variant and appends them to
`chiprun_out/kernel_parts.json`.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

from fvp_torch.ops.kernels import _build

_EXITS = [
    (r"atomicMax\(&xz_s\[\(xi \* NC \+ z\) \* JT \+ j\], "
     r"__float_as_int\(val\[j\]\)\);",
     "xz_s[(xi * NC + z) * JT + j] = __float_as_int(val[j]);"),
    (r"atomicMax\(&xz_g\[pbase \+ \(long long\)\(x0 \+ xi\) \* NC \* JT"
     r" \+ r\], v\);",
     "xz_g[pbase + (long long)(x0 + xi) * NC * JT + r] = v;"),
    (r"atomicMax\(&yz_g\[pbase \+ \(\(long long\)y \* NC \+ z\) \* JT "
     r"\+ j\],\s*__float_as_int\(yzmax\[j\]\)\);",
     "yz_g[pbase + ((long long)y * NC + z) * JT + j] = "
     "__float_as_int(yzmax[j]);"),
]

# (name, [(regex, replacement)], nvcc flags)
PERSON_OLD = [
    ("shipped", [], ["--fmad=false"]),
    ("fmad", [], []),
    ("const_proj", [(r"const float\* c = cams \+ 27 \* v;.*?"
                     r"const float sy = \(gy \+ 1\.f\) \* 0\.5f \* hm1;",
                     "const float sx = 0.37f * wm1 + 0.01f * v, "
                     "sy = 0.41f * hm1;")], ["--fmad=false"]),
    ("no_gather", [(r"val\[j\] \+= __ldg\(h \+ o00\).*?w11;",
                    "val[j] += (float)(o00 + j) * w00 + (float)o10 * w10"
                    " + (float)o01 * w01 + (float)o11 * w11 + h[0] * 0.f;")],
     ["--fmad=false"]),
    ("plain_exits", _EXITS, ["--fmad=false"]),
]
PERSON_NEW = [
    ("shipped", [], []),
    ("const_proj", [(r"const float\* c = cams \+ 27 \* v;.*?"
                     r"const float sy = mul\(mul\(add\(gy, 1\.f\), 0\.5f\), "
                     r"hm1\);",
                     "const float sx = 0.37f * wm1 + 0.01f * v, "
                     "sy = 0.41f * hm1;")], []),
    ("no_gather", [(r"const float4 a = __ldg\(p00 \+ q\), b = __ldg\(p10 "
                    r"\+ q\),\s*e = __ldg\(p01 \+ q\), f = __ldg\(p11 \+ "
                    r"q\);",
                    "const float4 a = make_float4(0.1f * q, 0.2f, 0.3f, "
                    "0.4f), b = a, e = a, f = a;")], []),
    ("plain_exits", _EXITS, []),
]
CENTERNET = [
    ("shipped", [], []),
    ("no_compute", [(r"while \(tap < taps\) \{", "while (tap < 0) {"),
                    (r"for \(int q = kg; q < nq; q \+= wk\) \{",
                     "for (int q = kg; q < 0; q += wk) {")], []),
    ("no_staging", [(r"\n  stage\(0, 0\);", "\n"),
                    (r"\n      stage\(ch \+ 1, \(ch \+ 1\) & 1\);", "\n")],
     []),
    ("no_barrier", [(r"cg::this_grid\(\)\.sync\(\);", "")], []),
    ("two_blocks_per_sm", [(r"__launch_bounds__\(kThreads, 1\)",
                            "__launch_bounds__(kThreads, 2)")], []),
]
SETS = {("person_planes", "old"): PERSON_OLD,
        ("person_planes", "new"): PERSON_NEW,
        ("centernet", "new"): CENTERNET}
OUT = Path("build") / "parts"


def variant_source(src: str, subs) -> str:
    for pat, rep in subs:
        src, n = re.subn(pat, lambda _m, r=rep: r, src, flags=re.S)
        if n != 1:
            raise RuntimeError(f"substitution {pat!r} matched {n} times")
    return src


def build(source: Path, variants) -> dict[str, Path]:
    """One shared library per variant (its source beside whole_sample.cu,
    which holds fvp_error_string), compiled in parallel."""
    OUT.mkdir(parents=True, exist_ok=True)
    text = source.read_text()
    nvcc = _build._nvcc()
    procs = {}
    for name, subs, flags in variants:
        cu = OUT / f"{source.stem}_{name}.cu"
        cu.write_text(variant_source(text, subs))
        lib = OUT / f"{source.stem}_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *_build.FLAGS, *flags, "-I", str(_build.CSRC), "-shared",
             str(cu), str(_build.CSRC / "whole_sample.cu"), "-o", str(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        libs[name] = lib
    return libs


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _build.SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    lib.fvp_error_string.argtypes = [ctypes.c_int]
    lib.fvp_error_string.restype = ctypes.c_char_p
    return lib


def _smoke_predictor():
    import torch

    from chip_smoke import MIN_SCORE, blob_heatmaps, random_state_dict
    from fvp_torch.config import FVPConfig
    from fvp_torch.engine.serve import Predictor
    from fvp_torch.geometry.cameras import default_ring_rig
    from fvp_torch.models.faster_voxelpose import FasterVoxelPose

    cfg = FVPConfig(backbone="", min_score=MIN_SCORE)
    rig = default_ring_rig(cfg.num_views, cfg.space_center,
                           cfg.ori_image_size)
    pred = Predictor.from_state_dict(
        cfg, random_state_dict(FasterVoxelPose(cfg), seed=0), rig,
        device="cuda")
    hm = torch.as_tensor(blob_heatmaps(cfg, rig, seed=0), device="cuda")
    return pred, hm


def person_call(kind):
    """A function of the variant's library that runs its planes kernel on
    chip_smoke's K2 inputs: 10 people, full cubes."""
    import numpy as np
    import torch

    from fvp_torch.ops.kernels import sampler as ksamp

    pred, hm = _smoke_predictor()
    cfg, rc = pred.cfg, pred.rc
    prs = np.random.RandomState(1)
    centers = torch.as_tensor(np.stack([
        prs.uniform(-3000, 3000, 10), prs.uniform(-3500, 2500, 10),
        prs.uniform(700, 1100, 10)], axis=1)[None].astype(np.float32),
        device="cuda")
    bbox = torch.ones((1, 10, 2), device="cuda")
    mask = torch.ones((1, 10), dtype=torch.bool, device="cuda")
    corner, start, end, _ = ksamp.person_bounds(centers, bbox, mask, cfg)
    B, V, J, H, W = hm.shape
    P, n = corner.shape[0], cfg.ind_voxels_per_axis[0]
    if kind == "new":
        hmp = ksamp.pixel_major(hm)

        def make(lib):
            def run():
                _build._lib = lib
                ksamp.sample_planes(hmp, rc, cfg, corner, start, end, J)
            return run
        return make

    planes = torch.zeros((3, P, n, n, J), device="cuda")
    ptrs = [t.data_ptr() for t in (hm, rc.cam_params, corner, start, end,
                                   planes)]
    _p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

    def make(lib):                         # PR 1's entry point
        lib.fvp_person_planes.argtypes = [_p] * 6 + [_i] * 7 + [_f] * 7 \
            + [_p]

        def run():
            err = lib.fvp_person_planes(
                *ptrs, V, J, H, W, n, P // B, P, *ksamp.person_geometry(cfg),
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(lib.fvp_error_string(err).decode())
        return run
    return make


def centernet_call(kind):
    """A function of the variant's library that runs the CenterNet launch
    on frame 0's BEV map with the smoke's weights."""
    import torch

    from fvp_torch.ops.kernels import centernet as kcn
    from fvp_torch.ops.kernels import sampler as ksamp

    pred, hm = _smoke_predictor()
    bev = ksamp.whole_sample_plain(hm, pred.rc, pred.cfg).amax(dim=3) \
        .contiguous()
    pc = pred.packed["center_net"]
    arena = torch.empty(kcn.centernet_plan(*bev.shape).arena_floats,
                        device="cuda")

    def make(lib):
        def run():
            _build._lib = lib
            kcn.launch(pc, bev, arena)
        return run
    return make


def main() -> int:
    import torch

    from chip_smoke import time_ms

    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", default="person_planes",
                    choices=("person_planes", "centernet"))
    ap.add_argument("--set", default="new", choices=("old", "new"))
    ap.add_argument("--source")
    ap.add_argument("--variants", help="comma-separated names (default: "
                    "all of the set)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_parts: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    source = Path(args.source or _build.CSRC / f"{args.kernel}.cu")
    variants = SETS[(args.kernel, args.set)]
    if args.variants:
        keep = args.variants.split(",")
        variants = [v for v in variants if v[0] in keep]
    libs = build(source, variants)
    call = person_call if args.kernel == "person_planes" else centernet_call
    make = call(args.set)
    rows = []
    with torch.inference_mode():
        for name, path in libs.items():
            ms = time_ms(make(load(path)))
            rows.append({"kernel": args.kernel, "set": args.set,
                         "source": str(source), "variant": name, "ms": ms,
                         "card": card})
            print(json.dumps(rows[-1]), flush=True)
    _build._lib = None
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    with open(out / "kernel_parts.json", "a") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
