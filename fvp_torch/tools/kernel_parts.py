"""Where a kernel's time goes: scratch builds of one `fvp_torch/csrc`
source with parts switched off, each timed on the card at chip_smoke.py's
inputs (flagship widths, seeded weights, frame 0's heatmaps).

    python -m fvp_torch.tools.kernel_parts --kernel person_planes
        [--set old|new] [--source FILE]
    python -m fvp_torch.tools.kernel_parts --kernel centernet
        [--variants shipped,no_compute,...]
    python -m fvp_torch.tools.kernel_parts --kernel centernet_bf16
        [--set trace] [--source FILE] [--repeat 8]
    python -m fvp_torch.tools.kernel_parts --kernel weightnet_pool_bf16
        [--rows R] [--repeat 8]
    python -m fvp_torch.tools.kernel_parts --kernel c2cnet|weightnet_pool
        [--set old --source FILE] [--rows R]
    python -m fvp_torch.tools.kernel_parts --kernel c2cnet --set trace
    python -m fvp_torch.tools.kernel_parts --kernel c2cnet --set flips
        --source FILE [--trials 25]
    python -m fvp_torch.tools.kernel_parts --kernel soft_argmax

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
- centernet, the one cooperative launch at (1, 80, 80, 15);
  centernet_bf16, the bf16 kernel's one launch there (its weights packed
  by pack_centernet_bf16), with the mma loops, the staging, the grid
  barrier, the weight prefetch across it or the epilogue's stores off, or
  two blocks an SM; `--set trace`: block 0's cycles per stage (a stamped
  build: each tile's staging, K sums and epilogue, the wait at the grid
  barrier and the barrier); `--repeat 8` at the eval batch's (8, 80, 80,
  15), `--source FILE` an earlier source on the tree's plan;
- weightnet_pool_bf16, the tree's banded bf16 pool on chip_smoke's K5
  input (`--repeat 8`: the eval batch's 240 maps, as chip_smoke repeats
  them) on its plan, or on bands of `--rows` rows.
- c2cnet and weightnet_pool, `--set new`: the tree's kernels on their
  plans (`--rows` gives weightnet_pool's band height), with the GEMM, the
  weight copies, the epilogue's stores or the zeroing off, the generic
  GEMM loop or single n8 tiles on 16 warps (c2cnet), and the compute, the
  tile load, the affine (on each conv output, where the kernel now takes
  it after the max), the register budget (two blocks per SM) or the
  channel group (8 a thread) changed (weightnet_pool);
- soft_argmax, `--set new`: the tree's kernel on its plan at chip_smoke's
  K4 input, with the loads, the block max, the exponentials, the shuffles
  of the block's exp-sums, the combine of the last blocks, the fence
  before a block's count or everything off (`empty`: the launch alone);
- c2cnet and weightnet_pool, `--set old`: the earlier kernels (one block per
  z-column with scalar FMAs; one block per (n, j) map with strided
  gathers; `git show <commit>:fvp_torch/csrc/c2cnet.cu > FILE`),
  through their old entry points: C2CNet on frame 0's z-columns (10, 20,
  15) of the `fuse_p2p` predictor, weightnet_pool on P2PNet's output of
  K2's planes (30, 64, 64, 15);
- c2cnet, `--set trace`: the tree's kernel with clock64() stamps, on
  (10, 20, 15) random columns; for CTA 0 and each GEMM phase the cycles
  from the phase's start (after its weight wait) to the end of the first
  item's GEMM and of all items, for warp 0 and the last warp, and to the
  end of the phase's barrier;
- c2cnet, `--set flips`: the tree's kernel (the plan's ring and a ring of
  one slot) and the one of FILE (an earlier source with the entry point
  fvp_c2cnet(cols, w, aff, out, N, Z, J, stream)) against the plain
  version over `--trials` seeded random inputs at the card test's shapes
  (tests/test_torch_kernels_cuda.py::test_c2cnet_kernel): per shape and
  kernel the largest error over the output's scale and how many inputs
  land above the test's 5e-3 and above 0 (bf16 roundings that flip where
  two float32 sums in another order straddle a rounding boundary, carried
  on through the net).

Prints one JSON line per variant (or row) and appends them to
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
CENTERNET_BF16 = [
    ("shipped", [], []),
    ("no_compute", [(r"for \(int dy = 0; dy < k; \+\+dy\)",
                     "for (int dy = 0; dy < 0; ++dy)")], []),
    ("no_staging", [(r"\n  stage\(0, 0\);", "\n"),
                    (r"\n      stage\(ch \+ 1, \(ch \+ 1\) & 1\);",
                     "\n")], []),
    ("no_barrier", [(r"cg::this_grid\(\)\.sync\(\);", "")], []),
    ("no_stores", [(r"\*reinterpret_cast<uint32_t\*>\(out \+ o\) = "
                    r"pack2\(v0, v1\);",
                    "if (v0 == 1234.5f) *reinterpret_cast<uint32_t*>"
                    "(out + o) = pack2(v0, v1);")], []),
    ("two_blocks_per_sm", [(r"__launch_bounds__\(kThreads, 1\)",
                            "__launch_bounds__(kThreads, 2)")], []),
]
# block 0's events, (code, cycles since the launch) pairs in a device
# array that an added entry point copies out: 1 a tile's first chunk
# staged, 2 its K summed, 3 its epilogue done, 4 the block at the grid
# barrier, 5 past it
_STAMP = ("if (blockIdx.x == 0 && threadIdx.x == 0 && g_ev < 256) {{ "
          "g_tr[2 * g_ev] = {code}.f; g_tr[2 * g_ev + 1] = "
          "(float)(clock64() - g_t0); ++g_ev; }}")
CENTERNET_BF16_TRACE = [("trace", [
    (re.escape("typedef __nv_bfloat16 bf16;\n"),
     "typedef __nv_bfloat16 bf16;\n__device__ long long g_t0;\n"
     "__device__ int g_ev;\n__device__ float g_tr[512];\n"),
    (re.escape("}  // namespace\n"),
     "}  // namespace\n\nFVP_API int fvp_trace_copy(float* dst, "
     "void* stream) {\n  return (int)cudaMemcpyFromSymbolAsync(dst, g_tr, "
     "sizeof(g_tr), 0, cudaMemcpyDeviceToDevice, (cudaStream_t)stream);"
     "\n}\n"),
    (re.escape("    __syncthreads();\n    const uint32_t xs = "),
     "    __syncthreads();\n    if (ch == 0) " + _STAMP.format(code=1)
     + "\n    const uint32_t xs = "),
    (re.escape("  // the epilogue: fragment rows g"),
     "  " + _STAMP.format(code=2) + "\n  // the epilogue: fragment rows g"),
    (re.escape("  __syncthreads();                 // the next tile restages"),
     "  __syncthreads();\n  " + _STAMP.format(code=3)
     + "\n  __syncthreads();                 // the next tile restages"),
    (re.escape("  for (int s = s_begin; s < s_end; ++s) {\n    int o, lt;"),
     "  if (blockIdx.x == 0 && threadIdx.x == 0) { g_t0 = clock64(); "
     "g_ev = 0; }\n"
     "  for (int s = s_begin; s < s_end; ++s) {\n    int o, lt;"),
    (re.escape("      __threadfence();\n      cg::this_grid().sync();\n"),
     "      __threadfence();\n      " + _STAMP.format(code=4)
     + "\n      cg::this_grid().sync();\n      " + _STAMP.format(code=5)
     + "\n"),
], [])]
WEIGHTNET_BF16 = [("shipped", [], [])]
C2C_OLD = [
    ("shipped", [], []),
    ("no_staging", [(r"(__device__ void stage\(bf16\* dst, const bf16\* "
                     r"src, int n\) \{)", r"\1\n  return;")], []),
    ("no_fma", [(r"#pragma unroll 4\s*for \(int c = c0; c < c1; \+\+c\)"
                 r"\s*acc = fmaf\(xr\[c\], __bfloat162float\(wr\[c \* F\]\)"
                 r", acc\);",
                 "acc += (float)(c1 - c0) * 1e-3f + xr[c0] * 0.f;")], []),
    ("no_barrier", [(r"__syncthreads\(\);\s*stage\(net\.wsm, net\.w, k \* "
                     r"Cin \* F\);\s*__syncthreads\(\);",
                     "stage(net.wsm, net.w, k * Cin * F);"),
                    (r"if \(S > 1\) \{( *// S is the same for every "
                     r"thread)\s*__syncthreads\(\);", r"if (S > 1) {\1")],
     []),
]
WEIGHTNET_OLD = [
    ("shipped", [], []),
    ("coalesced", [(r"__ldg\(x \+ \(\(\(long long\)n \* A \+ yy\) \* B \+ "
                    r"xx\) \* J \+ j\)",
                    "__ldg(x + ((long long)blockIdx.x * A + yy) * B + xx)")],
     []),
    ("no_compute", [(r"for \(int q = threadIdx\.x; q < Ap \* Bq; q \+= "
                     r"kThreads\) \{",
                     "for (int q = threadIdx.x; q < 0; q += kThreads) {")],
     []),
    ("unrolled", [(r"#pragma unroll 4(\s*for \(int c = 0; c < kC; \+\+c\) "
                   r"\{\s*float m = -INFINITY;)", r"#pragma unroll\1")], []),
]
C2C_NEW = [
    ("shipped", [], []),
    ("no_gemm", [(r"    switch \(key\) \{", "    if (key < 0) switch (key) {")],
     []),
    ("no_weight_copies", [(r"  mbar_expect_tx\(bar, b1 \+ b2 \+ ba \* \(ph\[kProj\] \? 2 "
                           r": 1\)\);", "  mbar_arrive(bar);\n  return;")],
     []),
    ("no_stores", [(r"  \*reinterpret_cast<uint32_t\*>\(sm \+ off\) = v;",
                    "  if (v == 0xdeadbeefu) "
                    "*reinterpret_cast<uint32_t*>(sm + off) = v;")], []),
    ("generic_gemm", [(r"    switch \(key\) \{", "    switch (key + 4096) {")],
     []),
    ("singles512", [(r"constexpr int kThreads = 256,",
                     "constexpr int kThreads = 512,"),
                    (r"constexpr int kItemTiles = 2;",
                     "constexpr int kItemTiles = 1;")], []),
    ("no_zeroing", [(r"reinterpret_cast<uint4\*>\(sm\)\[i\] = "
                     r"make_uint4\(0, 0, 0, 0\);", "")], []),
]
WEIGHTNET_NEW = [
    ("shipped", [], []),
    ("no_compute", [(r"for \(int q = j < jn \? rep : cells; q < cells;",
                     "for (int q = cells; q < cells;")], []),
    ("no_load", [(r"const float4 v = __ldg\(s4 \+ i\);",
                  "const float4 v = make_float4(i, 1.f, 2.f, 3.f);")], []),
    ("affine_each", [(r"          m = fmaxf\(m, a\);\n        \}\n      sum\[c\] \+= "
                      r"fmaxf\(__fadd_rn\(__fmul_rn\(m, sc\[c\]\), sh\[c\]\), "
                      r"0\.f\);",
                      "          m = fmaxf(m, __fadd_rn(__fmul_rn(a, sc[c]), "
                      "sh[c]));\n        }\n      sum[c] += fmaxf(m, 0.f);")],
     []),
    ("two_blocks_per_sm", [(r"__launch_bounds__\(kMaxThreads\)",
                            "__launch_bounds__(kMaxThreads, 2)")], []),
    ("bare", [(r"for \(int q = j < jn \? rep : cells; q < cells;",
               "for (int q = cells; q < cells;"),
              (r"const float4 v = __ldg\(s4 \+ i\);",
               "const float4 v = make_float4(i, 1.f, 2.f, 3.f);")], []),
    ("no_tail", [(r"  __threadfence\(\);\n  __syncthreads\(\);\n  if \(tid == 0\)",
                  "  return;\n  __syncthreads();\n  if (tid == 0)")], []),
    ("group8", [(r"constexpr int kG = 4;", "constexpr int kG = 8;"),
                (r"constexpr int kMaxThreads = 512;",
                 "constexpr int kMaxThreads = 384;")], []),
]
SOFTARGMAX_NEW = [
    ("shipped", [], []),
    ("no_load", [(r"const float4 q = __ldg\(src \+ i\);",
                  "const float4 q = make_float4(i, 0.5f * tid, 0.25f, g);")],
     []),
    ("no_max", [(r"  float m\[16 \* QM\];.*?mb\[j\] = mshared\[j\];",
                 "  float mb[J];\n#pragma unroll\n  for (int j = 0; j < J; "
                 "++j) mb[j] = __fmul_rn(v[j], beta);")], []),
    ("no_exp", [(r"expf\(__fsub_rn\(__fmul_rn\(v\[r \* J \+ j\], beta\), "
                 r"mb\[j\]\)\)",
                 "__fsub_rn(__fmul_rn(v[r * J + j], beta), mb[j])")], []),
    ("no_sum_shuffles", [(r"  warp_reduce_scatter<QS, false>\(acc, lane\);",
                          "")], []),
    ("no_combine", [(r"  __syncthreads\(\);\n  if \(tid == 0\) \{\n    "
                     r"__threadfence\(\);",
                     "  return;\n  __syncthreads();\n  if (tid == 0) {\n"
                     "    __threadfence();")], []),
    ("no_fence", [(r"    __threadfence\(\);\n    last = atomicAdd",
                   "    last = atomicAdd")], []),
    ("empty", [(r"  constexpr int T = kThreads;",
                "  if (beta > 0.f) return;\n  constexpr int T = kThreads;")],
     []),
]
_W = "lane == 0 && blockIdx.x == 0 && (warp == 0 || warp == kWarps - 1)"
C2C_TRACE = [("trace", [
    (re.escape("__device__ void gemm_phase(const int* ph, unsigned char* sm,"),
     "__device__ long long g_st[2][3];\n"
     "__device__ void gemm_phase(const int* ph, unsigned char* sm,"),
    (re.escape("  const float* psc = sc + 2 * fo;\n"),
     "  const float* psc = sc + 2 * fo;\n"
     f"  if ({_W}) g_st[warp ? 1 : 0][0] = clock64();\n"),
    (re.escape("    // epilogue: rows mm[h], columns"),
     f"    if ({_W} && it < kWarps) g_st[warp ? 1 : 0][1] = clock64();\n"
     "    // epilogue: rows mm[h], columns"),
    (re.escape("= p;\n        }\n      }\n    }\n  }\n}\n"),
     "= p;\n        }\n      }\n    }\n  }\n"
     f"  if ({_W}) g_st[warp ? 1 : 0][2] = clock64();\n}}\n"),
    (re.escape("  const int ngemm = nph - 1;\n"),
     "  const int ngemm = nph - 1;\n"
     "  __shared__ long long ts[kMaxPhases * 8];\n"
     "  const long long t_start = clock64();\n"),
    (re.escape("nh, warp, lane);\n    __syncthreads();\n"),
     "nh, warp, lane);\n    __syncthreads();\n"
     "    if (tid == 0) {\n      ts[8 * p + 7] = clock64();\n"
     "      for (int i = 0; i < 6; ++i)\n"
     "        ts[8 * p + i] = ((volatile long long*)g_st)[i];\n    }\n"),
    (re.escape("    out[(long long)(n0 + n) * Z + z] = __fadd_rn(__fmul_rn("
               "acc, a), b);\n  }\n"),
     "    out[(long long)(n0 + n) * Z + z] = __fadd_rn(__fmul_rn(acc, a), "
     "b);\n  }\n  __syncthreads();\n"
     "  if (tid == 0 && blockIdx.x == 0)\n"
     "    for (int i = 0; i < 8 * ngemm && i < N * Z; ++i)\n"
     "      out[i] = (float)(ts[i] - t_start);\n"),
], [])]
SETS = {("person_planes", "old"): PERSON_OLD,
        ("person_planes", "new"): PERSON_NEW,
        ("centernet", "new"): CENTERNET,
        ("centernet_bf16", "new"): CENTERNET_BF16,
        ("centernet_bf16", "trace"): CENTERNET_BF16_TRACE,
        ("weightnet_pool_bf16", "new"): WEIGHTNET_BF16,
        ("c2cnet", "old"): C2C_OLD,
        ("c2cnet", "new"): C2C_NEW,
        ("c2cnet", "trace"): C2C_TRACE,
        ("c2cnet", "flips"): [("old", [], [])],
        ("weightnet_pool", "old"): WEIGHTNET_OLD,
        ("weightnet_pool", "new"): WEIGHTNET_NEW,
        ("soft_argmax", "new"): SOFTARGMAX_NEW}
OUT = Path("build") / "parts"


def variant_source(src: str, subs) -> str:
    for pat, rep in subs:
        src, n = re.subn(pat, lambda m, r=rep: m.expand(r), src, flags=re.S)
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
        for line in out.splitlines():        # the -Xptxas -v report
            if any(w in line for w in ("Compiling entry", "Used",
                                       "spill", "stack frame")):
                print(f"  {name}: {line.strip()}", flush=True)
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


def _smoke_predictor(fuse_p2p: bool = False):
    import torch

    from chip_smoke import MIN_SCORE, blob_heatmaps, random_state_dict
    from fvp_torch.config import FVPConfig
    from fvp_torch.engine.serve import Predictor
    from fvp_torch.geometry.cameras import default_ring_rig
    from fvp_torch.models.faster_voxelpose import FasterVoxelPose

    cfg = FVPConfig(backbone="", min_score=MIN_SCORE, fuse_p2p=fuse_p2p)
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


def _centernet_bf16_inputs():
    """(packed, bev, arena, out): frame 0's BEV map (`--repeat B`: B
    copies, the eval batch's shape) with the smoke's weights, packed for
    the bf16 route, and the launch's buffers."""
    import torch

    from fvp_torch.engine.packing import pack_centernet_bf16
    from fvp_torch.ops.kernels import centernet as kcn
    from fvp_torch.ops.kernels import sampler as ksamp

    pred, hm = _smoke_predictor()
    bev = ksamp.whole_sample_plain(hm, pred.rc, pred.cfg).amax(dim=3) \
        .repeat(OPTIONS.get("repeat") or 1, 1, 1, 1).contiguous()
    pc = pack_centernet_bf16(pred.model.pose_net.center_net)
    plan = kcn.centernet_bf16_plan(*bev.shape)
    arena = torch.empty(plan.arena_elems, dtype=torch.bfloat16,
                        device="cuda")
    out = torch.empty(3 * bev.shape[0] * bev.shape[1] * bev.shape[2],
                      device="cuda")
    return pc, bev, arena, out


def centernet_bf16_call(kind):
    """The bf16 CenterNet launch on frame 0's BEV map with the smoke's
    weights, packed for the bf16 route."""
    from fvp_torch.ops.kernels import centernet as kcn

    pc, bev, arena, out = _centernet_bf16_inputs()

    def make(lib):
        def run():
            _build._lib = lib
            kcn.launch_bf16(pc, bev, arena, out)
        return run
    return make


def centernet_bf16_trace(lib) -> list[dict]:
    """The stamped build's events of block 0, one row per stage: cycles
    from the stage's start (the launch, or past the last barrier) to its
    first tile's staging, and each tile's K sums and epilogue, the wait
    at the barrier and the barrier (`--set trace`)."""
    import torch

    from fvp_torch.ops.kernels import centernet as kcn

    pc, bev, arena, out = _centernet_bf16_inputs()
    _build._lib = lib
    for _ in range(3):
        kcn.launch_bf16(pc, bev, arena, out)
    tr = torch.zeros(512, device="cuda")
    copy = _old_entry(lib, "fvp_trace_copy", [ctypes.c_void_p] * 2)
    copy(tr.data_ptr())
    torch.cuda.synchronize()
    v = tr.tolist()
    events = [(int(v[2 * i]), v[2 * i + 1]) for i in range(len(v) // 2)
              if int(v[2 * i]) in (1, 2, 3, 4, 5)]
    rows, stage, start, tiles = [], 0, 0.0, []
    prev = 0.0
    for code, t in events:
        if code == 1:
            tiles.append({"staged": t - prev})
        elif code == 2:
            tiles[-1]["summed"] = t - prev
        elif code == 3:
            tiles[-1]["epilogue"] = t - prev
        elif code == 4:
            rows.append({"kernel": "centernet_bf16", "set": "trace",
                         "stage": stage, "tiles": tiles,
                         "at_barrier": t - start, "wait_from": prev - start})
        elif code == 5:
            rows[-1]["barrier"] = t - prev
            stage, start, tiles = stage + 1, t, []
        prev = t
        if len(rows) == len(kcn.centernet_bf16_plan(1, 80, 80, 15).stages):
            break
    return rows


def _old_entry(lib, fn, argtypes):
    getattr(lib, fn).argtypes = argtypes
    getattr(lib, fn).restype = ctypes.c_int

    def call(*args):
        err = getattr(lib, fn)(*args, torch_stream())
        if err:
            raise RuntimeError(lib.fvp_error_string(err).decode())
    return call


def torch_stream():
    import torch
    return torch.cuda.current_stream().cuda_stream


def c2cnet_call(kind):
    """A function of the variant's library that runs the earlier C2CNet
    kernel's entry point (or, with `kind` "new", the tree's wrapper) on
    frame 0's z-columns with the smoke's weights."""
    import torch

    pred, hm = _smoke_predictor(fuse_p2p=True)
    pc = pred.packed["c2c_net"]
    cols = pred.model.detect(hm, pred.rc, pred.packed)["columns"] \
        .contiguous()
    N, Z, J = cols.shape
    out = torch.empty((N, Z), device="cuda")
    _p, _i = ctypes.c_void_p, ctypes.c_int
    if kind == "new":
        from fvp_torch.ops.kernels import c2cnet as kc2c

        def make_new(lib):
            def run():
                _build._lib = lib
                kc2c.c2cnet(pc, cols)
            return run
        return make_new

    def make(lib):
        call = _old_entry(lib, "fvp_c2cnet", [_p] * 4 + [_i] * 3 + [_p])
        return lambda: call(cols.data_ptr(), pc["w_flat"].data_ptr(),
                            pc["aff_flat"].data_ptr(), out.data_ptr(), N,
                            Z, J)
    return make


def smoke_features(pred, hm):
    """chip_smoke's K5 input: P2PNet (the cuDNN module) on K2's planes of
    10 people with full cubes, (30, 64, 64, 15)."""
    import numpy as np
    import torch

    from fvp_torch.ops.kernels import sampler as ksamp

    cfg = pred.cfg
    n, J = cfg.ind_voxels_per_axis[0], cfg.num_joints
    prs = np.random.RandomState(1)
    centers = torch.as_tensor(np.stack([
        prs.uniform(-3000, 3000, 10), prs.uniform(-3500, 2500, 10),
        prs.uniform(700, 1100, 10)], axis=1)[None].astype(np.float32),
        device="cuda")
    bbox = torch.ones((1, 10, 2), device="cuda")
    mask = torch.ones((1, 10), dtype=torch.bool, device="cuda")
    planes, _ = ksamp.person_planes(hm, pred.rc, cfg, centers, bbox, mask)
    return pred.model.joint_net.conv_net(
        planes.reshape(3 * 10, n, n, J)).contiguous()


def weightnet_call(kind):
    """A function of the variant's library that runs the earlier
    weightnet_pool entry point (or, with `kind` "new", the tree's wrapper)
    on chip_smoke's K5 input."""
    import torch

    pred, hm = _smoke_predictor()
    feats = smoke_features(pred, hm)
    pw = pred.packed["weight_net"]
    N, A, B, J = feats.shape
    out = torch.empty((N, J, 32), device="cuda")
    _p, _i = ctypes.c_void_p, ctypes.c_int
    if kind == "new":
        from fvp_torch.ops.kernels import weightnet as kwn

        plan = kwn.weightnet_plan(N, A, B, J, OPTIONS.get("rows"))

        def make_new(lib):
            def run():
                _build._lib = lib
                kwn.launch(feats, pw, out, plan)
            return run
        return make_new

    def make(lib):
        call = _old_entry(lib, "fvp_weightnet_pool", [_p] * 5 + [_i] * 5
                          + [_p])
        return lambda: call(feats.data_ptr(), pw["w"].data_ptr(),
                            pw["scale"].data_ptr(), pw["shift"].data_ptr(),
                            out.data_ptr(), N, A, B, J, 32)
    return make


def weightnet_bf16_call(kind):
    """The tree's bf16 pool on chip_smoke's K5 input (repeated
    `--repeat` times), on its plan or on bands of `--rows` rows."""
    import torch

    from fvp_torch.engine.packing import pack_weightnet_bf16
    from fvp_torch.ops.kernels import weightnet as kwn

    pred, hm = _smoke_predictor()
    feats = smoke_features(pred, hm).repeat(OPTIONS.get("repeat") or 1, 1, 1,
                                            1).contiguous()
    pw = pack_weightnet_bf16(pred.model.joint_net.weight_net)
    N, A, B, J = feats.shape
    out = torch.empty((N, J, 32), device="cuda")
    plan = kwn.weightnet_bf16_plan(N, A, B, J, OPTIONS.get("rows"))

    def make(lib):
        def run():
            _build._lib = lib
            kwn.launch_bf16(feats, pw, out, plan)
        return run
    return make


def softargmax_call(kind):
    """A function of the variant's library that runs the tree's soft_argmax
    launch on chip_smoke's K4 input (P2PNet's output of K2's planes, (3,
    10, 4096, 15)), on its plan."""
    import torch

    from fvp_torch.ops.kernels import softargmax as ksa

    pred, hm = _smoke_predictor()
    feats = smoke_features(pred, hm)
    N, A, B, J = feats.shape
    fl = feats.reshape(3, N // 3, A * B, J)
    grid = pred.rc.center_grid
    plan = ksa.softargmax_plan(*fl.shape)
    coords = torch.empty((3, N // 3, J, 2), device="cuda")
    confs = torch.empty((N // 3,), device="cuda")

    def make(lib):
        def run():
            _build._lib = lib
            ksa.launch(fl, grid, pred.cfg.beta, coords, confs, plan)
        return run
    return make


def _card_test_packed(J: int):
    """The card test's C2CNet weights (tests/test_torch_kernels_cuda.py::
    _fuse_model)."""
    from chip_smoke import random_state_dict
    from fvp_torch.config import FVPConfig
    from fvp_torch.engine.packing import pack_model
    from fvp_torch.models.faster_voxelpose import FasterVoxelPose

    cfg = FVPConfig(num_joints=J, num_views=3, heatmap_size=(60, 32),
                    voxels_per_axis=(16, 16, 8), ind_voxels_per_axis=(32,) * 3,
                    max_people=3, backbone="", fuse_p2p=True)
    model = FasterVoxelPose(cfg)
    model.load_state_dict(random_state_dict(model, seed=J))
    return pack_model(model.to("cuda").eval())["c2c_net"]


def c2cnet_trace(lib) -> list[dict]:
    """The stamped build's cycles per phase of CTA 0 (`--set trace`)."""
    import torch

    from fvp_torch.ops.kernels import c2cnet as kc2c

    packed = _card_test_packed(15)
    cols = torch.rand((10, 20, 15), device="cuda",
                      generator=torch.Generator("cuda").manual_seed(0))
    _build._lib = lib
    for _ in range(3):
        out = kc2c.c2cnet(packed, cols)
    torch.cuda.synchronize()
    v = out.reshape(-1).tolist()
    rows = []
    for p in range(len(kc2c.c2cnet_plan(10, 20, 15).phases) - 1):
        s = v[8 * p:8 * p + 8]
        rows.append({"kernel": "c2cnet", "set": "trace", "phase": p,
                     "start": s[0], "w0_gemm": s[1] - s[0],
                     "w0_items": s[2] - s[0], "wlast_gemm": s[4] - s[3],
                     "wlast_items": s[5] - s[3], "end": s[7] - s[0]})
    return rows


FLIP_SHAPES = [(13, 8, 15), (7, 12, 17), (10, 20, 15), (40, 20, 15),
               (3, 96, 15)]


def c2cnet_flips(old, trials: int) -> list[dict]:
    """The tree's kernel and FILE's against the plain version over seeded
    inputs (`--set flips`)."""
    import numpy as np
    import torch

    from fvp_torch.ops.kernels import c2cnet as kc2c

    _p, _i = ctypes.c_void_p, ctypes.c_int
    call = _old_entry(old, "fvp_c2cnet", [_p] * 4 + [_i] * 3 + [_p])
    rows = []
    for N, Z, J in FLIP_SHAPES:
        packed = _card_test_packed(J)
        plans = {"tree": kc2c.c2cnet_plan(N, Z, J),
                 "tree_depth1": kc2c.c2cnet_plan(N, Z, J, 1)}
        errs: dict[str, list[float]] = {}
        for seed in range(trials):
            cols = torch.as_tensor(np.random.RandomState(seed).rand(N, Z, J)
                                   .astype(np.float32), device="cuda")
            ref = kc2c.c2cnet_plain(packed, cols)
            outs = {}
            for k, plan in plans.items():
                outs[k] = torch.empty((N, Z), device="cuda")
                kc2c.launch(packed, cols, outs[k], plan)
            outs["old"] = torch.empty((N, Z), device="cuda")
            call(cols.data_ptr(), packed["w_flat"].data_ptr(),
                 packed["aff_flat"].data_ptr(), outs["old"].data_ptr(), N, Z,
                 J)
            scale = float(ref.abs().max())
            for k, v in outs.items():
                errs.setdefault(k, []).append(
                    float((v - ref).abs().max()) / scale)
        for k, e in errs.items():
            rows.append({"kernel": "c2cnet", "set": "flips",
                         "shape": [N, Z, J], "which": k, "trials": trials,
                         "max_rel_err": max(e),
                         "above_5e-3": sum(x > 5e-3 for x in e),
                         "above_0": sum(x > 0 for x in e)})
    return rows


OPTIONS: dict = {}       # --rows of the pools' plans, --repeat
CALLS = {"person_planes": person_call, "centernet": centernet_call,
         "centernet_bf16": centernet_bf16_call,
         "weightnet_pool_bf16": weightnet_bf16_call,
         "c2cnet": c2cnet_call, "weightnet_pool": weightnet_call,
         "soft_argmax": softargmax_call}


def main() -> int:
    import torch

    from chip_smoke import time_ms

    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", default="person_planes",
                    choices=tuple(CALLS))
    ap.add_argument("--set", default="new",
                    choices=("old", "new", "trace", "flips"))
    ap.add_argument("--source")
    ap.add_argument("--variants", help="comma-separated names (default: "
                    "all of the set)")
    ap.add_argument("--rows", type=int, help="weightnet_pool's band rows")
    ap.add_argument("--repeat", type=int, help="weightnet_pool_bf16's "
                    "input maps, or centernet_bf16's BEV, repeated")
    ap.add_argument("--trials", type=int, default=25, help="flips' inputs")
    args = ap.parse_args()
    OPTIONS.update(rows=args.rows, repeat=args.repeat)
    if not torch.cuda.is_available():
        print("kernel_parts: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    stem = {"weightnet_pool": "weightnet", "weightnet_pool_bf16": "weightnet",
            "soft_argmax": "softargmax"}.get(args.kernel, args.kernel)
    source = Path(args.source or _build.CSRC / f"{stem}.cu")
    variants = SETS[(args.kernel, args.set)]
    if args.variants:
        keep = args.variants.split(",")
        variants = [v for v in variants if v[0] in keep]
    libs = build(source, variants)
    rows = []
    with torch.inference_mode():
        if args.set in ("trace", "flips"):
            lib = load(next(iter(libs.values())))
            if args.set == "flips":
                rows = c2cnet_flips(lib, args.trials)
            elif args.kernel == "centernet_bf16":
                rows = centernet_bf16_trace(lib)
            else:
                rows = c2cnet_trace(lib)
            for r in rows:
                r.update(source=str(source), card=card)
                print(json.dumps(r), flush=True)
        else:
            make = CALLS[args.kernel](args.set)
            for name, path in libs.items():
                ms = time_ms(make(load(path)))
                rows.append({"kernel": args.kernel, "set": args.set,
                             "source": str(source), "variant": name,
                             "ms": ms, "rows": args.rows,
                             "repeat": args.repeat, "card": card})
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
