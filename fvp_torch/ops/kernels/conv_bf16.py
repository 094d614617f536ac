"""Wrappers of the bf16 tensor-core conv kernels (csrc/conv_bf16.cu), with
their plain versions. P2PNet (`ops/kernels/hourglass.py`) and the
bottleneck stage (`ops/kernels/trunk.py`) are built from these ops.

Three ops on NHWC maps (the plain versions also on C2CNet's (N, Z, C)
columns). Operands are bf16, products sum in float32, and the result
rounds to bf16 where the TPU kernels they replace round
(fvp_tpu/ops/pallas/hourglass.py::_conv3, ::_resblock, ::_upsample and
fvp_tpu/ops/pallas/trunk.py::_stage_kernel):

- `conv(x, layer, res, relu, out_dtype)`: a k x k SAME stride-1 conv,
  y = aff(conv(x)) [+ res] [ReLU], rounded to `out_dtype` (bf16, or float32
  for a projection skip or an output layer). A float32 x rounds to bf16 as
  it is read; `res` is added in float32 (bf16 or float32).
- `upconv(x, layer, skip)`: the 2x2 stride-2 transposed conv,
  bf16(bf16(ReLU(aff(.))) + skip), y[2i+r, 2j+s] = x[i, j] @ w[r, s].
- `pool(x)`: the 2x2 stride-2 max pool of a bf16 map.

`layer` (engine/packing.py) is {"w": (k*k, Cin, F) bf16, taps in row-major
(dy, dx) order, or (2, 2, Cin, F) bf16 for an up-conv; "aff": (2, F)
float32 (scale, shift)}. `make_ops(conv_kernel, pool_kernel)` gives the
three ops on the card, each launch counted on the given kernels; `PLAIN`
gives the plain versions on any device.

A conv or up-conv launches one of two kernels, chosen by its shape alone
(`conv_plan`): `conv_wgmma` (TMA + wgmma, persistent) where its input has
16, 32 or a multiple of 64 channels and N (F, or 4 F for an up-conv) is a
power of two from 16 to 256; `conv_bf16_kernel` (wmma) for the rest.
`conv_plan` and the functions beside it are the tiling, in Python so that
the CPU tests can check it.
"""

from __future__ import annotations

import functools
import math
from types import SimpleNamespace
from typing import NamedTuple

import torch
import torch.nn.functional as F

from fvp_torch.ops.kernels import Kernel, check, ptr, sm_count

_BF = torch.bfloat16

TILE_M = 128             # GEMM rows (output pixels) of a tile, both kernels
H100_SMS = 132
MAX_SMEM = 232448        # dynamic shared memory one block may use
MAX_STAGES = 8
WGMMA_N = (16, 32, 64, 128, 256)


class ConvKernels:
    """The two kernels behind one net's convs, each counting its own
    launches: `wgmma` (fvp_conv_wgmma) and `wmma` (fvp_conv_bf16)."""

    def __init__(self, name: str):
        self.wgmma = Kernel(f"{name}.wgmma", "fvp_conv_wgmma")
        self.wmma = Kernel(f"{name}.wmma", "fvp_conv_bf16")

    @property
    def launches(self) -> int:
        return self.wgmma.launches + self.wmma.launches


def conv_kernel(name: str) -> ConvKernels:
    return ConvKernels(name)


def pool_kernel(name: str) -> Kernel:
    return Kernel(name, "fvp_maxpool2_bf16")


# -- plain versions (NHWC or NZC maps: 2D or 1D) ------------------------------

def _cf(x):
    """channels-last -> channels-first view"""
    return x.movedim(-1, 1)


def conv_plain(x, layer, res=None, relu=False, out_dtype=_BF):
    w = layer["w"]
    T, Cin, Fo = w.shape
    if x.dim() == 4:
        k = math.isqrt(T)
        wt = w.float().reshape(k, k, Cin, Fo).permute(3, 2, 0, 1)
        y = F.conv2d(_cf(x.to(_BF).float()), wt, padding=k // 2)
    else:
        y = F.conv1d(_cf(x.to(_BF).float()), w.float().permute(2, 1, 0),
                     padding=T // 2)
    y = y.movedim(1, -1) * layer["aff"][0] + layer["aff"][1]
    if res is not None:
        y = y + res.float()
    if relu:
        y = torch.relu(y)
    return y.to(out_dtype).contiguous()


def upconv_plain(x, layer, skip):
    wt = layer["w"].float().movedim(-2, 0).movedim(-1, 1)   # (Cin, F, 2...)
    convt = F.conv_transpose2d if x.dim() == 4 else F.conv_transpose1d
    y = convt(_cf(x.float()), wt, stride=2).movedim(1, -1)
    y = torch.relu(y * layer["aff"][0] + layer["aff"][1]).to(_BF)
    return (y.float() + skip.float()).to(_BF).contiguous()


def pool_plain(x):
    pool = F.max_pool2d if x.dim() == 4 else F.max_pool1d
    return pool(_cf(x.float()), 2, 2).movedim(1, -1).to(_BF).contiguous()


PLAIN = SimpleNamespace(conv=conv_plain, upconv=upconv_plain,
                        pool=pool_plain)


# -- the tiling ---------------------------------------------------------------

class ConvPlan(NamedTuple):
    """How a conv is tiled. route "wgmma": th x tw patches of one image
    (tiles_h x tiles_w per image, `mtiles` in all) by all `bn` = N columns;
    K in blocks of one column dx of the k x k taps by `bk` channels, whose
    A box is the patch with k - 1 more rows (`swizzle_a` bytes wide) and
    whose B is k taps of boxes of `bw` columns (`swizzle_b` bytes wide); a
    ring of `stages`, `ctas` persistent CTAs, K not split (`splits` 1).
    route "wmma" (`conv_bf16_kernel`): `mtiles` flat tiles of 128 pixels
    (th = 1, tw = 128) by `bn` columns, K in steps of 32 double-buffered,
    one CTA per tile."""
    route: str
    th: int
    tw: int
    tiles_h: int
    tiles_w: int
    bk: int
    swizzle_a: int
    bw: int
    swizzle_b: int
    bn: int
    stages: int
    splits: int
    mtiles: int
    ctas: int


def _kb(n: int) -> int:
    return -(-n // 1024) * 1024


def stage_bytes(bk: int, bn: int, k: int, th: int, tw: int) -> int:
    """One ring stage of conv_wgmma: the A box ((th + k - 1) x tw pixels
    of bk channels) and the B boxes of a column's k taps, each rounded up
    to the 1 KB of a swizzle atom."""
    return _kb(_kb((th + k - 1) * tw * bk * 2) + k * bk * bn * 2)


def smem_bytes(bk: int, bn: int, stages: int, k: int, th: int,
               tw: int) -> int:
    """conv_wgmma's dynamic shared memory: 1 KB of alignment, the ring, the
    staged output tile (rows of 2 bn + 16 bytes), the affine per column and
    the ring's mbarriers."""
    return (1024 + stages * stage_bytes(bk, bn, k, th, tw)
            + TILE_M * (2 * bn + 16) + 2 * bn * 4 + 2 * stages * 8)


def _stages(bk: int, bn: int, k: int, th: int, tw: int) -> int:
    stages = MAX_STAGES
    while stages > 1 and smem_bytes(bk, bn, stages, k, th, tw) > MAX_SMEM:
        stages -= 1
    return stages


@functools.lru_cache(maxsize=None)
def conv_plan(N: int, H: int, W: int, Cin: int, Fo: int, k: int, mode: int,
              sms: int = H100_SMS) -> ConvPlan:
    """The route and tiling of a k x k SAME conv (mode 0) or a 2x2
    stride-2 up-conv (mode 1, k = 1) of an (N, H, W, Cin) map to Fo
    channels. conv_wgmma takes it where bk = min(Cin, 64) and bw = min(Fo,
    64) are 16, 32 or 64 and divide Cin and Fo (TMA boxes of 32, 64 or 128
    bytes) and N is a power of two from 16 to 256 (one wgmma N tile); its
    patch is 8 x 16 pixels (16 x 8 where W <= 8), its ring as deep as
    shared memory allows (at most 8; bk 32 where two 64-channel stages do
    not fit), one CTA per SM where the tiles outnumber the SMs, else one
    per tile."""
    ncols = 4 * Fo if mode else Fo
    bk, bw = min(Cin, 64), min(Fo, 64)
    if (bk in (16, 32, 64) and Cin % bk == 0 and bw in (16, 32, 64)
            and Fo % bw == 0 and ncols in WGMMA_N):
        tw = 16 if W > 8 else 8
        th = TILE_M // tw
        tiles_h, tiles_w = -(-H // th), -(-W // tw)
        stages = _stages(bk, ncols, k, th, tw)
        if stages < 2:                  # the ring needs two stages
            bk = 32
            stages = _stages(bk, ncols, k, th, tw)
        mtiles = N * tiles_h * tiles_w
        return ConvPlan("wgmma", th, tw, tiles_h, tiles_w, bk, 2 * bk, bw,
                        2 * bw, ncols, stages, 1, mtiles, min(mtiles, sms))
    bn = next(b for b in (16, 32, 64, 128) if ncols <= b or b == 128)
    mtiles = -(-N * H * W // TILE_M)
    return ConvPlan("wmma", 1, TILE_M, mtiles, 1, 32, 0, bn, 0, bn, 2, 1,
                    mtiles, mtiles * -(-ncols // bn))


def patch_origin(plan: ConvPlan, mt: int) -> tuple[int, int, int]:
    """(image, h0, w0) of conv_wgmma's M tile `mt`."""
    per_img = plan.tiles_h * plan.tiles_w
    rem = mt % per_img
    return mt // per_img, rem // plan.tiles_w * plan.th, \
        rem % plan.tiles_w * plan.tw


def k_blocks(Cin: int, k: int, plan: ConvPlan) -> list[tuple[int, int, int]]:
    """conv_wgmma's products in the order it takes them: (dy, dx, c0) of
    tap (dy, dx), channels c0 .. c0 + bk. A ring stage holds one column dx
    and channel block c0, its taps dy in turn."""
    return [(dy, dx, c0) for dx in range(k) for c0 in range(0, Cin, plan.bk)
            for dy in range(k)]


def b_boxes(Fo: int, plan: ConvPlan) -> list[tuple[int, int]]:
    """(parity, first channel) of each bw-column box of a K block's B: a
    conv's N is its F channels (parity 0), an up-conv's the four parities'
    F channels side by side."""
    return [(c // Fo, c % Fo) for c in range(0, plan.bn, plan.bw)]


# -- kernel launches ----------------------------------------------------------

_RES_KIND = {None: 0, _BF: 1, torch.float32: 2}


def _aligned(*ts) -> None:
    if any(t is not None and t.data_ptr() % 16 for t in ts):
        raise ValueError("conv_bf16: x, w, res and y must be 16-byte aligned")


def _launch(kern, x, w, aff, res, y, Cin, Fo, k, mode, relu):
    """Launch the plan's kernel: x (N, H, W, Cin), y the output."""
    N, H, W, _ = x.shape
    rk = _RES_KIND[None if res is None else res.dtype]
    yf = int(y.dtype == torch.float32)
    plan = conv_plan(N, H, W, Cin, Fo, k, mode, sm_count(x.device))
    if plan.route == "wgmma":
        # TMA copies bytes: a float32 x is rounded to bf16 once, to nearest
        # even, as the wmma kernel rounds it while it reads
        xb = x if x.dtype == _BF else x.to(_BF)
        _aligned(xb, w, res, y)
        kern.wgmma(ptr(xb), ptr(w), ptr(aff), ptr(res), rk, ptr(y), yf, N, H,
                   W, Cin, Fo, k, mode, int(relu), plan.th, plan.tw, plan.bk,
                   plan.bw, plan.stages, plan.ctas)
    else:
        kern.wmma(ptr(x), int(x.dtype == _BF), ptr(w), ptr(aff), ptr(res),
                  rk, ptr(y), yf, N, H, W, Cin, Fo, k, mode, int(relu))
    return y


def _launch_conv(kern, x, layer, res, relu, out_dtype):
    N, H, W, Cin = x.shape
    w, aff = layer["w"], layer["aff"]
    T, _, Fo = w.shape
    k = math.isqrt(T)
    if k * k != T or k % 2 == 0:
        raise ValueError(f"conv_bf16: {T} taps is not an odd square")
    if x.dtype not in (torch.float32, _BF):
        raise ValueError(f"conv_bf16: dtype {x.dtype}, expected float32 or "
                         "bfloat16")
    if out_dtype not in (torch.float32, _BF):
        raise ValueError(f"conv_bf16: output dtype {out_dtype}")
    check(x, "x", dtype=x.dtype)
    check(w, "w", (T, Cin, Fo), dtype=_BF, device=x.device)
    check(aff, "aff", (2, Fo), device=x.device)
    if res is not None:
        if res.dtype not in (torch.float32, _BF):
            raise ValueError(f"conv_bf16: residual dtype {res.dtype}")
        check(res, "res", (N, H, W, Fo), dtype=res.dtype, device=x.device)
    y = torch.empty((N, H, W, Fo), dtype=out_dtype, device=x.device)
    return _launch(kern, x, w, aff, res, y, Cin, Fo, k, 0, relu)


def _launch_upconv(kern, x, layer, skip):
    N, H, W, Cin = x.shape
    w, aff = layer["w"], layer["aff"]
    Fo = w.shape[-1]
    check(x, "x", dtype=_BF)
    check(w, "w", (2, 2, Cin, Fo), dtype=_BF, device=x.device)
    check(aff, "aff", (2, Fo), device=x.device)
    check(skip, "skip", (N, 2 * H, 2 * W, Fo), dtype=_BF, device=x.device)
    y = torch.empty((N, 2 * H, 2 * W, Fo), dtype=_BF, device=x.device)
    return _launch(kern, x, w, aff, skip, y, Cin, Fo, 1, 1, True)


def _launch_pool(kern, x):
    N, H, W, C = x.shape
    check(x, "x", dtype=_BF)
    if H % 2 or W % 2:
        raise ValueError(f"pool_bf16: odd map {H}x{W}")
    y = torch.empty((N, H // 2, W // 2, C), dtype=_BF, device=x.device)
    kern(ptr(x), ptr(y), N, H, W, C)
    return y


def make_ops(conv_k: ConvKernels, pool_k: Kernel | None = None
             ) -> SimpleNamespace:
    """The three ops on CUDA tensors, launching the kernels and counting
    each launch on `conv_k` (convs and up-convs, on the route's kernel) or
    `pool_k` (pools)."""
    return SimpleNamespace(
        conv=lambda x, layer, res=None, relu=False, out_dtype=_BF:
            _launch_conv(conv_k, x, layer, res, relu, out_dtype),
        upconv=lambda x, layer, skip: _launch_upconv(conv_k, x, layer, skip),
        pool=lambda x: _launch_pool(pool_k, x))
