"""Wrapper of the backbone's deconv-head kernel (csrc/deconv_head.cu), with
its plain version.

One stage is ConvTranspose2d(k=4, s=2, p=1, no bias) + the folded BN affine
+ ReLU: (V, H, W, Cin) -> (V, 2H, 2W, F), NHWC. Numerics follow the TPU
kernels it replaces (fvp_tpu/ops/pallas/deconv_head.py::deconv_stage_rows
and ::deconv_stage_chunked): input and weights rounded to bf16, products
summed in float32, the affine and ReLU on the float32 sum, the output
rounded to bf16. A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises. `deconv_plan` and the functions beside it
are the kernel's tiling, in Python so that the CPU tests can check it.

`packed` (engine/packing.py::pack_backbone) holds per stage
{"w": (4, 4, Cin, F) bf16, "aff": (2, F) float32}: w[2r+s, 2u+v] is the
(Cin, F) matrix of tap (u, v) for the output parity class (r, s). Output
y[oy, ox] with r = (oy+1) % 2, i' = (oy+1) // 2 (likewise s, j' for x) is

    sum_{u,v} x[i'+u-1, j'+v-1, :] @ w[2r+s, 2u+v],   zero outside x,
    w[2r+s, 2u+v] = weight[:, :, 2-2u+r, 2-2v+s]   (torch's (Cin, F, 4, 4)).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from fvp_torch.ops.kernels import Kernel, check, ptr, sm_count

DECONV = Kernel("deconv_stage", "fvp_deconv_stage")

# the kernel's tile: 128 source pixels (a th x tw patch) by 128 or 256
# output channels, K in boxes of 64 input channels of one tap
TILE_M, TILE_F, TILE_K = 128, 128, 64
H100_SMS = 132
MAX_SPLITS = 4


class DeconvPlan(NamedTuple):
    """How the kernel tiles one stage: per parity class, a grid of th x tw
    source patches (tiles_h x tiles_w per view) by `bn` output channels,
    each cut along K across `splits` CTAs of one cluster. `items` work
    items (tile x rank) in all, run by `ctas` CTAs: one per item where K
    is split, else at most one per SM, each walking its items in turn."""
    th: int
    tw: int
    tiles_h: int
    tiles_w: int
    bn: int
    splits: int
    items: int
    ctas: int


def deconv_plan(V: int, H: int, W: int, Cin: int, Fo: int,
                sms: int = H100_SMS) -> DeconvPlan:
    """The kernel's tiling of a (V, H, W, Cin) -> (V, 2H, 2W, Fo) stage.
    The patch is tw = 8..32 pixels wide (the smallest power of two >= W,
    at most 32) and 128 / tw high; the N tile is 256 channels where F
    allows it, else 128. K is split (2 or 4 ways) until the CTAs fill the
    card's SMs twice over, or K runs out of 64-channel blocks."""
    tw = min(32, max(8, 1 << (W - 1).bit_length()))
    th = TILE_M // tw
    tiles_h, tiles_w = -(-H // th), -(-W // tw)
    bn = 2 * TILE_F if Fo % (2 * TILE_F) == 0 else TILE_F
    mtiles = V * tiles_h * tiles_w
    per_mtile = 4 * (Fo // bn)
    splits = 1
    while (mtiles * per_mtile * splits < 2 * sms
           and 2 * splits <= MAX_SPLITS and 2 * splits <= 4 * Cin // TILE_K):
        splits *= 2
    items = mtiles * per_mtile * splits
    ctas = items if splits > 1 else min(items, sms)
    return DeconvPlan(th, tw, tiles_h, tiles_w, bn, splits, items, ctas)


def k_split(Cin: int, splits: int) -> list[tuple[int, int]]:
    """[begin, end) of each cluster rank's 64-channel K blocks; block kb is
    tap kb // (Cin // 64), channels 64 * (kb % (Cin // 64)) onwards."""
    kb = 4 * Cin // TILE_K
    return [(q * kb // splits, (q + 1) * kb // splits) for q in range(splits)]


def patch_origin(plan: DeconvPlan, mt: int) -> tuple[int, int, int]:
    """(view, h0, w0) of M tile `mt`: its patch's top-left source pixel."""
    per_view = plan.tiles_h * plan.tiles_w
    rem = mt % per_view
    return mt // per_view, rem // plan.tiles_w * plan.th, \
        rem % plan.tiles_w * plan.tw


def tap_box(r: int, s: int, u: int, v: int, h0: int, w0: int
            ) -> tuple[int, int]:
    """(h, w) of the input box that tap (u, v) of parity (r, s) loads for
    the patch at (h0, w0): source pixel (hi, wi) reads x[hi+u-r, wi+v-s]
    (zero outside x) with weight w[2r+s, 2u+v]."""
    return h0 + u - r, w0 + v - s


def out_pixel(r: int, s: int, hi: int, wi: int) -> tuple[int, int]:
    """The output pixel (oy, ox) that source pixel (hi, wi) of parity
    (r, s) writes."""
    return 2 * hi + 1 - r, 2 * wi + 1 - s


def pack_deconv_weight(weight: torch.Tensor) -> torch.Tensor:
    """torch ConvTranspose2d weight (Cin, F, 4, 4) -> (4 parities, 4 taps,
    Cin, F) bf16 (the layout above)."""
    wk = weight.detach().permute(2, 3, 0, 1)            # (ky, kx, C, F)
    idx = torch.tensor([[2, 0], [3, 1]], device=weight.device)  # [r, u]
    w6 = wk[idx][:, :, idx]                             # (r, u, s, v, C, F)
    w6 = w6.permute(0, 2, 1, 3, 4, 5)                   # (r, s, u, v, C, F)
    return w6.reshape(4, 4, *wk.shape[2:]).to(torch.bfloat16).contiguous()


def unpack_deconv_weight(w: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_deconv_weight, as float32 (Cin, F, 4, 4)."""
    C, Fo = w.shape[2:]
    w6 = w.float().reshape(2, 2, 2, 2, C, Fo)           # (r, s, u, v, C, F)
    w6 = w6.permute(2, 0, 3, 1, 4, 5).flip(0, 2)        # (1-u, r, 1-v, s)
    return w6.reshape(4, 4, C, Fo).permute(2, 3, 0, 1)  # ky = 2(1-u) + r


def deconv_stage_plain(x: torch.Tensor, packed: dict) -> torch.Tensor:
    """(V, H, W, Cin) float32 or bf16 -> (V, 2H, 2W, F) bf16, on any
    device."""
    xb = x.to(torch.bfloat16).float().permute(0, 3, 1, 2)
    y = F.conv_transpose2d(xb, unpack_deconv_weight(packed["w"]), stride=2,
                           padding=1)
    a, b = packed["aff"][0], packed["aff"][1]
    y = torch.relu(y * a[:, None, None] + b[:, None, None])
    return y.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous()


def deconv_stage(x: torch.Tensor, packed: dict) -> torch.Tensor:
    """One deconv stage (see the module docstring). x: float32 (the trunk's
    output, first stage) or bf16 (the stages after it). On the card a
    float32 x is rounded to bf16 once (to nearest even, as the plain
    version rounds it), since the kernel's TMA loads copy bytes."""
    if not x.is_cuda:
        return deconv_stage_plain(x, packed)
    V, H, W, C = x.shape
    w, aff = packed["w"], packed["aff"]
    Fo = w.shape[-1]
    if C % TILE_K or Fo % TILE_F:
        raise ValueError(f"deconv_stage: takes Cin % {TILE_K} == 0 and "
                         f"F % {TILE_F} == 0, got Cin={C}, F={Fo}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"deconv_stage: dtype {x.dtype}, expected float32 "
                         "or bfloat16")
    check(x, "x", dtype=x.dtype)
    check(w, "w", (4, 4, C, Fo), dtype=torch.bfloat16, device=x.device)
    check(aff, "aff", (2, Fo), device=x.device)
    xb = x.to(torch.bfloat16)
    if xb.data_ptr() % 16 or w.data_ptr() % 16 or aff.data_ptr() % 16:
        raise ValueError("deconv_stage: x, w and aff must be 16-byte "
                         "aligned")
    plan = deconv_plan(V, H, W, C, Fo, sm_count(x.device))
    y = torch.empty((V, 2 * H, 2 * W, Fo), dtype=torch.bfloat16,
                    device=x.device)
    DECONV(ptr(xb), ptr(w), ptr(aff), ptr(y), V, H, W, C, Fo, plan.th,
           plan.tw, plan.splits, plan.bn, plan.ctas)
    return y


def deconv_head(x: torch.Tensor, stages: list) -> torch.Tensor:
    """The backbone's head: every stage in turn, one launch each.
    (V, H, W, Cin) -> (V, 8H, 8W, F) bf16 for three stages."""
    for packed in stages:
        x = deconv_stage(x, packed)
    return x
