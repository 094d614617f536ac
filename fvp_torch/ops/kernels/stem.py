"""Wrapper of the backbone stem kernel (csrc/stem.cu), with its plain
version.

The stem is conv1 (7x7, stride 2, padding 3, 3 -> 64 channels) + the folded
bn1 affine + ReLU + the 3x3 / stride-2 / padding-1 max pool, on an NHWC
float32 image. Numerics follow the TPU kernel it replaces
(fvp_tpu/ops/pallas/stem.py::pallas_stem): image and weights rounded to
bf16, products summed in float32, the affine and ReLU on the float32 sum,
the pooled map rounded to bf16. A CPU tensor takes the plain version; a
CUDA tensor launches the kernel or raises. `packed` comes from
engine/packing.py::pack_backbone: {"w": (7, 7, 3, 64) bf16, "aff": (2, 64)
float32 (scale, shift)}. `stem_plan` and the functions beside it are the
kernel's tiling, in Python so that the CPU tests can check it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from fvp_torch.ops.kernels import Kernel, check, ptr, sm_count

STEM = Kernel("stem", "fvp_stem")

# the kernel's tiling (csrc/stem.cu): pooled tiles of 8 x 16 outputs, the
# 17 x 33 conv tile their pool windows cover, K per ky padded from 21 (kx, c)
# values to 24 and in all from 7 x 24 to 11 k16 steps
POOL_TILE = (8, 16)
K_PER_KY = 24
K_PAD = 176
CTAS_PER_SM = 2
H100_SMS = 132


class StemPlan(NamedTuple):
    """Pooled tiles of tph x tpw outputs (tiles_h x tiles_w per image,
    `tiles` in all), each computing a conv_h x conv_w conv tile, K padded
    to k_pad (k_per_ky per kernel row), run by `ctas` persistent CTAs."""
    tph: int
    tpw: int
    conv_h: int
    conv_w: int
    k_per_ky: int
    k_pad: int
    tiles_h: int
    tiles_w: int
    tiles: int
    ctas: int


@functools.lru_cache(maxsize=None)
def stem_plan(N: int, H: int, W: int, sms: int = H100_SMS) -> StemPlan:
    """The kernel's tiling of an (N, H, W, 3) image batch: two persistent
    CTAs per SM (or one per tile) walk the pooled tiles."""
    tph, tpw = POOL_TILE
    Hp, Wp = out_size(H)[1], out_size(W)[1]
    tiles_h, tiles_w = -(-Hp // tph), -(-Wp // tpw)
    tiles = N * tiles_h * tiles_w
    return StemPlan(tph, tpw, 2 * tph + 1, 2 * tpw + 1, K_PER_KY, K_PAD,
                    tiles_h, tiles_w, tiles, min(tiles, CTAS_PER_SM * sms))


def tile_origin(plan: StemPlan, tile: int) -> tuple[int, int, int]:
    """(image, py0, px0) of pooled tile `tile`; its conv tile starts at
    conv (2 py0 - 1, 2 px0 - 1) and reads the input from (4 py0 - 5,
    4 px0 - 5)."""
    per_img = plan.tiles_h * plan.tiles_w
    rem = tile % per_img
    return tile // per_img, rem // plan.tiles_w * plan.tph, \
        rem % plan.tiles_w * plan.tpw


def padded_weight(w: torch.Tensor, plan: StemPlan) -> torch.Tensor:
    """(7, 7, 3, 64) -> the kernel's (k_pad, 64) B operand: row 24 ky + j
    is w[ky, j // 3, j % 3] for j < 21, zero otherwise."""
    kw = w.reshape(7, 21, w.shape[-1])
    out = torch.zeros((plan.k_pad // plan.k_per_ky + 1, plan.k_per_ky,
                       w.shape[-1]), dtype=w.dtype, device=w.device)
    out[:7, :21] = kw
    return out.reshape(-1, w.shape[-1])[:plan.k_pad]


def out_size(n: int) -> tuple[int, int]:
    """Image side -> (conv side, pooled side) of the stem."""
    conv = (n - 1) // 2 + 1
    return conv, (conv - 1) // 2 + 1


def stem_plain(images: torch.Tensor, packed: dict) -> torch.Tensor:
    """(N, H, W, 3) float32 -> (N, H/4, W/4, 64) bf16, on any device."""
    x = images.to(torch.bfloat16).float().permute(0, 3, 1, 2)
    w = packed["w"].float().permute(3, 2, 0, 1)            # (64, 3, 7, 7)
    h = F.conv2d(x, w, stride=2, padding=3)
    a, b = packed["aff"][0], packed["aff"][1]
    h = torch.relu(h * a[:, None, None] + b[:, None, None])
    h = F.max_pool2d(h, 3, stride=2, padding=1)
    return h.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous()


def stem(images: torch.Tensor, packed: dict) -> torch.Tensor:
    """The backbone stem: (N, H, W, 3) normalized float32 images ->
    (N, Hp, Wp, 64) bf16 pooled features."""
    if not images.is_cuda:
        return stem_plain(images, packed)
    N, H, W, C = images.shape
    w, aff = packed["w"], packed["aff"]
    if C != 3 or tuple(w.shape) != (7, 7, 3, 64):
        raise ValueError(f"stem: takes 3-channel images and a (7, 7, 3, 64) "
                         f"kernel, got {tuple(images.shape)}, "
                         f"{tuple(w.shape)}")
    check(images, "images")
    check(w, "w", dtype=torch.bfloat16, device=images.device)
    check(aff, "aff", (2, 64), device=images.device)
    Hc, Hp = out_size(H)
    Wc, Wp = out_size(W)
    plan = stem_plan(N, H, W, sm_count(images.device))
    out = torch.empty((N, Hp, Wp, 64), dtype=torch.bfloat16,
                      device=images.device)
    STEM(ptr(images), ptr(w), ptr(aff), ptr(out), N, H, W, Hc, Wc, Hp, Wp,
         plan.tph, plan.tpw, plan.ctas)
    return out
