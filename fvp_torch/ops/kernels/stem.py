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
float32 (scale, shift)}.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fvp_torch.ops.kernels import Kernel, check, ptr

STEM = Kernel("stem", "fvp_stem")


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
    out = torch.empty((N, Hp, Wp, 64), dtype=torch.bfloat16,
                      device=images.device)
    STEM(ptr(images), ptr(w), ptr(aff), ptr(out), N, H, W, Hc, Wc, Hp, Wp)
    return out
