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
three ops on the card, each launch counted on the given Kernel; `PLAIN`
gives the plain versions on any device.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import torch
import torch.nn.functional as F

from fvp_torch.ops.kernels import Kernel, check, ptr

_BF = torch.bfloat16


def conv_kernel(name: str) -> Kernel:
    return Kernel(name, "fvp_conv_bf16")


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


# -- kernel launches ----------------------------------------------------------

_RES_KIND = {None: 0, _BF: 1, torch.float32: 2}


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
    kern(ptr(x), int(x.dtype == _BF), ptr(w), ptr(aff), ptr(res),
         _RES_KIND[None if res is None else res.dtype], ptr(y),
         int(out_dtype == torch.float32), N, H, W, Cin, Fo, k, 0, int(relu))
    return y


def _launch_upconv(kern, x, layer, skip):
    N, H, W, Cin = x.shape
    w, aff = layer["w"], layer["aff"]
    Fo = w.shape[-1]
    check(x, "x", dtype=_BF)
    check(w, "w", (2, 2, Cin, Fo), dtype=_BF, device=x.device)
    check(aff, "aff", (2, Fo), device=x.device)
    check(skip, "skip", (N, 2 * H, 2 * W, Fo), dtype=_BF, device=x.device)
    y = torch.empty((N, 2 * H, 2 * W, Fo), dtype=_BF, device=x.device)
    kern(ptr(x), 1, ptr(w), ptr(aff), ptr(skip), 1, ptr(y), 0, N, H, W,
         Cin, Fo, 1, 1, 1)
    return y


def _launch_pool(kern, x):
    N, H, W, C = x.shape
    check(x, "x", dtype=_BF)
    if H % 2 or W % 2:
        raise ValueError(f"pool_bf16: odd map {H}x{W}")
    y = torch.empty((N, H // 2, W // 2, C), dtype=_BF, device=x.device)
    kern(ptr(x), ptr(y), N, H, W, C)
    return y


def make_ops(conv_k: Kernel, pool_k: Kernel | None = None) -> SimpleNamespace:
    """The three ops on CUDA tensors, launching the kernels and counting
    each launch on `conv_k` (convs and up-convs) or `pool_k` (pools)."""
    return SimpleNamespace(
        conv=lambda x, layer, res=None, relu=False, out_dtype=_BF:
            _launch_conv(conv_k, x, layer, res, relu, out_dtype),
        upconv=lambda x, layer, skip: _launch_upconv(conv_k, x, layer, skip),
        pool=lambda x: _launch_pool(pool_k, x))
