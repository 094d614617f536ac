"""Wrapper of the backbone's deconv-head kernel (csrc/deconv_head.cu), with
its plain version.

One stage is ConvTranspose2d(k=4, s=2, p=1, no bias) + the folded BN affine
+ ReLU: (V, H, W, Cin) -> (V, 2H, 2W, F), NHWC. Numerics follow the TPU
kernels it replaces (fvp_tpu/ops/pallas/deconv_head.py::deconv_stage_rows
and ::deconv_stage_chunked): input and weights rounded to bf16, products
summed in float32, the affine and ReLU on the float32 sum, the output
rounded to bf16. A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises.

`packed` (engine/packing.py::pack_backbone) holds per stage
{"w": (4, 4, Cin, F) bf16, "aff": (2, F) float32}: w[2r+s, 2u+v] is the
(Cin, F) matrix of tap (u, v) for the output parity class (r, s). Output
y[oy, ox] with r = (oy+1) % 2, i' = (oy+1) // 2 (likewise s, j' for x) is

    sum_{u,v} x[i'+u-1, j'+v-1, :] @ w[2r+s, 2u+v],   zero outside x,
    w[2r+s, 2u+v] = weight[:, :, 2-2u+r, 2-2v+s]   (torch's (Cin, F, 4, 4)).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fvp_torch.ops.kernels import Kernel, check, ptr

DECONV = Kernel("deconv_stage", "fvp_deconv_stage")

# the kernel tiles F by 128 columns and the reduction by 32
_TILE_F, _TILE_K = 128, 32


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
    output, first stage) or bf16 (the stages after it)."""
    if not x.is_cuda:
        return deconv_stage_plain(x, packed)
    V, H, W, C = x.shape
    w, aff = packed["w"], packed["aff"]
    Fo = w.shape[-1]
    if C % _TILE_K or Fo % _TILE_F:
        raise ValueError(f"deconv_stage: takes Cin % {_TILE_K} == 0 and "
                         f"F % {_TILE_F} == 0, got Cin={C}, F={Fo}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"deconv_stage: dtype {x.dtype}, expected float32 "
                         "or bfloat16")
    check(x, "x", dtype=x.dtype)
    check(w, "w", (4, 4, C, Fo), dtype=torch.bfloat16, device=x.device)
    check(aff, "aff", (2, Fo), device=x.device)
    y = torch.empty((V, 2 * H, 2 * W, Fo), dtype=torch.bfloat16,
                    device=x.device)
    DECONV(ptr(x), ptr(w), ptr(aff), ptr(y), int(x.dtype == torch.bfloat16),
           V, H, W, C, Fo)
    return y


def deconv_head(x: torch.Tensor, stages: list) -> torch.Tensor:
    """The backbone's head: every stage in turn, one launch each.
    (V, H, W, Cin) -> (V, 8H, 8W, F) bf16 for three stages."""
    for packed in stages:
        x = deconv_stage(x, packed)
    return x
