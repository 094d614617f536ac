"""Operations and bytes: the arithmetic every family counts with.

`layer_work` counts each conv and linear layer of a net run on meta
tensors (1D, 2D and 3D convolutions, plain and transposed), so a family's
`model_flops` is the model's work on one frame (2 per multiply-add),
whatever implements it. A family's `kernel_bounds` is the least time of
each hand-written kernel's launches in one batch at the published peaks
of one H100 SXM (NVIDIA's data sheet, dense): the larger of its bytes
(each input byte read once, each output byte written once) over 3.35
TB/s and its operations over 989 TFLOP/s (bf16 on the tensor cores) or
67 TFLOP/s (float32), by `bound_ms`.
"""

from __future__ import annotations

import torch
from torch import nn

PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAKS = {"float32": PEAK_FP32, "bfloat16": PEAK_BF16}


LAYERS = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.ConvTranspose1d,
          nn.ConvTranspose2d, nn.ConvTranspose3d)


def layer_work(net: nn.Module, *shapes) -> list:
    """[(kind, macs, out_elems, weight_elems)] of every conv and linear
    layer of `net` run on meta tensors of `shapes`, in call order."""
    rows = []

    def hook(m, inp, out):
        x = inp[0]
        w = m.weight
        if isinstance(m, nn.Linear):
            macs = out.numel() * w.shape[1]
        elif isinstance(m, (nn.ConvTranspose1d, nn.ConvTranspose2d,
                            nn.ConvTranspose3d)):
            macs = x.numel() * w[0].numel()
        else:
            macs = out.numel() * w[0].numel()
        rows.append((type(m).__name__, macs, out.numel(), w.numel()))

    with torch.device("meta"):
        net = net.to("meta").eval()
        handles = [m.register_forward_hook(hook) for m in net.modules()
                   if isinstance(m, LAYERS)]
        with torch.no_grad():
            net(*(torch.empty(s) for s in shapes))
        for h in handles:
            h.remove()
    return rows


def flops(rows) -> float:
    return 2.0 * sum(r[1] for r in rows)


def bound_ms(nbytes: float, flops: float, peak: float) -> float:
    return max(nbytes / PEAK_BYTES, flops / peak) * 1e3


def affine_flops(rows) -> float:
    """2 per multiply-add and 2 per output (the folded BN's affine), as
    the kernel study counts a conv."""
    return sum(2.0 * r[1] + 2.0 * r[2] for r in rows)
