"""The arithmetic of the reference: float32 with TF32 off, or, for the
control runs, a lower precision put in the same places.

`Precision` rounds the two operands of every conv and matmul of the
reference nets before a float32 product: 'fp32' leaves them as they are,
'tf32' rounds their mantissas to TF32's 10 bits (what the tensor cores do
with TF32 on), 'fp8' scales each tensor by its absolute maximum onto
float8_e4m3fn's range and rounds it there (a per-tensor scaled fp8
product, summed in float32).
"""

from __future__ import annotations

import contextlib

import torch

FORMATS = ("fp32", "tf32", "fp8")
FP8_MAX = 448.0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties to even), as float32."""
    bits = x.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """float32 -> per-tensor scaled float8_e4m3fn values, as float32."""
    x = x.float()
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Precision:
    """`q(x)` rounds a conv's or matmul's operand to the format."""

    def __init__(self, fmt: str = "fp32"):
        if fmt not in FORMATS:
            raise ValueError(f"precision {fmt!r}: one of {FORMATS}")
        self.fmt = fmt

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.fmt == "tf32":
            return round_tf32(x)
        if self.fmt == "fp8":
            return round_fp8(x)
        return x


@contextlib.contextmanager
def float32_math():
    """TF32 off for cuDNN convs and matmuls inside, the caller's settings
    restored afterwards (through the per-backend precision strings where
    torch has them, else the legacy flags)."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    conv = getattr(cudnn, "conv", None)
    if hasattr(conv, "fp32_precision"):
        saved = conv.fp32_precision, matmul.fp32_precision
        conv.fp32_precision = matmul.fp32_precision = "ieee"
        try:
            yield
        finally:
            conv.fp32_precision, matmul.fp32_precision = saved
        return
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
