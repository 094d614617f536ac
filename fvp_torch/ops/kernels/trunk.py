"""The stride-1 ResNet bottleneck stage on the bf16 conv kernel
(csrc/conv_bf16.cu), with its plain version.

Replaces fvp_tpu/ops/pallas/trunk.py::pallas_bottleneck_stage, which runs
a chain of stride-1 Bottlenecks with folded BN (ResNet-50's layer1) as one
launch per (view, row block). Its flat padded rows, relayout copies and
halo rows work around the TPU's tiling; here a zero-padded SAME 3x3 conv is
all it takes, and the stage runs one launch per conv (10 for layer1: three
blocks of three convs, and block 0's downsample). It rounds where the TPU
kernel rounds (`_stage_kernel`): a downsample residual after its affine;
h = relu(aff(conv1)); y = relu(aff(conv2)); out = relu(aff(conv3) + res),
with an identity residual the bf16 input.

PoseResNet runs a Bottleneck ResNet's layer1 on it under
`compute_dtype='bfloat16'` (models/resnet.py::PoseResNet.trunk). `packed`
comes from engine/packing.py::pack_bottleneck_stage; `blocks_cfg` is a
tuple of (cmid, downsample) per block, as the reference takes it.
"""

from __future__ import annotations

import torch

from fvp_torch.ops.kernels.conv_bf16 import PLAIN, conv_kernel, make_ops

CONV = conv_kernel("bottleneck_stage")
_CUDA = make_ops(CONV)


def run(x, packed, blocks_cfg, ops):
    """The stage through `ops` (conv_bf16.PLAIN, the kernel's ops, or a
    caller's namespace of the same ops)."""
    if len(packed) != len(blocks_cfg):
        raise ValueError(f"bottleneck_stage: {len(packed)} packed blocks, "
                         f"{len(blocks_cfg)} configured")
    for blk, (cmid, down) in zip(packed, blocks_cfg):
        if (blk["down"] is not None) != bool(down) or \
                blk["c1"]["w"].shape[-1] != cmid:
            raise ValueError(f"bottleneck_stage: packed block does not match "
                             f"(cmid, down) = {(cmid, down)}")
        res = ops.conv(x, blk["down"]) if down else x
        h = ops.conv(x, blk["c1"], relu=True)
        y = ops.conv(h, blk["c2"], relu=True)
        x = ops.conv(y, blk["c3"], res=res, relu=True)
    return x


def bottleneck_stage_plain(x: torch.Tensor, packed: list,
                           blocks_cfg: tuple) -> torch.Tensor:
    """Plain version on any device: (V, H, W, Cin) -> (V, H, W, 4 cmid)
    bf16."""
    return run(x.to(torch.bfloat16), packed, blocks_cfg, PLAIN)


def bottleneck_stage(x: torch.Tensor, packed: list,
                     blocks_cfg: tuple) -> torch.Tensor:
    """The stage on (V, H, W, Cin) bf16 features -> (V, H, W, 4 cmid) bf16:
    the kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if not x.is_cuda:
        return bottleneck_stage_plain(x, packed, blocks_cfg)
    if x.dtype != torch.bfloat16:
        raise ValueError(f"bottleneck_stage: dtype {x.dtype}, expected "
                         "bfloat16")
    return run(x.contiguous(), packed, blocks_cfg, _CUDA)
