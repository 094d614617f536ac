"""P2PNet on the bf16 conv kernels (csrc/conv_bf16.cu), with its plain
version: the `fuse_p2p` lowering of the JLN's plane net.

Replaces fvp_tpu/ops/pallas/hourglass.py::pallas_p2pnet, which runs the
whole net per plane stack in one launch with every activation in VMEM. On
Hopper one 64 x 64 x 32 bf16 activation (256 KB) is already more than a
block's shared memory, so the port runs the net layer by layer: 23 launches
of the implicit-GEMM conv (the 7x7 front, the ResBlocks' convs and
projections, the two up-convs, the 1x1 output) and 2 of the pool. It
rounds where the TPU kernel rounds (`_hourglass_body`): the input to bf16;
each ResBlock's first conv; the join relu(h2 + skip), where a projection
skip stays float32 and an identity skip is the bf16 input; each up-conv
after its affine and ReLU, and again after the skip add. The 1x1 output
conv adds its bias in float32.

`packed` comes from engine/packing.py::pack_p2pnet. `hourglass_supported`
is a copy of the reference's gate, so the port routes the same shapes to
the kernels as the reference routes to its fused net.
"""

from __future__ import annotations

import torch

from fvp_torch.ops.kernels.conv_bf16 import (PLAIN, conv_kernel, make_ops,
                                             pool_kernel)

CONV = conv_kernel("p2pnet.conv")
POOL = pool_kernel("p2pnet.pool")
_CUDA = make_ops(CONV, POOL)


def launches() -> int:
    return CONV.launches + POOL.launches


def hourglass_supported(shape) -> bool:
    """The reference kernel's gate (fvp_tpu/ops/pallas/hourglass.py:296):
    its (H, W, C) -> (H*W, C) merges need W % 8 == 0 at levels 0 and 1."""
    H, W = shape[-3], shape[-2]
    return (H % 16 == 0 and W % 16 == 0 and W >= 32 and H >= 32
            and (W // 2) % 8 == 0)


def _res(x, r, ops):
    """conv3-aff-relu, conv3-aff, + (1x1 proj-aff, float32) or identity
    skip, relu at the join."""
    h = ops.conv(x, r["c0"], relu=True)
    skip = x if r["proj"] is None else ops.conv(x, r["proj"],
                                                out_dtype=torch.float32)
    return ops.conv(h, r["c1"], res=skip, relu=True)


def body(packed, planes, ops):
    """The hourglass body (BasicBlock front, ResBlock, EncoderDecoder) of
    a packed P2PNet or CenterNet through `ops`: (N, H, W, Cin) -> (N, H, W,
    32) bf16, rounded where the reference's `_hourglass_body` rounds."""
    x = ops.conv(planes, packed["front"], relu=True)
    x = _res(x, packed["res0"], ops)
    e = packed["enc"]
    skip1 = _res(x, e["skip_res1"], ops)
    x = _res(ops.pool(x), e["encoder_res1"], ops)
    skip2 = _res(x, e["skip_res2"], ops)
    x = _res(ops.pool(x), e["encoder_res2"], ops)
    x = _res(x, e["mid_res"], ops)
    x = _res(x, e["decoder_res2"], ops)
    x = ops.upconv(x, e["decoder_upsample2"], skip2)
    x = _res(x, e["decoder_res1"], ops)
    return ops.upconv(x, e["decoder_upsample1"], skip1)


def run(packed, planes, ops):
    """P2PNet through `ops` (conv_bf16.PLAIN, the kernels' ops, or a
    caller's namespace of the same three ops)."""
    return ops.conv(body(packed, planes, ops), packed["final"],
                    out_dtype=torch.float32)


def p2pnet_plain(packed: dict, planes: torch.Tensor) -> torch.Tensor:
    """Plain version on any device: (N, A, B, J) float32 -> (N, A, B, J)
    float32."""
    return run(packed, planes, PLAIN)


def p2pnet(packed: dict, planes: torch.Tensor) -> torch.Tensor:
    """P2PNet on plane stacks (N, A, B, J) float32 -> (N, A, B, J) float32:
    the kernels for a CUDA tensor, the plain version for a CPU tensor."""
    if not planes.is_cuda:
        return p2pnet_plain(packed, planes)
    return run(packed, planes.contiguous(), _CUDA)
