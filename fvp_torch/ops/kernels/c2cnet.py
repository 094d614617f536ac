"""Wrapper of the C2CNet kernel (csrc/c2cnet.cu), with its plain version:
the `fuse_p2p` lowering of the HDN's 1D height net.

Replaces fvp_tpu/ops/pallas/hourglass.py::pallas_c2cnet: the whole 1D
hourglass over the proposals' z-columns in one launch. The kernel runs one
block per column, with every level's activations (at most Z x 32 values
each) in shared memory and the bf16 weights copied from L2 into shared
memory layer by layer. It rounds where the TPU kernel rounds
(`_c2c_kernel`): the input to bf16; each ResBlock's first conv; the join
relu(h2 + skip), where a projection skip stays float32 and an identity
skip is the bf16 input; each up-conv after its affine and ReLU, and again
after the skip add. The 1x1 output conv adds its bias in float32.

`packed` comes from engine/packing.py::pack_c2cnet: the layers as
{"w": (k, Cin, F) bf16, "aff": (2, F) float32} (an up-conv's "w" is
(2, Cin, F), w[r] the tap of output 2z + r), all of them views into two
flat buffers, "w_flat" and "aff_flat", in the order `layer_shapes` lists,
which is the order the kernel walks. The plain version is P2PNet's
hourglass (`hourglass.run`) on the 1D plain ops.
"""

from __future__ import annotations

import torch

from fvp_torch.ops.kernels import Kernel, check, ptr
from fvp_torch.ops.kernels.conv_bf16 import PLAIN
from fvp_torch.ops.kernels.hourglass import run

C2C = Kernel("c2cnet", "fvp_c2cnet")
# the encoder-decoder's widths and the front's (models/blocks.py)
_C0, _C1, _C2, _FRONT = 32, 64, 128, 16


def layer_shapes(J: int) -> list[tuple[str, int, int, int]]:
    """(name, taps, Cin, F) of every layer in the kernel's order."""
    def res(name, cin, f):
        out = [(f"{name}.c0", 3, cin, f), (f"{name}.c1", 3, f, f)]
        return out + ([(f"{name}.proj", 1, cin, f)] if cin != f else [])

    return ([("front", 7, J, _FRONT)] + res("res0", _FRONT, _C0)
            + res("skip_res1", _C0, _C0) + res("encoder_res1", _C0, _C1)
            + res("skip_res2", _C1, _C1) + res("encoder_res2", _C1, _C2)
            + res("mid_res", _C2, _C2) + res("decoder_res2", _C2, _C2)
            + [("decoder_upsample2", 2, _C2, _C1)]
            + res("decoder_res1", _C1, _C1)
            + [("decoder_upsample1", 2, _C1, _C0), ("final", 1, _C0, 1)])


# -- plain version ------------------------------------------------------------

def c2cnet_plain(packed: dict, cols: torch.Tensor) -> torch.Tensor:
    """Plain version on any device: (N, Z, J) float32 -> (N, Z) float32,
    the hourglass of ops/kernels/hourglass.py on the 1D plain ops."""
    return run(packed, cols, PLAIN)[..., 0]


# -- kernel launch ------------------------------------------------------------

def c2cnet(packed: dict, cols: torch.Tensor) -> torch.Tensor:
    """C2CNet on proposal z-columns (N, Z, J) float32 -> (N, Z) float32
    height heatmaps: one kernel launch for a CUDA tensor, the plain version
    for a CPU tensor. Z must be a multiple of 4 (two pooling levels)."""
    if not cols.is_cuda:
        return c2cnet_plain(packed, cols)
    N, Z, J = cols.shape
    if Z % 4:
        raise ValueError(f"c2cnet: Z = {Z} is not a multiple of 4")
    cols = cols.contiguous()
    check(cols, "cols")
    n_w = sum(t * ci * f for _, t, ci, f in layer_shapes(J))
    n_aff = sum(2 * f for _, _, _, f in layer_shapes(J))
    check(packed["w_flat"], "w_flat", (n_w,), dtype=torch.bfloat16,
          device=cols.device)
    check(packed["aff_flat"], "aff_flat", (n_aff,), device=cols.device)
    out = torch.empty((N, Z), dtype=torch.float32, device=cols.device)
    if N:
        C2C(ptr(cols), ptr(packed["w_flat"]), ptr(packed["aff_flat"]),
            ptr(out), N, Z, J)
    return out
