"""Weight initialisation of the port's FasterVoxelPose, every draw from an
explicit `torch.Generator` (CPU; initialise before moving the model).

- `flax_init`: the reference package's default scheme ("flax",
  fvp_tpu/models/blocks.py:22 and cnns.py), as draws on the port's modules:
  every conv and transposed conv of CenterNet, C2CNet and P2PNet N(0, 0.001)
  with zero bias; WeightNet's conv and linear layers lecun-normal (a normal
  of std sqrt(1 / fan_in) / 0.8796, truncated at two std) with zero bias;
  every BatchNorm scale 1, bias 0, running mean 0 and variance 1.
- `torch_like_reinit`: every conv, transposed conv and linear layer of a
  module redrawn from PyTorch's default distributions, weights and biases
  U(+-sqrt(1 / fan_in)), fan_in by torch's rule (dim 1 times the kernel
  size, so a transposed conv's is its output channels times the kernel).
- `reference_reinit`: the original implementation's scheme (the reference
  package's TRAIN.INIT_SCHEME 'reference' / --torch-init): CenterNet,
  C2CNet and P2PNet redrawn N(0, 0.001) with zero bias, WeightNet
  `torch_like_reinit`; BatchNorms untouched.

A copy of fvp_tpu/engine/init.py's schemes; the draws themselves differ
(another generator), the distributions are the same.
"""

from __future__ import annotations

import math

import torch
from torch import nn

_CONVS = (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d, nn.ConvTranspose2d)
# flax's lecun_normal: a unit normal truncated to [-2, 2] has this std
_TRUNC_STD = 0.87962566103423978


def _fan_in(weight: torch.Tensor) -> int:
    return weight.shape[1] * math.prod(weight.shape[2:])


def _small_nets(model) -> tuple[nn.Module, ...]:
    return (model.pose_net.center_net, model.pose_net.c2c_net,
            model.joint_net.conv_net)


def _normal_convs(net: nn.Module, g: torch.Generator) -> None:
    for m in net.modules():
        if isinstance(m, _CONVS):
            nn.init.normal_(m.weight, 0.0, 1e-3, generator=g)
            nn.init.zeros_(m.bias)


@torch.no_grad()
def flax_init(model, g: torch.Generator) -> None:
    """The reference package's default initialisation (module docstring)."""
    for net in _small_nets(model):
        _normal_convs(net, g)
    for m in model.joint_net.weight_net.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            std = math.sqrt(1.0 / _fan_in(m.weight)) / _TRUNC_STD
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=g)
            nn.init.zeros_(m.bias)
    for m in model.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()


@torch.no_grad()
def torch_like_reinit(module: nn.Module, g: torch.Generator) -> None:
    """PyTorch's default distributions for every conv, transposed conv and
    linear layer of `module` (module docstring)."""
    for m in module.modules():
        if isinstance(m, _CONVS + (nn.Linear,)):
            bound = math.sqrt(1.0 / _fan_in(m.weight))
            nn.init.uniform_(m.weight, -bound, bound, generator=g)
            nn.init.uniform_(m.bias, -bound, bound, generator=g)


@torch.no_grad()
def reference_reinit(model, g: torch.Generator) -> None:
    """The original implementation's initialisation (module docstring)."""
    for net in _small_nets(model):
        _normal_convs(net, g)
    torch_like_reinit(model.joint_net.weight_net, g)
