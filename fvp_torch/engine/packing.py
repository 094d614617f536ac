"""Load-time packing of the kernels' weights.

Computed once when a model is loaded, not per frame: CenterNet's layers and
WeightNet's conv front end, with conv bias and BatchNorm running stats
folded into a per-channel affine (scale a = gamma / sqrt(var + eps),
shift = a * conv_bias + beta - mean * a), and kernels laid out for the NHWC
kernels: (k, k, Cin, Cout) for a conv, (2, 2, Cin, Cout) for a transposed
conv, (9, C) for WeightNet's single-input-channel conv. The backbone's
stem and deconv-head weights are packed in bf16, the type their kernels
read (`pack_backbone`).
"""

from __future__ import annotations

import torch
from torch import nn

from fvp_torch.models.blocks import ResBlock, UpsampleBlock
from fvp_torch.models.cnns import CenterNet, WeightNet
from fvp_torch.ops.kernels.deconv_head import pack_deconv_weight

_ENC = ("skip_res1", "encoder_res1", "skip_res2", "encoder_res2", "mid_res",
        "decoder_res2", "decoder_res1")


def _affine(bias: torch.Tensor, bn: nn.BatchNorm2d | None):
    bias = bias.detach()
    if bn is None:
        return torch.ones_like(bias), bias.clone()
    a = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    return a, a * bias + (bn.bias - bn.running_mean * a)


def pack_conv(conv: nn.Conv2d, bn: nn.BatchNorm2d | None = None) -> dict:
    scale, shift = _affine(conv.bias, bn)
    return {"w": conv.weight.detach().permute(2, 3, 1, 0).contiguous(),
            "scale": scale.contiguous(), "shift": shift.contiguous()}


def pack_upsample(up: UpsampleBlock) -> dict:
    conv, bn = up.block[0], up.block[1]
    scale, shift = _affine(conv.bias, bn)
    return {"w": conv.weight.detach().permute(2, 3, 0, 1).contiguous(),
            "scale": scale.contiguous(), "shift": shift.contiguous()}


def pack_res(res: ResBlock) -> dict:
    rb, sk = res.res_branch, res.skip_con
    return {"c0": pack_conv(rb[0], rb[1]), "c1": pack_conv(rb[3], rb[4]),
            "proj": pack_conv(sk[0], sk[1]) if len(sk) else None}


@torch.no_grad()
def pack_centernet(net: CenterNet) -> dict:
    front = net.front_layers[0].block
    enc = net.encoder_decoder
    packed = {
        "front": pack_conv(front[0], front[1]),
        "res0": pack_res(net.front_layers[1]),
        "enc": {name: pack_res(getattr(enc, name)) for name in _ENC},
        "hm0": pack_conv(net.output_hm[0]),
        "hm1": pack_conv(net.output_hm[2]),
        "size0": pack_conv(net.output_size[0]),
        "size1": pack_conv(net.output_size[2]),
    }
    packed["enc"]["decoder_upsample2"] = pack_upsample(enc.decoder_upsample2)
    packed["enc"]["decoder_upsample1"] = pack_upsample(enc.decoder_upsample1)
    return packed


@torch.no_grad()
def pack_weightnet(net: WeightNet) -> dict:
    conv, bn = net.heatmap_feature_net[0], net.heatmap_feature_net[1]
    scale, shift = _affine(conv.bias, bn)
    C = conv.weight.shape[0]
    return {"w": conv.weight.detach().reshape(C, 9).t().contiguous(),
            "scale": scale.contiguous(), "shift": shift.contiguous()}


def bn_affine(bn: nn.BatchNorm2d) -> torch.Tensor:
    """BatchNorm running stats folded into a (2, F) float32 (a, b) affine:
    a = gamma / sqrt(var + 1e-5), b = beta - mean * a."""
    a = bn.weight / torch.sqrt(bn.running_var + 1e-5)
    return torch.stack([a, bn.bias - bn.running_mean * a]).detach() \
        .float().contiguous()


@torch.no_grad()
def pack_backbone(model) -> dict:
    """Packed weights of a PoseResNet's stem and deconv-head kernels, on the
    model's device, in bf16: {"stem": {"w": (7, 7, 3, 64), "aff"},
    "head": [{"w": (4, 4, Cin, F) per parity and tap, "aff"}, ...]}."""
    stem = {"w": model.conv1.weight.detach().permute(2, 3, 1, 0)
            .to(torch.bfloat16).contiguous(), "aff": bn_affine(model.bn1)}
    layers = list(model.deconv_layers)
    head = [{"w": pack_deconv_weight(conv.weight), "aff": bn_affine(bn)}
            for conv, bn in zip(layers[0::3], layers[1::3])]
    return {"stem": stem, "head": head}


def pack_model(model) -> dict:
    """Packed kernel weights of a FasterVoxelPose, on the model's device.
    They are detached from the parameters (no autograd)."""
    return {"center_net": pack_centernet(model.pose_net.center_net),
            "weight_net": pack_weightnet(model.joint_net.weight_net)}
