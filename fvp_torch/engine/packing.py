"""Load-time packing of the kernels' weights.

Computed once when a model is loaded, not per frame: CenterNet's layers and
WeightNet's conv front end, with conv bias and BatchNorm running stats
folded into a per-channel affine (scale a = gamma / sqrt(var + eps),
shift = a * conv_bias + beta - mean * a), and kernels laid out for the NHWC
kernels: (k, k, Cin, Cout) for a conv, (2, 2, Cin, Cout) for a transposed
conv, (9, C) for WeightNet's single-input-channel conv. CenterNet's
packing also merges its heads' 3x3 convs into one 32 -> 64 conv ("heads")
and puts every weight its kernel reads into one float32 buffer ("flat",
each layer a view into it; ops/kernels/centernet.py::flatten_weights).
The backbone's
stem and deconv-head weights are packed in bf16, the type their kernels
read (`pack_backbone`).

The bf16 kernels of the `fuse_p2p` path and of the bottleneck stage read
their layers as {"w": (k*k, Cin, F) bf16 (taps in row-major order; (2, 2,
Cin, F) or (2, Cin, F) for an up-conv, w[r, s] the tap of output
(2i + r, 2j + s)), "aff": (2, F) float32 (scale, shift)}, BN folded in
float32 at eps 1e-5, an up-conv's bias kept in its shift: `pack_p2pnet`
(P2PNet, with its 1x1 output conv's bias in float32), `pack_c2cnet` (C2CNet,
every layer a view into two flat buffers, and its weights once more in the
order of its one-launch kernel's mma fragments)
and `pack_bottleneck_stage` (a ResNet layer of stride-1 Bottlenecks). They
equal the reference package's `pack_p2pnet`, `pack_c2cnet` and
`pack_bottleneck_stage` (fvp_tpu/ops/pallas/hourglass.py, trunk.py) up to
these layouts.

For `compute_dtype='bfloat16'` the packed weights also hold copies of the
modules that run on cuDNN in bf16, their convs' weights in bf16
(`bf16_copy`). Like every packed weight they are a snapshot of the
parameters: a model whose parameters change is packed again.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from fvp_torch.models.blocks import ResBlock, UpsampleBlock, set_compute_dtype
from fvp_torch.models.cnns import C2CNet, CenterNet, P2PNet, WeightNet
from fvp_torch.models.resnet import Bottleneck
from fvp_torch.ops.kernels.c2cnet import pack_fragments
from fvp_torch.ops.kernels.centernet import flatten_bf16, flatten_weights
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
    # the kernel's merged heads: hm0 and size0 as one 32 -> 64 conv
    packed["heads"] = {
        key: torch.cat([packed["hm0"][key], packed["size0"][key]],
                       dim=-1).contiguous()
        for key in ("w", "scale", "shift")}
    return flatten_weights(packed)


@torch.no_grad()
def pack_weightnet(net: WeightNet) -> dict:
    conv, bn = net.heatmap_feature_net[0], net.heatmap_feature_net[1]
    scale, shift = _affine(conv.bias, bn)
    C = conv.weight.shape[0]
    return {"w": conv.weight.detach().reshape(C, 9).t().contiguous(),
            "scale": scale.contiguous(), "shift": shift.contiguous()}


@torch.no_grad()
def pack_weightnet_bf16(net: WeightNet) -> dict:
    """WeightNet's conv front end for the bf16 route
    (ops/kernels/weightnet.py::weightnet_pool_bf16): "w" (16, C) bf16, the
    9 taps row-major over (dy, dx) and 7 zero rows (the k16 of an mma),
    "aff" (2, C) float32 folded as the reference folds (`_fold`)."""
    conv, bn = net.heatmap_feature_net[0], net.heatmap_feature_net[1]
    C = conv.weight.shape[0]
    w = torch.zeros((16, C), dtype=torch.bfloat16, device=conv.weight.device)
    w[:9] = conv.weight.detach().reshape(C, 9).t().to(torch.bfloat16)
    return {"w": w, "aff": _fold(conv.bias, bn).contiguous()}


def bn_affine(bn: nn.BatchNorm2d) -> torch.Tensor:
    """BatchNorm running stats folded into a (2, F) float32 (a, b) affine:
    a = gamma / sqrt(var + 1e-5), b = beta - mean * a."""
    a = bn.weight / torch.sqrt(bn.running_var + 1e-5)
    return torch.stack([a, bn.bias - bn.running_mean * a]).detach() \
        .float().contiguous()


@torch.no_grad()
def pack_backbone(model, compute_dtype: str = "float32") -> dict:
    """Packed weights of a PoseResNet's stem and deconv-head kernels, on the
    model's device, in bf16: {"stem": {"w": (7, 7, 3, 64), "aff"},
    "head": [{"w": (4, 4, Cin, F) per parity and tap, "aff"}, ...],
    "compute_dtype"}. For 'bfloat16' also the trunk's layers in bf16
    ("trunk": their `bf16_copy`), but a Bottleneck ResNet's layer1, which
    is packed for the stage kernel ("layer1": (its blocks, (cmid,
    downsample) per block))."""
    check_compute_dtype(compute_dtype)
    stem = {"w": model.conv1.weight.detach().permute(2, 3, 1, 0)
            .to(torch.bfloat16).contiguous(), "aff": bn_affine(model.bn1)}
    layers = list(model.deconv_layers)
    head = [{"w": pack_deconv_weight(conv.weight), "aff": bn_affine(bn)}
            for conv, bn in zip(layers[0::3], layers[1::3])]
    packed = {"stem": stem, "head": head, "compute_dtype": compute_dtype}
    if compute_dtype == "bfloat16":
        trunk = [model.layer1, model.layer2, model.layer3, model.layer4]
        if isinstance(model.layer1[0], Bottleneck):
            packed["layer1"] = (pack_bottleneck_stage(model.layer1), tuple(
                (blk.conv1.out_channels, blk.downsample is not None)
                for blk in model.layer1))
            trunk = trunk[1:]
        packed["trunk"] = [bf16_copy(layer) for layer in trunk]
    return packed


# the reference package's float32 and its serving configuration's bf16
COMPUTE_DTYPES = ("float32", "bfloat16")


def check_compute_dtype(compute_dtype: str) -> None:
    """Raise for a compute_dtype the port does not serve."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {compute_dtype!r}: fvp_torch "
                         f"serves {' and '.join(COMPUTE_DTYPES)}")


@torch.no_grad()
def bf16_copy(module: nn.Module, keep_float: tuple[str, ...] = ()
              ) -> nn.Module:
    """A copy of `module` for a bf16 input, as the reference's modules
    with `dtype=bfloat16` compute (their parameters stay float32 and are
    cast at use; here once, at load time): its convs hold bf16 weights
    and biases (a 2D conv's weight channels-last, the layout of the port's
    activations), sum in float32 and round their output to bf16; its
    BatchNorms keep float32 statistics and affine and round their output
    to bf16. The submodules named in `keep_float` (the task nets' 1x1
    heads, which take a float32 input) stay float32. The module itself is
    left as it is."""
    # the copy computes as torch's own modules on its bf16 weights, its
    # BatchNorms in float32 on the bf16 input (not the modules' own bf16
    # mode: models/blocks.py)
    net = set_compute_dtype(copy.deepcopy(module), "float32")
    kept = {id(m) for name in keep_float
            for m in net.get_submodule(name).modules()}
    for m in net.modules():
        if isinstance(m, _CONVS) and id(m) not in kept:
            m.to(torch.bfloat16)
            if isinstance(m, nn.Conv2d):
                m.to(memory_format=torch.channels_last)
    return net


_CONVS = (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d, nn.ConvTranspose2d)


def _fold(bias: torch.Tensor | None, bn: nn.Module | None) -> torch.Tensor:
    """(2, F) float32 (a, a * conv_bias + beta - mean * a), a = gamma /
    sqrt(var + 1e-5); (1, conv_bias) without a BN. Each step is one
    correctly rounded float32 operation, in numpy (torch's vectorised CPU
    division and square root may differ from it by an ulp), as the
    reference package folds."""
    def f32(t):
        return t.detach().cpu().numpy().astype(np.float32)

    if bn is None:
        b = f32(bias)
        aff = np.stack([np.ones_like(b), b])
    else:
        a = f32(bn.weight) / np.sqrt(f32(bn.running_var) + np.float32(1e-5))
        b = f32(bn.bias) - f32(bn.running_mean) * a
        if bias is not None:
            b = a * f32(bias) + b
        aff = np.stack([a, b])
    device = (bias if bias is not None else bn.weight).device
    return torch.from_numpy(aff).to(device)


def _layer_bf16(conv: nn.Module, bn: nn.Module | None = None) -> dict:
    """A Conv1d/Conv2d (+ BN) as the bf16 kernels read it: w (k*k, Cin, F),
    the reference's (kh, kw, Cin, F) kernel with its taps flattened."""
    w = conv.weight.detach()
    w = w.permute(*range(2, w.dim()), 1, 0)          # (k..., Cin, F)
    return {"w": w.reshape(-1, *w.shape[-2:]).to(torch.bfloat16)
            .contiguous(), "aff": _fold(conv.bias, bn).contiguous()}


def _upsample_bf16(up: UpsampleBlock) -> dict:
    """A ConvTranspose (k = 2, s = 2) + BN: w[r(, s)] = weight[:, :, r(, s)],
    the reference's flipped flax kernel kf[1-r(, 1-s)]; its bias folded."""
    conv, bn = up.block[0], up.block[1]
    w = conv.weight.detach()                          # (Cin, F, 2(, 2))
    w = w.permute(*range(2, w.dim()), 0, 1)
    return {"w": w.to(torch.bfloat16).contiguous(),
            "aff": _fold(conv.bias, bn).contiguous()}


def _res_bf16(res: ResBlock) -> dict:
    rb, sk = res.res_branch, res.skip_con
    return {"c0": _layer_bf16(rb[0], rb[1]), "c1": _layer_bf16(rb[3], rb[4]),
            "proj": _layer_bf16(sk[0], sk[1]) if len(sk) else None}


def _hourglass_bf16(net) -> dict:
    """BasicBlock front + ResBlock + EncoderDecoder of P2PNet or C2CNet."""
    front = net.front_layers[0].block
    enc = net.encoder_decoder
    packed = {"front": _layer_bf16(front[0], front[1]),
              "res0": _res_bf16(net.front_layers[1]),
              "enc": {name: _res_bf16(getattr(enc, name)) for name in _ENC}}
    for name in ("decoder_upsample2", "decoder_upsample1"):
        packed["enc"][name] = _upsample_bf16(getattr(enc, name))
    return packed


def hourglass_layers(packed: dict) -> list:
    """The layers of a packed hourglass in the order of the reference's
    packers and of the C2CNet kernel: front, ResBlocks (c0, c1, proj),
    the up-convs between them."""
    def res(r):
        return [r["c0"], r["c1"]] + ([r["proj"]] if r["proj"] else [])

    e = packed["enc"]
    out = [packed["front"]] + res(packed["res0"])
    for name in _ENC[:-1]:
        out += res(e[name])
    return out + [e["decoder_upsample2"]] + res(e["decoder_res1"]) \
        + [e["decoder_upsample1"]]


@torch.no_grad()
def pack_p2pnet(net: P2PNet) -> dict:
    """P2PNet for ops/kernels/hourglass.py: the hourglass layers and
    "final", the 1x1 output conv with (1, bias) as its affine."""
    packed = _hourglass_bf16(net)
    packed["final"] = _layer_bf16(net.output_layer)
    return packed


@torch.no_grad()
def pack_centernet_bf16(net: CenterNet) -> dict:
    """CenterNet for its bf16 route (ops/kernels/centernet.py::
    centernet_bf16): the hourglass layers as in pack_p2pnet, "heads" the
    two heads' 3x3 convs as one 32 -> 64 layer (hm's channels first) and
    "out" their 1x1 convs as one 64 -> 3 layer, hm's weights on channels
    0..31 of output 0 and size's on channels 32..63 of outputs 1-2, zeros
    elsewhere (exact zeros in the sums); (1, bias) affines. The persistent
    kernel reads "wflat" and "affflat", every layer's weights and affines
    in its own layout (ops/kernels/centernet.py::flatten_bf16)."""
    packed = _hourglass_bf16(net)
    hm0, size0 = _layer_bf16(net.output_hm[0]), _layer_bf16(
        net.output_size[0])
    packed["heads"] = {k: torch.cat([hm0[k], size0[k]], dim=-1)
                       .contiguous() for k in ("w", "aff")}
    hm1, size1 = _layer_bf16(net.output_hm[2]), _layer_bf16(
        net.output_size[2])
    c = hm1["w"].shape[1]
    w = torch.zeros((1, 2 * c, 3), dtype=torch.bfloat16,
                    device=hm1["w"].device)
    w[0, :c, :1] = hm1["w"][0]
    w[0, c:, 1:] = size1["w"][0]
    packed["out"] = {"w": w, "aff": torch.cat([hm1["aff"], size1["aff"]],
                                              dim=1).contiguous()}
    return flatten_bf16(packed)


@torch.no_grad()
def pack_c2cnet(net: C2CNet) -> dict:
    """C2CNet for ops/kernels/c2cnet.py: the layers as in pack_p2pnet, each
    a view into "w_flat" (bf16) and "aff_flat" (float32), in the order of
    c2cnet.layer_shapes, and "w_frag": the same weights but the output
    conv's in the order of the kernel's mma B fragments
    (c2cnet.pack_fragments)."""
    packed = _hourglass_bf16(net)
    packed["final"] = _layer_bf16(net.output_hm)
    layers = hourglass_layers(packed) + [packed["final"]]
    packed["w_frag"] = pack_fragments(layers[:-1],
                                      packed["front"]["w"].shape[1])
    for key, flat_key in (("w", "w_flat"), ("aff", "aff_flat")):
        flat = torch.cat([lay[key].reshape(-1) for lay in layers])
        offset = 0
        for lay in layers:
            n = lay[key].numel()
            lay[key] = flat[offset:offset + n].view(lay[key].shape)
            offset += n
        packed[flat_key] = flat
    return packed


@torch.no_grad()
def pack_bottleneck_stage(layer: nn.Sequential) -> list:
    """A ResNet layer of stride-1 Bottlenecks (models/resnet.py) for
    ops/kernels/trunk.py: per block {"c1", "c2", "c3", "down" (or None)}."""
    out = []
    for blk in layer:
        if blk.conv2.stride != (1, 1):
            raise ValueError("pack_bottleneck_stage: stride-1 blocks only")
        down = blk.downsample
        out.append({"c1": _layer_bf16(blk.conv1, blk.bn1),
                    "c2": _layer_bf16(blk.conv2, blk.bn2),
                    "c3": _layer_bf16(blk.conv3, blk.bn3),
                    "down": None if down is None
                    else _layer_bf16(down[0], down[1])})
    return out


def pack_model(model, compute_dtype: str = "float32") -> dict:
    """Packed kernel weights of a FasterVoxelPose, on the model's device.
    They are detached from the parameters (no autograd). P2PNet and C2CNet
    are packed only for the `fuse_p2p` path, which runs them as kernels.
    For `compute_dtype='bfloat16'` their cuDNN modules (the path without
    `fuse_p2p`, and shapes its kernels do not take) are packed as well, as
    `bf16_copy`s with their 1x1 heads in float32: "bf16_nets" {"c2c_net",
    "conv_net"}; and CenterNet and WeightNet's front end for their bf16
    routes: "center_net_bf16", "weight_net_bf16"."""
    check_compute_dtype(compute_dtype)
    packed = {"center_net": pack_centernet(model.pose_net.center_net),
              "weight_net": pack_weightnet(model.joint_net.weight_net)}
    if model.cfg.fuse_p2p:
        packed["p2p_net"] = pack_p2pnet(model.joint_net.conv_net)
        packed["c2c_net"] = pack_c2cnet(model.pose_net.c2c_net)
    if compute_dtype == "bfloat16":
        packed["center_net_bf16"] = pack_centernet_bf16(
            model.pose_net.center_net)
        packed["weight_net_bf16"] = pack_weightnet_bf16(
            model.joint_net.weight_net)
        packed["bf16_nets"] = {
            "c2c_net": bf16_copy(model.pose_net.c2c_net, ("output_hm",)),
            "conv_net": bf16_copy(model.joint_net.conv_net,
                                  ("output_layer",))}
    return packed
