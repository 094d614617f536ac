"""Reference-package (flax) variables -> port state dict.

`from_jax_backbone_variables` does the same for the PoseResNet backbone.
`from_jax_variables` maps the flax `{'params', 'batch_stats'}` tree of the
HDN+JLN task nets, given as numpy arrays, onto the port's modules, whose
keys are the reference model's (`pose_net.center_net.*`,
`pose_net.c2c_net.*`, `joint_net.conv_net.*`, `joint_net.weight_net.*`).
It is the inverse of the reference package's torch -> flax converter, so a
port `state_dict()` round-trips through that converter bit for bit.

Layer-name correspondence (flax auto-names follow execution order):
  BasicBlock_k {Conv_0, BatchNorm_0}          <- .block.{0,1}
  ResBlock_k {Conv_0, BatchNorm_0, Conv_1,    <- .res_branch.{0,1,3,4}
              BatchNorm_1 (, Conv_2, BatchNorm_2)}  (.skip_con.{0,1})
  UpsampleBlock_k {ConvTranspose_0, BatchNorm_0} <- .block.{0,1}
  EncoderDecoder_0: ResBlock_0..6 = skip_res1, encoder_res1, skip_res2,
    encoder_res2, mid_res, decoder_res2, decoder_res1;
    UpsampleBlock_0/1 = decoder_upsample2/1
Conv kernels are (k..., I, O) in flax and (O, I, k...) in torch; a flax
ConvTranspose kernel is (k..., I, O) and spatially flipped against torch's
(I, O, k...).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

_ENC_RES = (("ResBlock_0", "skip_res1"), ("ResBlock_1", "encoder_res1"),
            ("ResBlock_2", "skip_res2"), ("ResBlock_3", "encoder_res2"),
            ("ResBlock_4", "mid_res"), ("ResBlock_5", "decoder_res2"),
            ("ResBlock_6", "decoder_res1"))
_ENC_UP = (("UpsampleBlock_0", "decoder_upsample2"),
           ("UpsampleBlock_1", "decoder_upsample1"))


def _conv_w(k: np.ndarray) -> np.ndarray:
    if k.ndim == 4:
        return np.transpose(k, (3, 2, 0, 1))
    return np.transpose(k, (2, 1, 0))


def _deconv_w(k: np.ndarray) -> np.ndarray:
    if k.ndim == 4:
        return np.transpose(k[::-1, ::-1], (2, 3, 0, 1))
    return np.transpose(k[::-1], (1, 2, 0))


class _Writer:
    def __init__(self):
        self.out: dict[str, torch.Tensor] = {}

    def put(self, key: str, a) -> None:
        self.out[key] = torch.from_numpy(np.array(a, np.float32))

    def conv(self, dst: str, p: Mapping, deconv: bool = False) -> None:
        k = np.asarray(p["kernel"])
        self.put(f"{dst}.weight", _deconv_w(k) if deconv else _conv_w(k))
        self.put(f"{dst}.bias", p["bias"])

    def bn(self, dst: str, p: Mapping, s: Mapping) -> None:
        self.put(f"{dst}.weight", p["scale"])
        self.put(f"{dst}.bias", p["bias"])
        self.put(f"{dst}.running_mean", s["mean"])
        self.put(f"{dst}.running_var", s["var"])
        self.out[f"{dst}.num_batches_tracked"] = torch.tensor(0)

    def dense(self, dst: str, p: Mapping) -> None:
        self.put(f"{dst}.weight", np.asarray(p["kernel"]).T)
        self.put(f"{dst}.bias", p["bias"])

    def basic_block(self, dst: str, p: Mapping, s: Mapping) -> None:
        self.conv(f"{dst}.block.0", p["Conv_0"])
        self.bn(f"{dst}.block.1", p["BatchNorm_0"], s["BatchNorm_0"])

    def res_block(self, dst: str, p: Mapping, s: Mapping) -> None:
        self.conv(f"{dst}.res_branch.0", p["Conv_0"])
        self.bn(f"{dst}.res_branch.1", p["BatchNorm_0"], s["BatchNorm_0"])
        self.conv(f"{dst}.res_branch.3", p["Conv_1"])
        self.bn(f"{dst}.res_branch.4", p["BatchNorm_1"], s["BatchNorm_1"])
        if "Conv_2" in p:
            self.conv(f"{dst}.skip_con.0", p["Conv_2"])
            self.bn(f"{dst}.skip_con.1", p["BatchNorm_2"], s["BatchNorm_2"])

    def upsample_block(self, dst: str, p: Mapping, s: Mapping) -> None:
        self.conv(f"{dst}.block.0", p["ConvTranspose_0"], deconv=True)
        self.bn(f"{dst}.block.1", p["BatchNorm_0"], s["BatchNorm_0"])

    def hourglass(self, dst: str, p: Mapping, s: Mapping) -> None:
        """BasicBlock front + ResBlock + EncoderDecoder."""
        self.basic_block(f"{dst}.front_layers.0", p["BasicBlock_0"],
                         s["BasicBlock_0"])
        self.res_block(f"{dst}.front_layers.1", p["ResBlock_0"],
                       s["ResBlock_0"])
        ep, es = p["EncoderDecoder_0"], s["EncoderDecoder_0"]
        for src, name in _ENC_RES:
            self.res_block(f"{dst}.encoder_decoder.{name}", ep[src], es[src])
        for src, name in _ENC_UP:
            self.upsample_block(f"{dst}.encoder_decoder.{name}", ep[src],
                                es[src])


def from_jax_variables(variables_np: Mapping[str, Any]
                       ) -> dict[str, torch.Tensor]:
    """flax {'params', 'batch_stats'} tree of FasterVoxelPose (numpy
    leaves) -> the port's FasterVoxelPose state dict."""
    params, stats = variables_np["params"], variables_np["batch_stats"]
    w = _Writer()

    p, s = params["center_net"], stats["center_net"]
    w.hourglass("pose_net.center_net", p, s)
    w.conv("pose_net.center_net.output_hm.0", p["Conv_0"])
    w.conv("pose_net.center_net.output_hm.2", p["Conv_1"])
    w.conv("pose_net.center_net.output_size.0", p["Conv_2"])
    w.conv("pose_net.center_net.output_size.2", p["Conv_3"])

    p, s = params["c2c_net"], stats["c2c_net"]
    w.hourglass("pose_net.c2c_net", p, s)
    w.conv("pose_net.c2c_net.output_hm", p["Conv_0"])

    p, s = params["p2p_net"], stats["p2p_net"]
    w.hourglass("joint_net.conv_net", p, s)
    w.conv("joint_net.conv_net.output_layer", p["Conv_0"])

    p, s = params["weight_net"], stats["weight_net"]
    w.conv("joint_net.weight_net.heatmap_feature_net.0", p["Conv_0"])
    w.bn("joint_net.weight_net.heatmap_feature_net.1", p["BatchNorm_0"],
         s["BatchNorm_0"])
    w.dense("joint_net.weight_net.output.0", p["Dense_0"])
    w.dense("joint_net.weight_net.output.2", p["Dense_1"])
    return w.out


def from_jax_backbone_variables(variables_np: Mapping[str, Any]
                                ) -> dict[str, torch.Tensor]:
    """flax {'params', 'batch_stats'} tree of the reference PoseResNet
    (numpy leaves) -> the port's PoseResNet state dict. Flax names: `conv1`,
    `bn1`, `layer{l}_{b}` with `conv{k}`, `bn{k}`, `down_conv`, `down_bn`;
    `deconv{i}`, `deconv_bn{i}`, `final_layer`; each BN holds a
    `BatchNorm_0`."""
    params, stats = variables_np["params"], variables_np["batch_stats"]
    w = _Writer()

    def conv(dst, src):
        w.put(f"{dst}.weight", _conv_w(np.asarray(src["kernel"])))

    def bn(dst, p, s):
        w.bn(dst, p["BatchNorm_0"], s["BatchNorm_0"])

    conv("conv1", params["conv1"])
    bn("bn1", params["bn1"], stats["bn1"])
    blocks = sorted((tuple(int(i) for i in k[5:].split("_")), k)
                    for k in params if k.startswith("layer"))
    for (li, bi), name in blocks:
        p, s, dst = params[name], stats[name], f"layer{li}.{bi}"
        for k in sorted(p):
            if k.startswith("conv"):
                conv(f"{dst}.{k}", p[k])
                bn(f"{dst}.bn{k[4:]}", p[f"bn{k[4:]}"], s[f"bn{k[4:]}"])
        if "down_conv" in p:
            conv(f"{dst}.downsample.0", p["down_conv"])
            bn(f"{dst}.downsample.1", p["down_bn"], s["down_bn"])
    di = 0
    while f"deconv{di}" in params:
        w.put(f"deconv_layers.{3 * di}.weight",
              _deconv_w(np.asarray(params[f"deconv{di}"]["kernel"])))
        bn(f"deconv_layers.{3 * di + 1}", params[f"deconv_bn{di}"],
           stats[f"deconv_bn{di}"])
        di += 1
    w.conv("final_layer", params["final_layer"])
    return w.out
