"""Operations and bytes, counted from the configuration's shapes.

`model_flops` is the model's work on one frame (2 per multiply-add of
every conv and linear layer), whatever implements it: the reference nets
run on the meta device with a hook on each layer. `kernel_bounds` is the
least time of each hand-written kernel's launches in one batch at the
published peaks of one H100 SXM (NVIDIA's data sheet, dense): the larger
of its bytes (each input byte read once, each output byte written once)
over 3.35 TB/s and its operations over 989 TFLOP/s (bf16 on the tensor
cores) or 67 TFLOP/s (float32). The counts copy the arithmetic of the
program's kernel study (`chip_smoke.py`: `bound`, `nbytes`,
`conv_flops`).
"""

from __future__ import annotations

import torch
from torch import nn

from reference.geometry import Space
from reference.nets import FasterVoxelPose, PoseResNet

PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAKS = {"float32": PEAK_FP32, "bfloat16": PEAK_BF16}


def layer_work(net: nn.Module, *shapes) -> list:
    """[(kind, macs, out_elems, weight_elems)] of every conv and linear
    layer of `net` run on meta tensors of `shapes`, in call order."""
    rows = []

    def hook(m, inp, out):
        x = inp[0]
        w = m.weight
        if isinstance(m, nn.Linear):
            macs = out.numel() * w.shape[1]
        elif isinstance(m, (nn.ConvTranspose1d, nn.ConvTranspose2d)):
            macs = x.numel() * w[0].numel()
        else:
            macs = out.numel() * w[0].numel()
        rows.append((type(m).__name__, macs, out.numel(), w.numel()))

    with torch.device("meta"):
        net = net.to("meta").eval()
        handles = [m.register_forward_hook(hook) for m in net.modules()
                   if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d,
                                     nn.ConvTranspose1d,
                                     nn.ConvTranspose2d))]
        with torch.no_grad():
            net(*(torch.empty(s) for s in shapes))
        for h in handles:
            h.remove()
    return rows


def _flops(rows) -> float:
    return 2.0 * sum(r[1] for r in rows)


def _nets(cfg: dict):
    with torch.device("meta"):
        m = FasterVoxelPose(cfg["num_joints"], cfg["num_channel_joint_feat"],
                            cfg["num_channel_joint_hidden"])
    return m.pose_net.center_net, m.pose_net.c2c_net, \
        m.joint_net.conv_net, m.joint_net.weight_net


def model_flops(config: dict) -> dict:
    """{"backbone", "hdn", "jln", "frame"}: operations of one frame."""
    cfg = config["config"]
    s = Space.from_config(cfg)
    J, V, K = s.num_joints, s.num_views, s.max_people
    X, Y, Z = s.voxels_per_axis
    n = s.ind_voxels_per_axis[0]
    center, c2c, p2p, wnet = _nets(cfg)
    out = {"backbone": 0.0}
    if cfg["backbone"]:
        with torch.device("meta"):
            bb = PoseResNet(J, cfg["resnet_layers"])
        w, h = s.image_size
        out["backbone"] = V * _flops(layer_work(bb, (1, 3, h, w)))
    out["hdn"] = _flops(layer_work(center, (1, J, X, Y))) \
        + K * _flops(layer_work(c2c, (1, J, Z)))
    out["jln"] = 3 * K * (_flops(layer_work(p2p, (1, J, n, n)))
                          + _flops(layer_work(wnet, (1, J, n, n))))
    out["frame"] = out["backbone"] + out["hdn"] + out["jln"]
    return out


def bound_ms(nbytes: float, flops: float, peak: float) -> float:
    return max(nbytes / PEAK_BYTES, flops / peak) * 1e3


def _affine_flops(rows) -> float:
    """2 per multiply-add and 2 per output (the folded BN's affine), as
    the kernel study counts a conv."""
    return sum(2.0 * r[1] + 2.0 * r[2] for r in rows)


def planes_bound_ms(config: dict, batch: int, voxels: float,
                    live: int) -> float:
    """person_planes on one batch: it reads the pixel-major heatmaps and
    writes the planes of the `live` people it samples; each of their
    `voxels` cropped voxels is projected into every view (45 operations)
    and sampled bilinearly for every joint (8), then maxed into three
    planes (5 a joint)."""
    s = Space.from_config(config["config"])
    J, V, n = s.num_joints, s.num_views, s.ind_voxels_per_axis[0]
    w, h = s.heatmap_size
    JP = (J + 3) // 4 * 4
    return bound_ms(batch * V * h * w * JP * 4 + live * 3 * n * n * J * 4,
                    voxels * V * (45.0 + J * 8.0) + voxels * J * 5.0,
                    PEAK_FP32)


def kernel_bounds(config: dict, batch: int, people: list) -> dict:
    """{kernel name: (launches a batch, least ms of all its launches)}
    for the kernels on this configuration's path, over batches of `batch`
    frames whose person cubes are `people`: (cropped voxels, people
    sampled) a batch, on which person_planes' work depends."""
    cfg = config["config"]
    s = Space.from_config(cfg)
    B, J, V, K = batch, s.num_joints, s.num_views, s.max_people
    w, h = s.heatmap_size
    X, Y, Z = s.voxels_per_axis
    N = X * Y * Z
    n = s.ind_voxels_per_axis[0]
    JP = (J + 3) // 4 * 4
    bf16 = cfg["compute_dtype"] == "bfloat16"
    P = B * K
    hm_bytes = B * V * J * h * w * 4
    center, _, _, _ = _nets(cfg)
    cn_rows = layer_work(center, (1, J, X, Y))
    cn_w = sum(r[3] for r in cn_rows) * (2 if bf16 else 4)
    out = {
        "whole_sample": (1, bound_ms(hm_bytes + V * 2 * N * 4 + B * N * J * 4,
                                 B * (N * J * V * 8.0 + N * J * 2.0),
                                 PEAK_FP32)),
        "person_planes.layout": (1, bound_ms(
            hm_bytes + B * V * h * w * JP * 4, 0.0, PEAK_FP32)),
        "person_planes": (1, sum(planes_bound_ms(config, B, v, n)
                                 for v, n in people)),
        "soft_argmax": (1, bound_ms(
            3 * P * n * n * J * 4 + 3 * n * n * 2 * 4 + 3 * P * J * 2 * 4
            + P * 4, 3 * P * n * n * J * 8.0, PEAK_FP32)),
    }
    out["centernet_bf16" if bf16 else "centernet"] = (1, bound_ms(
        B * X * Y * J * 4 + 3 * B * X * Y * 4 + cn_w,
        B * _affine_flops(cn_rows), PEAK_BF16 if bf16 else PEAK_FP32))
    C = cfg["num_channel_joint_feat"]
    maps = 3 * P * J
    if bf16:
        out["weightnet_pool_bf16"] = (1, bound_ms(
            maps * n * n * 4 + maps * C * 4, maps * n * n * C * 9 * 2.0,
            PEAK_BF16))
    else:
        out["weightnet_pool"] = (1, bound_ms(
            maps * n * n * 4 + maps * C * 4,
            maps * n * n * C * (9 * 2.0 + 2) + maps * C * 2.0, PEAK_FP32))
    if cfg["backbone"]:
        out.update(_backbone_bounds(cfg, B * V, bf16))
    return {k: (n, ms if k == "person_planes" else ms * len(people))
            for k, (n, ms) in out.items()}


def _backbone_bounds(cfg: dict, images: int, bf16: bool) -> dict:
    """The stem, the bottleneck stage on layer1 (bf16 only) and the three
    deconv stages, for `images` images."""
    W, H = cfg["image_size"]
    hc, wc = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    hp, wp = (hc - 1) // 2 + 1, (wc - 1) // 2 + 1
    out = {"stem": (1, bound_ms(
        images * H * W * 3 * 4 + images * hp * wp * 64 * 2
        + 7 * 7 * 3 * 64 * 2, images * hc * wc * 64 * (2.0 * 7 * 7 * 3 + 2),
        PEAK_BF16))}
    M = images * hp * wp
    if bf16:
        total, cin = 0.0, 64
        for b in range(3):
            convs = [(cin, 64, 1, False), (64, 64, 3, False),
                     (64, 256, 1, True)]
            if b == 0:
                convs.append((cin, 256, 1, False))
            for ci, co, k, res in convs:
                nbytes = M * ci * 2 + k * k * ci * co * 2 + M * co * 2 \
                    + (M * co * 2 if res else 0)
                total += bound_ms(nbytes, M * co * (2.0 * k * k * ci + 2),
                                  PEAK_BF16)
            cin = 256
        out["bottleneck_stage.wgmma"] = (10, total)
    total, c, hh, ww = 0.0, 2048, hp // 8, wp // 8
    for _ in range(3):
        outs = images * 4 * hh * ww * 256
        total += bound_ms(images * hh * ww * c * 2 + 16 * c * 256 * 2
                          + outs * 2, outs * (2.0 * 4 * c + 2), PEAK_BF16)
        c, hh, ww = 256, 2 * hh, 2 * ww
    out["deconv_stage"] = (3, total)
    return out
