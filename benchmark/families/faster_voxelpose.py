"""The Faster-VoxelPose family: everything a run does that knows the
model. `fvpbench.spec` loads this file by the configuration's "family"
and the harness calls only the names below (the interface is listed in
`fvpbench/spec.py`).

The program is `fvp_torch.engine.serve.Predictor`, built on its normal
entry point `Predictor.from_state_dict`: images through the Pose-ResNet
backbone where the traffic sends images, then the HDN (`detect`:
whole-space volume, CenterNet, NMS top-K, C2CNet) and the JLN
(`localize`: person planes, P2PNet, soft-argmax, WeightNet's pool,
fusion). The plain reference is `reference/fvp.py`.

Weights are drawn on the run's device by a torch.Generator in one normal
and one uniform draw over all leaves (`fvpbench.traffic.draw`), then
scaled leaf by leaf:
- the task nets (after the program's `random_state_dict` of its smoke
  test): convs N(0, 0.03), the two score heads |N(0, 0.9)| (positive,
  so that the center and height scores are positive and their peaks
  distinct), WeightNet's layers U(+-1 / sqrt(fan in)), every 1-D leaf its
  init value (1 for a BatchNorm's gamma and running variance, else 0)
  plus U(0, 0.05); then CenterNet's score head is scaled so that the
  median confidence of the top-K proposals of the ring's first batch,
  worked out by the plain reference, equals the configuration's gate
  (`gate`): about half the slots of a frame pass it, whatever the seed;
- Pose-ResNet (the program's `seeded_state_dict`), drawn after the task
  nets and only where the traffic sends images: convs He-normal (a
  transposed conv's fan in is 4 Cin), BatchNorm gamma 1 + U(-0.1, 0.1)
  (x 0.25 on a residual branch's last BN), beta and running mean N(0,
  0.05), running variance 1 + U(0, 0.1), the 1x1 output conv N(0, 1 /
  Cin) with bias N(0, 0.1).

Operations and bytes (`model_flops`, `kernel_bounds`) follow
`fvpbench.counts`: the model's work counted on the reference nets, each
hand-written kernel's least time from its launch's shapes, copying the
arithmetic of the program's kernel study (`chip_smoke.py`: `bound`,
`nbytes`, `conv_flops`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from fvpbench.counts import (PEAK_BF16, PEAK_FP32, affine_flops, bound_ms,
                             flops, layer_work)
from fvpbench.judge import max_or_zero
from fvpbench.traffic import draw, stream_seed
from reference.fvp import Reference
from reference.geometry import Space, snap
from reference.nets import Bottleneck, FasterVoxelPose, PoseResNet

# what the harness copies back to the host after each call
OUTPUTS = ("fused_poses", "proposals", "mask")
# the methods the harness wraps in spans, as attribute paths from the
# predictor; the span takes the last name. JUDGED_STAGE's output on the
# judged slots goes to `slot_judge`, which holds it against the
# reference's heatmaps where the traffic sends images.
STAGES = ("heatmaps", "model.detect", "model.localize")
JUDGED_STAGE = "heatmaps"
# CUDA symbol -> the counters (fvp_torch.ops.kernels.all_kernels names)
# whose launches run it
SYMBOLS = {
    "whole_sample_kernel": ("whole_sample", "whole_sample.sum"),
    "person_layout_kernel": ("person_planes.layout",),
    "person_planes_kernel": ("person_planes",),
    "centernet_kernel": ("centernet",),
    "centernet_bf16_kernel": ("centernet_bf16",),
    "soft_argmax_kernel": ("soft_argmax",),
    "weightnet_pool_kernel": ("weightnet_pool",),
    "weightnet_pool_bf16_kernel": ("weightnet_pool_bf16",),
    "stem_kernel": ("stem",),
    "deconv_stage_kernel": ("deconv_stage",),
    "conv_wgmma_kernel": ("bottleneck_stage.wgmma", "p2pnet.conv.wgmma",
                          "centernet_bf16.conv.wgmma"),
    "conv_bf16_kernel": ("bottleneck_stage.wmma", "p2pnet.conv.wmma",
                         "centernet_bf16.conv.wmma"),
    "maxpool2_bf16_kernel": ("p2pnet.pool", "centernet_bf16.pool"),
    "c2cnet_kernel": ("c2cnet",),
}
HEADS = ("pose_net.center_net.output_hm.2.weight",
         "pose_net.c2c_net.output_hm.weight")


# ---------------------------------------------------------------- weights
def task_net_weights(J: int, feat: int, hidden: int, gen, device) -> dict:
    with torch.device("meta"):
        sd = FasterVoxelPose(J, feat, hidden).state_dict()
    shapes = {k: tuple(v.shape) for k, v in sd.items()}
    normal, uniform, heads = {}, {}, {}
    for k, shape in shapes.items():
        if k.endswith("num_batches_tracked"):
            continue
        if len(shape) >= 2 and "weight_net" in k:
            bound = 1.0 / np.sqrt(np.prod(shape[1:]))
            uniform[k] = (-bound, 2 * bound)
        elif k in HEADS:
            heads[k] = 0.9
        elif len(shape) >= 2:
            normal[k] = (0.0, 0.03)
        else:
            one = k.endswith("running_var") or k.endswith(".weight")
            uniform[k] = (float(one), 0.05)
    out = draw(shapes, {**normal, **{k: (0.0, v) for k, v in heads.items()}},
               uniform, gen, device)
    for k in heads:
        out[k] = out[k].abs()
    for k in shapes:
        if k.endswith("num_batches_tracked"):
            out[k] = torch.zeros((), dtype=torch.int64)
    return out


def backbone_weights(J: int, depth: int, gen, device) -> dict:
    with torch.device("meta"):
        net = PoseResNet(J, depth)
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    last = "bn3" if isinstance(net.layer1[0], Bottleneck) else "bn2"
    normal, uniform = {}, {}
    for k, shape in shapes.items():
        name = k.rsplit(".", 1)[0]
        if k.endswith("num_batches_tracked"):
            continue
        if len(shape) == 4:
            fan = 4 * shape[0] if name.startswith("deconv_layers") \
                else int(np.prod(shape[1:]))
            gain = 1.0 if name == "final_layer" else 2.0
            normal[k] = (0.0, float(np.sqrt(gain / fan)))
        elif name == "final_layer":
            normal[k] = (0.0, 0.1)
        elif k.endswith(".weight"):
            g = 0.25 if name.endswith(last) else 1.0
            uniform[k] = (0.9 * g, 0.2 * g)
        elif k.endswith("running_var"):
            uniform[k] = (1.0, 0.1)
        else:
            normal[k] = (0.0, 0.05)
    out = draw(shapes, normal, uniform, gen, device)
    for k in shapes:
        if k.endswith("num_batches_tracked"):
            out[k] = torch.zeros((), dtype=torch.int64)
    return out


def weights(config: dict, seed: int, device, backbone: bool) -> tuple:
    """(task nets' state dict, backbone's or None), float32 on the host,
    drawn on `device` from `seed`; the backbone only where `backbone` (the
    traffic sends images) and the configuration has one."""
    cfg = config["config"]
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, 0))
    J = cfg["num_joints"]
    sd = task_net_weights(J, cfg["num_channel_joint_feat"],
                          cfg["num_channel_joint_hidden"], gen, device)
    bb = None
    if backbone and cfg["backbone"]:
        bb = backbone_weights(J, cfg["resnet_layers"], gen, device)
    host = [{k: v.cpu() for k, v in d.items()} if d is not None else None
            for d in (sd, bb)]
    return host[0], host[1]


def gate(config: dict, weights: tuple, rig: dict, first: torch.Tensor,
         device) -> float:
    """Scale CenterNet's score head (weight and bias, in the task nets'
    state dict) so that the median of the plain reference's top-K
    confidences on the batch `first` equals the configuration's gate;
    returns the scale."""
    cfg = config["config"]
    sd, bb = weights
    ref = reference(config, rig, weights, device)
    x = first.to(device)
    hm = ref.heatmaps(x) if bb is not None else x
    vol = ref.volume(hm)
    hm2d, _ = ref.center(vol)
    vals, flat = ref.nms_topk(hm2d, cfg["max_people"])
    conf = vals * ref.heights(vol, flat).amax(dim=2)
    scale = float(cfg["min_score"]) / float(conf.median())
    for k in ("weight", "bias"):
        sd[f"pose_net.center_net.output_hm.2.{k}"] *= scale
    return scale


# ------------------------------------------------- the program, the reference
def predictor(config: dict, weights: tuple, rig: dict, device):
    """The program on its normal entry point."""
    from fvp_torch.config import FVPConfig
    from fvp_torch.engine.serve import Predictor
    from fvp_torch.geometry.cameras import CameraRig

    sd, bb = weights
    cfg = FVPConfig(**{k: tuple(v) if isinstance(v, list) else v
                       for k, v in config["config"].items()})
    return Predictor.from_state_dict(cfg, sd, CameraRig(**rig),
                                     device=device, backbone_state_dict=bb)


def reference(config: dict, rig: dict, weights: tuple, device,
              fmt: str = "fp32") -> Reference:
    """The plain reference on the same weights, computing in `fmt`."""
    sd, bb = weights
    return Reference.from_config(config["config"], rig, sd, bb, device, fmt)


def judge_heatmaps(hm_prog: torch.Tensor, hm_ref: torch.Tensor) -> float:
    """Worst frame's ||prog - ref|| / ||ref|| over its views' maps."""
    B = hm_ref.shape[0]
    d = (hm_prog.float() - hm_ref).reshape(B, -1).norm(dim=1)
    return max_or_zero(d / hm_ref.reshape(B, -1).norm(dim=1).clamp(min=1e-30))


class SlotJudge:
    """The reference's HDN maps of one slot's heatmaps, then each answer
    of that slot judged against them. Stage by stage, as a served model's
    tokens are judged on the reference run over them, the reference reads
    the program's own output of the stage before:
    - heatmaps, where the traffic sends images (the reference has a
      backbone): the program's (`kept`, its `heatmaps` on the slot)
      against the reference's from the same images, the number
      `heatmaps` in `stage`; the frame is the heatmaps otherwise, and
      `stage` is empty;
    - HDN: on the program's heatmaps, each proposal the program made is
      held against the reference's BEV heatmap, heights and bbox sizes at
      the program's picks;
    - JLN: on the program's heatmaps and proposals, the program's fused
      joints and JLN scores against the reference's.
    Numbers: `hdn` (the worst pick gap, height gap, gate margin, score or
    bbox error, a share of the reference's own scale), `pose_mm` (the
    worst kept joint's distance), `jln_conf` (the worst kept score's
    error, a share) and `exact` (answers that break an exact rule: zeroed
    joints, the gate and score columns, picks on the voxel grid and
    distinct)."""

    def __init__(self, ref, frame: torch.Tensor, kept):
        if ref.backbone is not None:
            if kept is None:
                raise RuntimeError("no heatmaps kept for a judged slot")
            hm = kept
            self.stage = {"heatmaps": judge_heatmaps(hm, ref.heatmaps(frame))}
        else:
            hm, self.stage = frame, {}
        self.ref, self.hm = ref, hm
        s = ref.s
        self.vol = ref.volume(hm)
        self.hm2d, self.bbox = ref.center(self.vol)
        self.top, _ = ref.nms_topk(self.hm2d, s.max_people)
        B, X, Y = self.hm2d.shape
        self.peak = F.max_pool2d(self.hm2d[:, None], 3, 1, 1)[:, 0] \
            .reshape(B, -1)
        self.scale2d = self.hm2d.reshape(B, -1).abs().amax(dim=1)
        self.scale_bb = self.bbox.reshape(B, -1).abs().amax(dim=1)
        self._jln = []

    def _localize(self, proposals: torch.Tensor):
        for prev, out in self._jln:
            if torch.equal(prev, proposals):
                return out
        out = self.ref.localize(self.hm, proposals)
        self._jln.append((proposals, out))
        return out

    def judge(self, out: dict) -> dict:
        ref, s = self.ref, self.ref.s
        dev = self.hm2d.device
        prop = out["proposals"].to(dev).float()
        fused = out["fused_poses"].to(dev).float()
        mask = out["mask"].to(dev)
        B, K = prop.shape[:2]
        X, Y, Z = s.voxels_per_axis
        exact = 0
        # the picks: voxel indices of the proposal centers
        fidx = (prop[..., 0:3] - ref.vox_bias) / ref.vox_scale
        idx = torch.round(fidx).to(torch.int64)
        exact += int((ref.to_mm(idx) - prop[..., 0:3]).abs()
                     .gt(1e-3).any(dim=2).sum())
        lim = torch.tensor([X, Y, Z], device=dev)
        inside = ((idx >= 0) & (idx < lim)).all(dim=2)
        exact += int((~inside).sum())
        idx = torch.minimum(idx.clamp(min=0), lim - 1)
        flat = idx[..., 0] * Y + idx[..., 1]
        exact += sum(int(K - torch.unique(flat[b]).numel())
                     for b in range(B))
        # the rules of the answer's own columns
        exact += int((prop[..., 3] != mask.float() - 1.0).sum())
        exact += int((fused[..., 3] != prop[..., None, 3]).sum())
        exact += int((fused[..., 4] != prop[..., None, 4]).sum())
        exact += int((fused[..., 0:3][~mask] != 0).sum())

        # HDN: BEV picks, heights, gate, scores and sizes
        score = torch.gather(self.hm2d.reshape(B, -1), 1, flat)
        gap2d = torch.maximum(self.top - score,
                              torch.gather(self.peak, 1, flat) - score)
        hdn = [gap2d / self.scale2d[:, None].clamp(min=1e-30)]
        h1 = ref.heights(self.vol, flat)                      # (B, K, Z)
        h1_pick = torch.gather(h1, 2, idx[..., 2:3])[..., 0]
        scale1d = h1.reshape(B, -1).abs().amax(dim=1)[:, None]
        hdn.append((h1.amax(dim=2) - h1_pick) / scale1d.clamp(min=1e-30))
        conf = score * h1_pick
        cscale = conf.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
        flip = mask != (conf > s.min_score)
        hdn.append(torch.where(flip, (conf - s.min_score).abs() / cscale,
                               torch.zeros_like(conf)))
        hdn.append(torch.where(mask, torch.zeros_like(conf),
                               (prop[..., 4] - conf).abs() / cscale))
        box = torch.gather(self.bbox.reshape(B, X * Y, 2), 1,
                           flat[..., None].expand(-1, -1, 2))
        hdn.append((prop[..., 5:7] - box).abs().amax(dim=2)
                   / self.scale_bb[:, None].clamp(min=1e-30))

        # JLN on the program's proposals
        ref_joints, ref_conf = self._localize(prop)
        d = (fused[..., 0:3] - ref_joints).norm(dim=3).amax(dim=2)
        jscale = ref_conf.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
        jerr = (prop[..., 4] - ref_conf).abs() / jscale
        worst = [max_or_zero(t) for t in hdn]
        return {"hdn": max(worst),
                "pose_mm": max_or_zero(d[mask]),
                "jln_conf": max_or_zero(jerr[mask]),
                "exact": float(exact),
                "parts": dict(zip(("bev_gap", "height_gap", "gate", "score",
                                   "bbox"), worst))}


slot_judge = SlotJudge


# ------------------------------------------------ operations and bytes
def sampled_people(run) -> list:
    """(cropped voxels, people sampled) of each batch's person cubes:
    the kept people whose crop is not empty."""
    props = torch.stack([o["proposals"] for _, o in run.outputs])
    s = Space.from_config(run.config["config"])
    flat = props.reshape(-1, 7).float()
    _, start, end, alive, _ = snap(s, flat[:, 0:3], flat[:, 5:7])
    live = alive & (flat[:, 3] >= 0)
    vox = torch.prod((end - start).clamp(min=0).double(), dim=1) * live
    per = props.shape[1] * props.shape[2]
    return [(float(v), int(n)) for v, n in zip(
        vox.reshape(-1, per).sum(dim=1), live.reshape(-1, per).sum(dim=1))]


def _nets(cfg: dict):
    with torch.device("meta"):
        m = FasterVoxelPose(cfg["num_joints"], cfg["num_channel_joint_feat"],
                            cfg["num_channel_joint_hidden"])
    return m.pose_net.center_net, m.pose_net.c2c_net, \
        m.joint_net.conv_net, m.joint_net.weight_net


def model_flops(config: dict, backbone: bool) -> dict:
    """{"backbone", "hdn", "jln", "frame"}: operations of one frame; the
    backbone's only where `backbone` (the traffic sends images)."""
    cfg = config["config"]
    s = Space.from_config(cfg)
    J, V, K = s.num_joints, s.num_views, s.max_people
    X, Y, Z = s.voxels_per_axis
    n = s.ind_voxels_per_axis[0]
    center, c2c, p2p, wnet = _nets(cfg)
    out = {"backbone": 0.0}
    if backbone and cfg["backbone"]:
        with torch.device("meta"):
            bb = PoseResNet(J, cfg["resnet_layers"])
        w, h = s.image_size
        out["backbone"] = V * flops(layer_work(bb, (1, 3, h, w)))
    out["hdn"] = flops(layer_work(center, (1, J, X, Y))) \
        + K * flops(layer_work(c2c, (1, J, Z)))
    out["jln"] = 3 * K * (flops(layer_work(p2p, (1, J, n, n)))
                          + flops(layer_work(wnet, (1, J, n, n))))
    out["frame"] = out["backbone"] + out["hdn"] + out["jln"]
    return out


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


def kernel_bounds(config: dict, batch: int, people: list,
                  backbone: bool) -> dict:
    """{kernel name: (launches a batch, least ms of all its launches)}
    for the kernels on this configuration's path, over batches of `batch`
    frames whose person cubes are `people` (`sampled_people`: cropped
    voxels, people sampled, a batch), on which person_planes' work
    depends; the backbone's kernels only where `backbone`."""
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
        B * affine_flops(cn_rows), PEAK_BF16 if bf16 else PEAK_FP32))
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
    if backbone and cfg["backbone"]:
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
