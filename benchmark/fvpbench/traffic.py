"""Inputs and weights from a seed: the one generator every traffic mix
goes through.

Weights are drawn on the run's device by a torch.Generator in one normal
and one uniform draw over all leaves, then scaled leaf by leaf:
- the task nets (after the program's `random_state_dict` of its smoke
  test): convs N(0, 0.03), the two score heads |N(0, 0.9)| (positive,
  so that the center and height scores are positive and their peaks
  distinct), WeightNet's layers U(+-1 / sqrt(fan in)), every 1-D leaf its
  init value (1 for a BatchNorm's gamma and running variance, else 0)
  plus U(0, 0.05); then CenterNet's score head is scaled so that the
  median confidence of the top-K proposals of the ring's first batch,
  worked out by the plain reference, equals the configuration's gate
  (`gate_scores`): about half the slots of a frame pass it, whatever the
  seed;
- Pose-ResNet (the program's `seeded_state_dict`): convs He-normal
  (a transposed conv's fan in is 4 Cin), BatchNorm gamma 1 + U(-0.1,
  0.1) (x 0.25 on a residual branch's last BN), beta and running mean
  N(0, 0.05), running variance 1 + U(0, 0.1), the 1x1 output conv N(0,
  1 / Cin) with bias N(0, 0.1).
Frames are drawn on the device too and held in host memory, as a caller
holds decoded frames: images are smooth random colour fields plus pixel
noise, normalized with ImageNet's mean and std; heatmaps are Gaussian
blobs (sigma in heatmap pixels) at the projections of skeletons standing
in the space, over a faint random background.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from reference import geometry as geo
from reference.nets import Bottleneck, FasterVoxelPose, PoseResNet

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
HEADS = ("pose_net.center_net.output_hm.2.weight",
         "pose_net.c2c_net.output_hm.weight")


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one stream of draws (weights, frames, choices)."""
    return (int(seed) * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9) \
        % (2 ** 63)


def _draw(shapes: dict, normal: dict, uniform: dict, gen, device) -> dict:
    """{key: tensor}: each normal leaf std * N(0, 1), each uniform leaf lo
    + (hi - lo) * U(0, 1), from one draw of each kind."""
    def sizes(keys):
        return [int(np.prod(shapes[k])) for k in keys]

    out = {}
    for spec, fill in ((normal, "normal"), (uniform, "uniform")):
        keys = list(spec)
        if not keys:
            continue
        flat = torch.empty(sum(sizes(keys)), device=device)
        if fill == "normal":
            flat.normal_(generator=gen)
        else:
            flat.uniform_(generator=gen)
        for k, part in zip(keys, torch.split(flat, sizes(keys))):
            a, b = spec[k]
            out[k] = (a + b * part).reshape(shapes[k])
    return out


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
    out = _draw(shapes, {**normal, **{k: (0.0, v) for k, v in heads.items()}},
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
    out = _draw(shapes, normal, uniform, gen, device)
    for k in shapes:
        if k.endswith("num_batches_tracked"):
            out[k] = torch.zeros((), dtype=torch.int64)
    return out


def seeded_weights(config: dict, seed: int, device) -> tuple:
    """(task nets' state dict, backbone's or None), float32 on the host,
    drawn on `device` from `seed`."""
    cfg = config["config"]
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, 0))
    J = cfg["num_joints"]
    sd = task_net_weights(J, cfg["num_channel_joint_feat"],
                          cfg["num_channel_joint_hidden"], gen, device)
    bb = None
    if cfg["backbone"]:
        bb = backbone_weights(J, cfg["resnet_layers"], gen, device)
    host = [{k: v.cpu() for k, v in d.items()} if d is not None else None
            for d in (sd, bb)]
    return host[0], host[1]


def gate_scores(config: dict, sd: dict, bb: dict | None, rig: dict,
                first: torch.Tensor, device) -> float:
    """Scale CenterNet's score head (weight and bias, in `sd`) so that the
    median of the plain reference's top-K confidences on the batch
    `first` equals the configuration's gate; returns the scale."""
    from reference.fvp import Reference

    cfg = config["config"]
    ref = Reference.from_config(cfg, rig, sd, bb, device)
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


def rig_of(config: dict) -> dict:
    cfg, r = config["config"], config["assumed"]["rig"]
    return geo.ring_rig(cfg["num_views"], cfg["space_center"],
                        cfg["ori_image_size"], r["radius"], r["height"],
                        r["focal"], r["seed"])


def _images(gen, n: int, w: int, h: int, device) -> torch.Tensor:
    low = torch.rand((n, 3, max(h // 16, 1), max(w // 16, 1)),
                     generator=gen, device=device)
    img = F.interpolate(low, size=(h, w), mode="bilinear",
                        align_corners=False)
    img = img + 0.05 * torch.randn(img.shape, generator=gen, device=device)
    mean = torch.tensor(MEAN, device=device)[:, None, None]
    std = torch.tensor(STD, device=device)[:, None, None]
    img = (img.clamp(0.0, 1.0) - mean) / std
    return img.permute(0, 2, 3, 1).contiguous()


def _skeletons(rng, people: int, template: np.ndarray, cfg: dict,
               spread: float) -> np.ndarray:
    """(people, J, 3) mm: the template turned about z, standing at random
    places within `spread` mm of the space's center, each joint jittered
    by N(0, 30 mm)."""
    out = []
    cx, cy = cfg["space_center"][:2]
    for _ in range(people):
        a = rng.uniform(0, 2 * np.pi)
        rot = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                        [0, 0, 1]])
        root = np.array([cx + rng.uniform(-spread, spread),
                         cy + rng.uniform(-spread, spread), 0.0])
        out.append(template @ rot.T + root
                   + rng.normal(0, 30.0, template.shape))
    return np.stack(out)


def _heatmaps(gen, rng, counts, config: dict, rig: dict, device
              ) -> torch.Tensor:
    """(F, V, J, H, W) heatmaps of frames with counts[f] people each."""
    cfg, assumed = config["config"], config["assumed"]
    space = geo.Space.from_config(cfg)
    V, J = cfg["num_views"], cfg["num_joints"]
    w, h = cfg["heatmap_size"]
    sigma = float(cfg["sigma"])
    template = np.asarray(assumed["skeleton_mm"], np.float64)
    hm_t = geo.heatmap_transform(space)
    n = len(counts)
    P = max(counts)
    px = np.full((n, V, P, J, 2), -1e4, np.float32)   # absent: far away
    for f, c in enumerate(counts):
        joints = _skeletons(rng, c, template, cfg,
                            assumed["people_spread_mm"]).reshape(-1, 3)
        for v in range(V):
            uv = geo.affine(geo.project_np(joints, geo.camera(rig, v)), hm_t)
            px[f, v, :c] = uv.reshape(c, J, 2)
    px = torch.from_numpy(px).to(device)
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    out = 0.02 * torch.rand((n, V, J, h, w), generator=gen, device=device)
    for p in range(P):
        u = px[:, :, p, :, 0, None, None]
        v = px[:, :, p, :, 1, None, None]
        g = torch.exp(-((xx - u) ** 2 + (yy - v) ** 2) / (2 * sigma ** 2))
        out = torch.maximum(out, g)
    return out


def frame_ring(config: dict, traffic: dict, rig: dict, seed: int,
               device) -> list:
    """The mix's ring of distinct input batches, as host tensors: images
    (B, V, H, W, 3) or heatmaps (B, V, J, H, W)."""
    cfg = config["config"]
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, 1))
    rng = np.random.default_rng(stream_seed(seed, 2))
    B, R = traffic["batch"], traffic["ring"]
    ring = []
    if traffic["input"] == "images":
        w, h = cfg["image_size"]
        for _ in range(R):
            x = _images(gen, B * cfg["num_views"], w, h, device)
            ring.append(x.reshape(B, cfg["num_views"], h, w, 3).cpu())
        return ring
    if traffic["input"] != "heatmaps":
        raise ValueError(f"traffic input {traffic['input']!r}: 'images' "
                         "or 'heatmaps'")
    lo, hi = traffic["people"]
    counts = [lo + i % (hi - lo + 1) for i in range(R * B)]
    counts = [counts[i] for i in rng.permutation(len(counts))]
    for r in range(R):
        ring.append(_heatmaps(gen, rng, counts[r * B:(r + 1) * B], config,
                              rig, device).cpu())
    return ring


def judged_slots(traffic: dict, seed: int) -> list:
    """The ring slots whose answers a run compares, drawn from the seed."""
    rng = np.random.default_rng(stream_seed(seed, 3))
    return sorted(int(r) for r in rng.choice(
        traffic["ring"], size=traffic["judged"], replace=False))
