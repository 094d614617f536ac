"""Inputs from a seed: the one generator every traffic mix goes through,
and the seeded draw that each family's weights go through.

Frames are drawn on the device and held in host memory, as a caller
holds decoded frames: images are smooth random colour fields plus pixel
noise, normalized with ImageNet's mean and std; heatmaps are Gaussian
blobs (sigma in heatmap pixels) at the projections of skeletons standing
in the space, over a faint random background. Weights are drawn on the
run's device by `draw` from stream 0 of the seed, in the order and with
the scales that the configuration's family (`families/<family>.py`)
gives.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from reference import geometry as geo

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one stream of draws (weights, frames, choices)."""
    return (int(seed) * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9) \
        % (2 ** 63)


def draw(shapes: dict, normal: dict, uniform: dict, gen, device) -> dict:
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
