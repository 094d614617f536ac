"""Input-heatmap rendering: 2D joint gaussians at working resolution.

A numpy copy of the reference package's `data/heatmaps.py` (after the
original implementation's lib/dataset/JointsDataset.py:265-446). Used by
the 'gt' and 'pred' heatmap sources (the reference's de-facto mock
backbone): scale-adaptive sigma from the person's 2D extent, windowed
gaussian splats combined by max, optional heatmap-level augmentation
(random per-joint peak scaling with wrist/ankle-specific drop rates +
random rectangular occlusion).

The port renders on the host with this numpy path only; on the device,
ops/heatmap_render.py computes the same maps from the render parameters.
"""

from __future__ import annotations

import numpy as np

from fvp_torch.config import FVPConfig


def compute_human_scale(pose: np.ndarray, joints_vis: np.ndarray) -> float:
    idx = joints_vis > 0.1
    if np.sum(idx) == 0:
        return 0.0
    minx, maxx = np.min(pose[idx, 0]), np.max(pose[idx, 0])
    miny, maxy = np.min(pose[idx, 1]), np.max(pose[idx, 1])
    return float(np.clip(np.maximum(maxy - miny, maxx - minx) ** 2,
                         1.0 / 4 * 96 ** 2, 4 * 96 ** 2))


def generate_input_heatmap(cfg: FVPConfig, joints, joints_vis=None,
                           augment: bool = False,
                           rng: np.random.RandomState | None = None,
                           draws=None) -> np.ndarray:
    """joints: list of (J, >=2) arrays in WORKING-image pixel coords.
    Returns (J, hm_h, hm_w) float32.

    draws: optional pre-drawn augmentation parameters
    (scale (P, J) float, occ (P, J, 4) int [y0, y1, x0, x1)) — used by the
    device-renderer parity tests to feed both implementations identical
    randomness."""
    if rng is None:
        rng = np.random
    num_joints = joints[0].shape[0]
    hm_w, hm_h = cfg.heatmap_size
    target = np.zeros((num_joints, hm_h, hm_w), np.float32)
    feat_stride = np.asarray(cfg.image_size) / np.asarray(cfg.heatmap_size)

    for n in range(len(joints)):
        human_scale = 2 * compute_human_scale(
            joints[n][:, :2] / feat_stride, np.ones(num_joints))
        if human_scale == 0:
            continue

        cur_sigma = cfg.sigma * np.sqrt(human_scale / (96.0 * 96.0))
        tmp_size = cur_sigma * 3
        for j in range(num_joints):
            if joints_vis is not None and joints_vis[n][j] == 0:
                continue
            mu_x = int(joints[n][j][0] / feat_stride[0])
            mu_y = int(joints[n][j][1] / feat_stride[1])
            ul = [int(mu_x - tmp_size), int(mu_y - tmp_size)]
            br = [int(mu_x + tmp_size + 1), int(mu_y + tmp_size + 1)]
            if ul[0] >= hm_w or ul[1] >= hm_h or br[0] < 0 or br[1] < 0:
                continue

            # note: `size` stays float, matching the reference's arange/floor
            # arithmetic exactly (JointsDataset.py:406-409)
            size = 2 * tmp_size + 1
            x = np.arange(0, size, 1, np.float32)
            y = x[:, np.newaxis]
            x0 = y0 = size // 2
            g = np.exp(-((x - x0) ** 2 + (y - y0) ** 2)
                       / (2 * cur_sigma ** 2))

            if augment:
                if draws is not None:
                    scale = draws[0][n, j]
                    start = [int(draws[1][n, j, 0]), int(draws[1][n, j, 2])]
                    end = [int(draws[1][n, j, 1]), int(draws[1][n, j, 3])]
                else:
                    # gates draw from `rng` (not the global `random`
                    # module) so a seeded caller gets deterministic
                    # augmentation
                    scale = (0.9 + rng.randn(1) * 0.03
                             if rng.random_sample() < 0.6 else 1.0)
                    if j in (7, 8):           # wrist group
                        scale = (scale * 0.5 if rng.random_sample() < 0.1
                                 else scale)
                    elif j in (9, 10):        # ankle group
                        scale = (scale * 0.2 if rng.random_sample() < 0.1
                                 else scale)
                    else:
                        scale = (scale * 0.5 if rng.random_sample() < 0.05
                                 else scale)
                    start = [int(rng.uniform(0, hm_h - 1)),
                             int(rng.uniform(0, hm_w - 1))]
                    end = [int(min(start[0] + rng.uniform(
                        hm_h / 4, hm_h * 0.75), hm_h)),
                        int(min(start[1] + rng.uniform(
                            hm_w / 4, hm_w * 0.75), hm_w))]
                g = g * scale
                g[start[0]:end[0], start[1]:end[1]] = 0.0

            g_x = max(0, -ul[0]), min(br[0], hm_w) - ul[0]
            g_y = max(0, -ul[1]), min(br[1], hm_h) - ul[1]
            img_x = max(0, ul[0]), min(br[0], hm_w)
            img_y = max(0, ul[1]), min(br[1], hm_h)
            target[j][img_y[0]:img_y[1], img_x[0]:img_x[1]] = np.maximum(
                target[j][img_y[0]:img_y[1], img_x[0]:img_x[1]],
                g[g_y[0]:g_y[1], g_x[0]:g_x[1]])
        target = np.clip(target, 0, 1)

    return target
