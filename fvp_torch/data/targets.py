"""Training-target generation (host side, numpy).

A numpy copy of the reference package's `data/targets.py` (after the
original implementation's lib/dataset/JointsDataset.py:281-366).
Produces fixed-shape (max_people-padded) arrays ready for device transfer:
BEV 2D gaussian heatmap (sigma 200 mm), per-person 1D z gaussians, the GT
center cell index + sub-cell offset, and bbox sizes normalized by the
individual space. The `mask` preserves the reference's `arange <= num_people`
off-by-one quirk (it selects one padding row), because trained behavior
depends on it.
"""

from __future__ import annotations

import numpy as np

from fvp_torch.config import FVPConfig


def root_center(pose: np.ndarray, root_id) -> np.ndarray:
    ids = list(root_id) if not isinstance(root_id, int) else [root_id]
    return np.mean([pose[j] for j in ids], axis=0)


def generate_target(cfg: FVPConfig, joints_3d, joints_3d_vis) -> dict:
    """joints_3d: list/array of (J, 3) mm poses; joints_3d_vis: (J,) flags.

    Returns dict of numpy arrays:
      index (maxP,), offset (maxP, 2), bbox (maxP, 2),
      2d_heatmaps (X, Y), 1d_heatmaps (maxP, Z), mask (maxP,)
    """
    num_people = len(joints_3d)
    space = np.asarray(cfg.space_size)
    center = np.asarray(cfg.space_center)
    ind_space = np.asarray(cfg.ind_space_size)
    vox = np.asarray(cfg.voxels_per_axis)
    voxel_size = space / (vox - 1)
    maxp = cfg.max_people

    grid1d = [np.linspace(-space[a] / 2, space[a] / 2, vox[a]) + center[a]
              for a in range(3)]

    target_index = np.zeros(maxp)
    target_2d = np.zeros((vox[0], vox[1]), np.float32)
    target_1d = np.zeros((maxp, vox[2]), np.float32)
    target_bbox = np.zeros((maxp, 2), np.float32)
    target_offset = np.zeros((maxp, 2), np.float32)
    sigma = 200.0

    for n in range(num_people):
        pose = np.asarray(joints_3d[n])
        vis_idx = np.asarray(joints_3d_vis[n]) > 0.1
        cpos = root_center(pose, cfg.root_joint_id)

        loc = (cpos - center + 0.5 * space) / voxel_size
        if np.any(loc < 0) or np.any(loc > vox):
            raise ValueError("human center out of the capture space")
        target_index[n] = (loc // 1)[0] * vox[1] + (loc // 1)[1]
        target_offset[n] = (loc % 1)[:2]
        if vis_idx.any():
            target_bbox[n] = ((2 * np.abs(cpos - pose[vis_idx]).max(axis=0)
                               + 200.0) / ind_space)[:2]

        mu = cpos
        win = []
        for a in range(3):
            lo = np.searchsorted(grid1d[a], mu[a] - 3 * sigma)
            hi = np.searchsorted(grid1d[a], mu[a] + 3 * sigma, "right")
            win.append((lo, hi))
        if any(lo >= hi for lo, hi in win):
            continue

        (x0, x1), (y0, y1), (z0, z1) = win
        gx, gy = np.meshgrid(grid1d[0][x0:x1], grid1d[1][y0:y1],
                             indexing="ij")
        g = np.exp(-((gx - mu[0]) ** 2 + (gy - mu[1]) ** 2)
                   / (2 * sigma ** 2))
        target_2d[x0:x1, y0:y1] = np.maximum(target_2d[x0:x1, y0:y1], g)

        gz = np.exp(-(grid1d[2][z0:z1] - mu[2]) ** 2 / (2 * sigma ** 2))
        target_1d[n, z0:z1] = np.maximum(target_1d[n, z0:z1], gz)

    target_2d = np.clip(target_2d, 0, 1)
    target_1d = np.clip(target_1d, 0, 1)
    # reference quirk preserved: '<=' keeps one padding row in the mask
    mask = np.arange(maxp) <= num_people
    return {
        "index": target_index,
        "offset": target_offset,
        "bbox": target_bbox,
        "2d_heatmaps": target_2d,
        "1d_heatmaps": target_1d,
        "mask": mask,
    }
