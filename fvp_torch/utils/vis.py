"""Visualization: the limb tables of 14/15/17-joint skeletons, the
reprojection of fused 3D poses into one camera image, the 3D skeleton
figure with its tri-plane projections, and heatmap grids.

A copy of the reference package's `utils/vis.py` (`limbs_for`,
`draw_poses_on_image`, `save_3d_planes`, `save_heatmap_grid`), on the
port's geometry. cv2 and matplotlib are imported where they draw, so the
module imports without them.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from fvp_torch.geometry.cameras import CameraRig, project_points_np
from fvp_torch.geometry.transforms import affine_apply

LIMBS15 = [[0, 1], [0, 2], [0, 3], [3, 4], [4, 5], [0, 9], [9, 10],
           [10, 11], [2, 6], [6, 7], [7, 8], [2, 12], [12, 13], [13, 14]]
LIMBS14 = [[0, 1], [1, 2], [3, 4], [4, 5], [2, 3], [6, 7], [7, 8],
           [9, 10], [10, 11], [2, 8], [3, 9], [8, 9], [12, 13]]
LIMBS17 = [[0, 1], [0, 2], [1, 3], [2, 4], [3, 5], [4, 6], [5, 7], [7, 9],
           [6, 8], [8, 10], [5, 11], [6, 12], [11, 13], [13, 15], [12, 14],
           [14, 16]]


def limbs_for(num_joints: int):
    return {14: LIMBS14, 15: LIMBS15, 17: LIMBS17}[num_joints]


def _valid_poses(fused: np.ndarray) -> np.ndarray:
    """(maxP, J, 5) -> (n, J, 3): rows with match/valid flag >= 0."""
    return fused[fused[:, 0, 3] >= 0, :, :3]


def save_3d_planes(fused: np.ndarray, path: str,
                   proposal_centers: Optional[np.ndarray] = None,
                   ind_space_size=(2000.0, 2000.0, 2000.0)) -> None:
    """4-panel figure: the 3D skeletons and their xy/xz/yz plane
    projections, with each person's proposal box on the xy plane."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    poses = _valid_poses(fused)
    if len(poses) == 0:
        return
    limbs = limbs_for(poses.shape[1])
    fig = plt.figure(figsize=(12, 10))
    ax3d = fig.add_subplot(2, 2, 1, projection="3d")
    axes2d = [fig.add_subplot(2, 2, i) for i in (2, 3, 4)]
    planes = [(0, 1, "xy"), (0, 2, "xz"), (1, 2, "yz")]

    cmap = plt.get_cmap("tab10")
    for pi, pose in enumerate(poses):
        color = cmap(pi % 10)
        for a, b in limbs:
            ax3d.plot(*zip(pose[a], pose[b]), c=color, lw=1.5)
        for ax, (i, j, name) in zip(axes2d, planes):
            for a, b in limbs:
                ax.plot([pose[a, i], pose[b, i]], [pose[a, j], pose[b, j]],
                        c=color, lw=1.0)
            ax.set_title(name)
        if proposal_centers is not None and pi < len(proposal_centers):
            c = proposal_centers[pi]
            w, h = c[5] * ind_space_size[0], c[6] * ind_space_size[1]
            axes2d[0].add_patch(
                plt.Rectangle((c[0] - w / 2, c[1] - h / 2), w, h,
                              fill=False, edgecolor=color))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=90)
    plt.close(fig)


def draw_poses_on_image(image: np.ndarray, fused: np.ndarray,
                        rig: CameraRig, view: int,
                        resize_transform: Optional[np.ndarray] = None
                        ) -> np.ndarray:
    """Reproject the detected 3D poses into camera `view` and draw their
    limbs and joints; returns a copy of `image` with the overlay."""
    import cv2

    img = np.ascontiguousarray(image.copy())
    poses = _valid_poses(fused)
    if len(poses) == 0:
        return img
    limbs = limbs_for(poses.shape[1])
    colors = [(0, 255, 0), (255, 128, 0), (0, 128, 255), (255, 0, 255),
              (255, 255, 0), (128, 255, 128)]
    for pi, pose in enumerate(poses):
        uv = project_points_np(pose.astype(np.float64), rig.camera(view))
        if resize_transform is not None:
            uv = affine_apply(uv, resize_transform)
        uv = uv.astype(int)
        color = colors[pi % len(colors)]
        for a, b in limbs:
            cv2.line(img, tuple(uv[a]), tuple(uv[b]), color, 2)
        for p in uv:
            cv2.circle(img, tuple(p), 3, color, -1)
    return img


def save_heatmap_grid(heatmaps: np.ndarray, path: str,
                      max_cols: int = 5) -> None:
    """(V, J, h, w) heatmaps -> a grid of each view's max over joints."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    V = heatmaps.shape[0]
    cols = min(V, max_cols)
    rows = (V + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, squeeze=False,
                             figsize=(3 * cols, 2.2 * rows))
    for v in range(V):
        ax = axes[v // cols][v % cols]
        ax.imshow(heatmaps[v].max(axis=0), cmap="magma")
        ax.set_title(f"view {v}")
        ax.axis("off")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=90)
    plt.close(fig)
