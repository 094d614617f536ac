"""Pose overlays on camera images: the limb tables of 14/15/17-joint
skeletons and the reprojection of fused 3D poses into one view.

A copy of the reference package's `utils/vis.py` (`limbs_for`,
`draw_poses_on_image`), on the port's geometry; its matplotlib figures
(`save_3d_planes`, `save_heatmap_grid`) are not on the service's path and
are not copied. cv2 is imported where it draws.
"""

from __future__ import annotations

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
