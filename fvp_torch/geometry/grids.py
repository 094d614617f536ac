"""Voxel grids and the per-rig projection constants.

Camera geometry is static per rig, so everything derivable from it is
computed once on the host into numpy arrays (`RigConstants`), and
`RigConstants.to(device)` moves them to the device as float32 tensors.

Sampling-coordinate semantics: clamp projected pixels to
[-1, max(ori_w, ori_h)] (one scalar bound on both axes), affine to heatmap
pixels, normalise by (size - 1) (align_corners), clamp the normalised
coordinates to [-1.1, 1.1], and return to heatmap pixels.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from fvp_torch.config import FVPConfig
from fvp_torch.geometry.cameras import CameraRig, project_points_np
from fvp_torch.geometry.transforms import affine_apply, get_resize_transform


def voxel_grid(space_size, space_center, nbins) -> np.ndarray:
    """Centers of an (nx, ny, nz) voxel grid -> (nx*ny*nz, 3), x-major C
    order."""
    axes = [
        np.linspace(-s / 2.0, s / 2.0, int(n)) + c
        for s, c, n in zip(space_size, space_center, nbins)
    ]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    return np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1)


def center_grids(cfg: FVPConfig) -> np.ndarray:
    """The (3, nx*ny, 2) mm coordinate grids of the xy / xz / yz planes of
    the individual cube centered at the whole-space center (soft-argmax)."""
    nx, ny, nz = cfg.ind_voxels_per_axis
    assert nx == ny == nz, "individual cube must be isotropic"
    grid = voxel_grid(cfg.ind_space_size, cfg.space_center,
                      cfg.ind_voxels_per_axis).reshape(nx, ny, nz, 3)
    xy = grid[:, :, 0, :2].reshape(-1, 2)
    xz = grid[:, 0, :, ::2].reshape(-1, 2)
    yz = grid[0, :, :, 1:].reshape(-1, 2)
    return np.stack([xy, xz, yz])


def heatmap_transform(cfg: FVPConfig) -> np.ndarray:
    """Fused 2x3 affine: original-image pixels -> heatmap pixels."""
    t = get_resize_transform(cfg.ori_image_size, cfg.image_size)
    sx = cfg.heatmap_size[0] / cfg.image_size[0]
    sy = cfg.heatmap_size[1] / cfg.image_size[1]
    return t * np.array([[sx], [sy]])


def to_sample_px(xy_ori: np.ndarray, cfg: FVPConfig,
                 hm_t: np.ndarray) -> np.ndarray:
    """Projected original-image pixels (..., 2) -> heatmap sampling pixels
    with the clamp chain (numpy, host precompute)."""
    bound = float(max(cfg.ori_image_size))
    w, h = cfg.heatmap_size
    wh1 = np.asarray([w - 1.0, h - 1.0], dtype=xy_ori.dtype)
    xy = np.clip(xy_ori, -1.0, bound)
    xy = affine_apply(xy, np.asarray(hm_t, dtype=xy_ori.dtype))
    g = xy / wh1 * 2.0 - 1.0
    g = np.clip(g, -1.1, 1.1)
    return (g + 1.0) * 0.5 * wh1


def to_sample_px_uv(u, v, cfg: FVPConfig, hm_t):
    """Structure-of-arrays variant of `to_sample_px` for tensors:
    (u (N,), v (N,)) -> (px (N,), py (N,))."""
    bound = float(max(cfg.ori_image_size))
    w, h = cfg.heatmap_size
    u = torch.clamp(u, -1.0, bound)
    v = torch.clamp(v, -1.0, bound)
    x = hm_t[0, 0] * u + hm_t[0, 1] * v + hm_t[0, 2]
    y = hm_t[1, 0] * u + hm_t[1, 1] * v + hm_t[1, 2]
    gx = torch.clamp(x / (w - 1.0) * 2.0 - 1.0, -1.1, 1.1)
    gy = torch.clamp(y / (h - 1.0) * 2.0 - 1.0, -1.1, 1.1)
    return (gx + 1.0) * 0.5 * (w - 1.0), (gy + 1.0) * 0.5 * (h - 1.0)


def pack_cam_params(rig: CameraRig, hm_t: np.ndarray) -> np.ndarray:
    """(V, 27) float32 per-view camera parameters followed by the
    image->heatmap affine: R (9), T (3), f (2), c (2), k (3), p (2), hm (6).
    The person sampler's kernel projects voxels from these."""
    V = rig.num_cameras
    return np.concatenate([
        np.asarray(rig.R, np.float32).reshape(V, 9),
        np.asarray(rig.T, np.float32).reshape(V, 3),
        np.asarray(rig.f, np.float32).reshape(V, 2),
        np.asarray(rig.c, np.float32).reshape(V, 2),
        np.asarray(rig.k, np.float32).reshape(V, 3),
        np.asarray(rig.p, np.float32).reshape(V, 2),
        np.broadcast_to(np.asarray(hm_t, np.float32).reshape(1, 6), (V, 6)),
    ], axis=1)


@dataclass
class RigConstants:
    """Constants for one camera rig + capture space.

    whole_sample_px: (V, 2, num_bins) heatmap-pixel sampling coords (x, y)
                     of every coarse voxel center in every view.
    center_grid:     (3, ind_nx*ind_ny, 2) plane mm-coordinate grids.
    rig:             CameraRig (float32) for the per-person path.
    hm_transform:    (2, 3) original-pixel -> heatmap-pixel affine.
    cam_params:      (V, 27) packed rig + affine (see `pack_cam_params`).
    voxel_to_mm:     (2, 3) coarse voxel index -> world mm affine (scale,
                     bias), made once so that a frame copies no constant.

    Built as numpy arrays; `to(device)` returns the same constants as
    float32 tensors on `device`.
    """

    whole_sample_px: Any
    center_grid: Any
    rig: CameraRig
    hm_transform: Any
    cam_params: Any
    voxel_to_mm: Any

    def to(self, device) -> "RigConstants":
        def t(x):
            return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                                   device=device)
        return RigConstants(
            whole_sample_px=t(self.whole_sample_px),
            center_grid=t(self.center_grid),
            rig=self.rig.to(device),
            hm_transform=t(self.hm_transform),
            cam_params=t(self.cam_params),
            voxel_to_mm=t(self.voxel_to_mm),
        )


def build_rig_constants(cfg: FVPConfig, rig: CameraRig) -> RigConstants:
    grid = voxel_grid(cfg.space_size, cfg.space_center, cfg.voxels_per_axis)
    hm_t = heatmap_transform(cfg)
    sample_px = np.stack([
        to_sample_px(
            project_points_np(grid, rig.camera(v)).astype(np.float32),
            cfg, hm_t.astype(np.float32),
        ).T
        for v in range(rig.num_cameras)
    ])                                     # (V, 2, num_bins)
    return RigConstants(
        whole_sample_px=sample_px.astype(np.float32),
        center_grid=center_grids(cfg).astype(np.float32),
        rig=rig.astype(np.float32),
        hm_transform=hm_t.astype(np.float32),
        cam_params=pack_cam_params(rig, hm_t),
        voxel_to_mm=np.stack(voxel_to_mm(cfg)),
    )


def voxel_to_mm(cfg: FVPConfig):
    """Coarse voxel index -> world mm affine (float32 numpy)."""
    space = np.asarray(cfg.space_size, np.float32)
    vox = np.asarray(cfg.voxels_per_axis, np.float32)
    center = np.asarray(cfg.space_center, np.float32)
    return space / (vox - 1.0), center - space / 2.0
