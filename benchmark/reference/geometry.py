"""Cameras, voxel grids and sampling coordinates, in numpy and torch.

World -> pixel: rotate into the camera frame, perspective divide with a
1e-5 z-guard, Brown-Conrady distortion (k1, k2, k3 radial; p1, p2
tangential), focal and principal point. Pixels are clamped to [-1,
max(ori_w, ori_h)], mapped to heatmap pixels by the fixed resize affine,
normalised by (size - 1), clamped to [-1.1, 1.1] and mapped back: the
sampling convention of Faster-VoxelPose's projection layer.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Space:
    """The sizes of one configuration that the model's geometry reads."""
    num_joints: int
    num_views: int
    ori_image_size: tuple
    image_size: tuple
    heatmap_size: tuple
    space_size: tuple
    space_center: tuple
    voxels_per_axis: tuple
    ind_space_size: tuple
    ind_voxels_per_axis: tuple
    max_people: int
    min_score: float
    beta: float

    @staticmethod
    def from_config(cfg: dict) -> "Space":
        def t(key):
            v = cfg[key]
            return tuple(v) if isinstance(v, (list, tuple)) else v
        return Space(**{f: t(f) for f in Space.__dataclass_fields__})

    @property
    def fine_voxels_per_axis(self) -> tuple:
        return tuple(int(ws / is_ * (v - 1)) + 1 for ws, is_, v in zip(
            self.space_size, self.ind_space_size, self.ind_voxels_per_axis))


# --------------------------------------------------------------------------
# cameras
# --------------------------------------------------------------------------

def ring_rig(num_views: int, space_center, ori_image_size, radius: float,
             height: float, focal: float, seed: int) -> dict:
    """A ring of inward-looking cameras around the space, distortion drawn
    from `seed`: {"R" (V, 3, 3), "T" (V, 3), "f" (V, 2), "c" (V, 2), "k"
    (V, 3), "p" (V, 2)} float64 numpy."""
    rng = np.random.RandomState(seed)
    center = np.asarray(space_center, np.float64)
    out = {key: [] for key in "RTfckp"}
    for v in range(num_views):
        ang = 2 * np.pi * v / num_views
        pos = center + np.array([radius * np.cos(ang),
                                 radius * np.sin(ang), height])
        fwd = center + np.array([0.0, 0.0, 900.0]) - pos
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, np.array([0.0, 0.0, -1.0]))
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        out["R"].append(np.stack([right, down, fwd]))
        out["T"].append(pos)
        out["f"].append([focal, focal])
        out["c"].append([ori_image_size[0] / 2.0, ori_image_size[1] / 2.0])
        out["k"].append(rng.uniform(-0.1, 0.1, 3) * [1.0, 0.1, 0.01])
        out["p"].append(rng.uniform(-0.005, 0.005, 2))
    return {key: np.asarray(val, np.float64) for key, val in out.items()}


def camera(rig: dict, v: int) -> dict:
    return {key: rig[key][v] for key in rig}


def project_np(points: np.ndarray, cam: dict) -> np.ndarray:
    """World points (N, 3) -> pixels (N, 2), float64."""
    xcam = cam["R"] @ (points.astype(np.float64).T
                       - cam["T"].reshape(3, 1))
    y = xcam[:2] / (xcam[2] + 1e-5)
    k, p = cam["k"], cam["p"]
    r2 = np.sum(y ** 2, axis=0)
    d = 1.0 + k[0] * r2 + k[1] * r2 ** 2 + k[2] * r2 ** 3
    u = y[0] * d + 2 * p[0] * y[0] * y[1] + p[1] * (r2 + 2 * y[0] ** 2)
    v = y[1] * d + 2 * p[1] * y[0] * y[1] + p[0] * (r2 + 2 * y[1] ** 2)
    return (cam["f"].reshape(2, 1) * np.stack([u, v])
            + cam["c"].reshape(2, 1)).T


def project_torch(px, py, pz, cam: dict):
    """The same projection on (N,) float32 tensors; `cam` holds float32
    tensors on their device."""
    R, T, f, c, k, p = (cam[key] for key in "RTfckp")
    wx, wy, wz = px - T[0], py - T[1], pz - T[2]
    xc = R[0, 0] * wx + R[0, 1] * wy + R[0, 2] * wz
    yc = R[1, 0] * wx + R[1, 1] * wy + R[1, 2] * wz
    zc = R[2, 0] * wx + R[2, 1] * wy + R[2, 2] * wz + 1e-5
    x, y = xc / zc, yc / zc
    r2 = x * x + y * y
    d = 1.0 + r2 * (k[0] + r2 * (k[1] + r2 * k[2]))
    u = x * d + 2.0 * p[0] * x * y + p[1] * (r2 + 2.0 * x * x)
    v = y * d + 2.0 * p[1] * x * y + p[0] * (r2 + 2.0 * y * y)
    return f[0] * u + c[0], f[1] * v + c[1]


# --------------------------------------------------------------------------
# the resize affine
# --------------------------------------------------------------------------

def resize_transform(ori_image_size, image_size) -> np.ndarray:
    """The 2x3 affine of an aspect-preserving resize of the original image
    about its center to `image_size` (the data pipeline's fixed
    transform)."""
    w, h = ori_image_size
    wr, hr = image_size
    if w / wr < h / hr:
        sw, sh = h / hr * wr, h
    else:
        sw, sh = w, w / wr * hr
    center = np.array([w / 2.0, h / 2.0])
    mid = np.array([wr / 2.0, hr / 2.0])
    if sw >= sh:
        src_dir, dst_dir = [0.0, -0.5 * sw], [0.0, -0.5 * wr]
    else:
        src_dir, dst_dir = [-0.5 * sh, 0.0], [-0.5 * hr, 0.0]
    src = np.array([center, center + src_dir, [0.0, 0.0]])
    dst = np.array([mid, mid + dst_dir, [0.0, 0.0]])
    for pts in (src, dst):
        d = pts[0] - pts[1]
        pts[2] = pts[1] + [-d[1], d[0]]
    a = np.concatenate([src, np.ones((3, 1))], axis=1)
    return np.linalg.solve(a, dst).T


def heatmap_transform(s: Space) -> np.ndarray:
    t = resize_transform(s.ori_image_size, s.image_size)
    return t * np.array([[s.heatmap_size[0] / s.image_size[0]],
                         [s.heatmap_size[1] / s.image_size[1]]])


def affine(points, t):
    return points @ t[:, :2].T + t[:, 2]


# --------------------------------------------------------------------------
# grids
# --------------------------------------------------------------------------

def voxel_centers(space_size, space_center, nbins) -> np.ndarray:
    """(nx*ny*nz, 3) voxel centers, x-major."""
    axes = [np.linspace(-s / 2.0, s / 2.0, int(n)) + c
            for s, c, n in zip(space_size, space_center, nbins)]
    g = np.meshgrid(*axes, indexing="ij")
    return np.stack([a.ravel() for a in g], axis=1)


def sample_px(xy: np.ndarray, s: Space, hm_t: np.ndarray) -> np.ndarray:
    """Projected pixels (N, 2) float32 -> heatmap sampling pixels."""
    wh1 = np.asarray([s.heatmap_size[0] - 1.0, s.heatmap_size[1] - 1.0],
                     np.float32)
    xy = np.clip(xy, -1.0, float(max(s.ori_image_size)))
    g = np.clip(affine(xy, hm_t) / wh1 * 2.0 - 1.0, -1.1, 1.1)
    return (g + 1.0) * 0.5 * wh1


def whole_px(s: Space, rig: dict) -> np.ndarray:
    """(V, 2, nx*ny*nz) float32 sampling pixels of every coarse voxel."""
    grid = voxel_centers(s.space_size, s.space_center, s.voxels_per_axis)
    hm_t = heatmap_transform(s).astype(np.float32)
    return np.stack([sample_px(project_np(grid, camera(rig, v))
                               .astype(np.float32), s, hm_t).T
                     for v in range(s.num_views)]).astype(np.float32)


def plane_grids(s: Space) -> np.ndarray:
    """(3, n*n, 2) mm grids of the xy, xz and yz planes of an individual
    cube centered at the space's center (the soft-argmax's)."""
    n = s.ind_voxels_per_axis[0]
    g = voxel_centers(s.ind_space_size, s.space_center,
                      s.ind_voxels_per_axis).reshape(n, n, n, 3)
    return np.stack([g[:, :, 0, :2].reshape(-1, 2),
                     g[:, 0, :, ::2].reshape(-1, 2),
                     g[0, :, :, 1:].reshape(-1, 2)]).astype(np.float32)


def voxel_affine(s: Space):
    """Coarse voxel index -> mm: (scale (3,), bias (3,)) float32."""
    space = np.asarray(s.space_size, np.float32)
    vox = np.asarray(s.voxels_per_axis, np.float32)
    center = np.asarray(s.space_center, np.float32)
    return space / (vox - np.float32(1.0)), center - space / np.float32(2.0)


def fine_grid(s: Space):
    """(pitch (3,), origin (3,)) float32 of the fine grid that individual
    cubes snap to."""
    space = np.asarray(s.space_size, np.float32)
    center = np.asarray(s.space_center, np.float32)
    fine = np.asarray(s.fine_voxels_per_axis, np.float32)
    return space / (fine - np.float32(1.0)), center - space / np.float32(2.0)


def snap(s: Space, centers_mm: torch.Tensor, bbox: torch.Tensor):
    """Proposal centers (P, 3) mm and bbox fractions (P, 2) -> the cube's
    fine corner (P, 3) int32, its crop [start, end) (P, 3) int32, whether
    the crop is non-empty (P,), and the offset (P, 3) mm that turns
    cube-local coordinates into world mm."""
    dev = centers_mm.device

    def t(v, dtype=torch.float32):
        return torch.tensor(v, dtype=dtype, device=dev)

    space, center = t(s.space_size), t(s.space_center)
    ind, fine = t(s.ind_space_size), t(s.fine_voxels_per_axis)
    scale = (fine - 1.0) / space
    bias = -ind / 2.0 / space * (fine - 1.0) - scale * (center - space / 2.0)
    corner = torch.round(centers_mm * scale + bias).to(torch.int32)
    offset = corner.to(torch.float32) / (fine - 1.0) * space \
        - space / 2.0 + ind / 2.0
    ind_vox = t(s.ind_voxels_per_axis, torch.int32)
    cut = ((1.0 - bbox) / 2.0 * (t(s.ind_voxels_per_axis[:2]) - 1.0)
           ).to(torch.int32).clamp(min=0)
    cut = torch.cat([cut, torch.zeros_like(cut[:, :1])], dim=1)
    start = torch.clamp(corner + cut, min=0)
    end = torch.minimum(corner + ind_vox - cut,
                        t(s.fine_voxels_per_axis, torch.int32))
    return corner, start, end, torch.all(start < end, dim=1), offset
