"""Heatmap -> voxel sampling, plain PyTorch.

Semantics contract: bilinear, align_corners=True, zero padding -- an
out-of-bounds corner pixel contributes 0. The precomputed sampling coords
carry the +-1.1 normalised clamp and stay in heatmap-pixel space.

Whole space: sample every view's heatmaps at the precomputed voxel
projections, mean over views, clamp to [0, 1].

Per person: a person's cube voxel centers are `origin + (corner + j) *
pitch` (the fine-grid pitch equals the cube pitch), so positions come from
the snapped corner index and are projected on the fly. The bbox crop and
the space-boundary crop are a per-voxel validity mask.

These are the plain versions the kernels in `fvp_torch/ops/kernels/` are
held against; the kernels compute the same functions without the
intermediate tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from fvp_torch.config import FVPConfig
from fvp_torch.geometry.cameras import project_points_uv
from fvp_torch.geometry.grids import RigConstants, to_sample_px_uv


def bilinear_sample(heatmap: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """Sample a (J, H, W) heatmap at pixel coords x (N,), y (N,) -> (J, N).

    align_corners pixel space: coordinate (x, y) = pixel center (x, y).
    Out-of-bounds corners contribute zero.
    """
    J, H, W = heatmap.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx1 = x - x0
    wy1 = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    flat = heatmap.reshape(J, H * W)

    def corner(xi, yi, w):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        vals = flat[:, idx]                             # (J, N)
        return vals * (w * valid.to(heatmap.dtype))

    out = corner(x0i, y0i, (1.0 - wx1) * (1.0 - wy1))
    out += corner(x0i + 1, y0i, wx1 * (1.0 - wy1))
    out += corner(x0i, y0i + 1, (1.0 - wx1) * wy1)
    out += corner(x0i + 1, y0i + 1, wx1 * wy1)
    return out


def view_mean(total: torch.Tensor, num_views: int) -> torch.Tensor:
    """A volume's view sum -> its values: divided by the view count and
    clamped to [0, 1], the operations of K1's mean mode. The divisor is a
    tensor on the sum's device: PyTorch divides a CUDA tensor by a host
    scalar as a product with its reciprocal, which can differ by an ulp."""
    return torch.clamp(total / total.new_full((), float(num_views)),
                       0.0, 1.0)


def project_whole(heatmaps: torch.Tensor, rc: RigConstants,
                  cfg: FVPConfig, view_sum: bool = False,
                  rows: int | None = None) -> torch.Tensor:
    """Aggregate (V, J, H, W) view heatmaps into the whole-space volume
    (nx, ny, nz, J), values clamped to [0, 1]. With `view_sum`, the sum
    over these views instead, unnormalised and unclamped (a rank's part of
    a volume whose views are spread over ranks); `view_mean` of the parts'
    sum is then the volume. With `rows`, rc.whole_sample_px holds the
    coords of that many x-rows alone (a row block of the volume,
    ops/kernels/sampler.py::row_block) and the volume has that many."""
    px = rc.whole_sample_px
    sampled = torch.stack([bilinear_sample(heatmaps[v], px[v, 0], px[v, 1])
                           for v in range(heatmaps.shape[0])])
    volume = sampled.sum(dim=0)                           # (J, nbins)
    if not view_sum:
        volume = view_mean(volume, heatmaps.shape[0])
    nx, ny, nz = cfg.voxels_per_axis
    nx = nx if rows is None else rows
    return volume.reshape(heatmaps.shape[1], nx, ny, nz).permute(1, 2, 3, 0)


@functools.lru_cache(maxsize=None)
def _grid_constants(cfg: FVPConfig, device: torch.device) -> dict:
    """The space's sizes as tensors on `device`, made once: a tensor made
    from host values per call would copy (and wait for the stream) every
    frame."""
    def t(v, dtype=torch.float32):
        return torch.tensor(v, dtype=dtype, device=device)

    return {"space": t(cfg.space_size), "center": t(cfg.space_center),
            "ind": t(cfg.ind_space_size),
            "fine": t(cfg.fine_voxels_per_axis),
            "ind_vox": t(cfg.ind_voxels_per_axis, torch.int32),
            "fine_vox": t(cfg.fine_voxels_per_axis, torch.int32),
            "ind_xy": t(cfg.ind_voxels_per_axis[:2])}


def snap_centers(centers_mm: torch.Tensor, cfg: FVPConfig):
    """Snap proposal centers (P, 3) mm to fine-grid corner indices.

    Returns (corner (P, 3) int32, offset (P, 3) float32); `offset` turns
    cube-local soft-argmax coords into world mm.
    """
    c = _grid_constants(cfg, centers_mm.device)
    space, center, ind, fine = c["space"], c["center"], c["ind"], c["fine"]
    scale = (fine - 1.0) / space
    bias = -ind / 2.0 / space * (fine - 1.0) - scale * (center - space / 2.0)
    corner = torch.round(centers_mm * scale + bias).to(torch.int32)
    offset = corner.to(torch.float32) / (fine - 1.0) * space \
        - space / 2.0 + ind / 2.0
    return corner, offset


def person_validity(corner: torch.Tensor, bbox: torch.Tensor,
                    cfg: FVPConfig):
    """Per-axis [start, end) fine-index bounds of each person's cube, and
    whether the crop is non-empty. corner (P, 3) int32, bbox (P, 2) ->
    (start (P, 3), end (P, 3), alive (P,))."""
    c = _grid_constants(cfg, corner.device)
    ind_vox, fine_vox, ind_xy = c["ind_vox"], c["fine_vox"], c["ind_xy"]
    mask_xy = ((1.0 - bbox) / 2.0 * (ind_xy - 1.0)).to(torch.int32)
    mask_xy = torch.clamp(mask_xy, min=0)
    mask = torch.cat([mask_xy, torch.zeros_like(mask_xy[:, :1])], dim=1)
    start = torch.clamp(corner + mask, min=0)
    end = torch.minimum(corner + ind_vox - mask, fine_vox)
    alive = torch.all(start < end, dim=1)
    return start, end, alive


def fine_grid(cfg: FVPConfig):
    """(pitch (3,), origin (3,)) of the fine voxel grid, float32: the
    voxel (i, j, k) of a person whose cube corner is c lies at
    origin + (c + (i, j, k)) * pitch."""
    space = np.asarray(cfg.space_size, np.float32)
    centr = np.asarray(cfg.space_center, np.float32)
    fine = np.asarray(cfg.fine_voxels_per_axis, np.float32)
    return space / (fine - np.float32(1.0)), centr - space / np.float32(2.0)


def cube_positions_uv(corner: torch.Tensor, cfg: FVPConfig):
    """World-mm positions of one person's cube voxels as three flattened
    (N,) coordinate tensors (x, y, z), N = X*Y*Z, x-major."""
    nx, ny, nz = cfg.ind_voxels_per_axis
    pitch, origin = fine_grid(cfg)
    dev = corner.device

    def axis(a, n):
        j = torch.arange(n, dtype=torch.float32, device=dev)
        return float(origin[a]) + (corner[a].to(torch.float32) + j) \
            * float(pitch[a])

    ax, ay, az = axis(0, nx), axis(1, ny), axis(2, nz)
    px = ax[:, None, None].expand(nx, ny, nz).reshape(-1)
    py = ay[None, :, None].expand(nx, ny, nz).reshape(-1)
    pz = az[None, None, :].expand(nx, ny, nz).reshape(-1)
    return px, py, pz


def sample_person_cube(heatmaps: torch.Tensor, rc: RigConstants,
                       cfg: FVPConfig, corner: torch.Tensor,
                       start: torch.Tensor, end: torch.Tensor):
    """(V, J, H, W) heatmaps -> one (X, Y, Z, J) cube for the person whose
    snapped corner is `corner` (3,); voxels outside [start, end) on any
    axis are 0 (pass end == start for a person that takes no part)."""
    nx, ny, nz = cfg.ind_voxels_per_axis
    px, py, pz = cube_positions_uv(corner, cfg)
    rig = rc.rig
    acc = None
    for v in range(heatmaps.shape[0]):
        u, w = project_points_uv(px, py, pz, rig.R[v], rig.T[v], rig.f[v],
                                 rig.c[v], rig.k[v], rig.p[v])
        sx, sy = to_sample_px_uv(u, w, cfg, rc.hm_transform)
        s = bilinear_sample(heatmaps[v], sx, sy)        # (J, N)
        acc = s if acc is None else acc + s
    cube = torch.clamp(acc / heatmaps.shape[0], 0.0, 1.0)

    dims = (nx, ny, nz)
    ok = []
    for a in range(3):
        fj = corner[a] + torch.arange(dims[a], device=corner.device)
        ok.append((fj >= start[a]) & (fj < end[a]))
    valid = ok[0][:, None, None] & ok[1][None, :, None] & ok[2][None, None, :]
    cube = cube.reshape(-1, nx, ny, nz) * valid.to(cube.dtype)
    return cube.permute(1, 2, 3, 0)                     # (X, Y, Z, J)


def sample_person_cubes(heatmaps: torch.Tensor, rc: RigConstants,
                        cfg: FVPConfig, centers_mm: torch.Tensor,
                        bbox: torch.Tensor):
    """All person cubes of one frame. heatmaps (V, J, H, W); centers_mm
    (P, 3); bbox (P, 2) size fractions. Returns (cubes (P, X, Y, Z, J),
    offset (P, 3)). A person whose crop is empty gets a zero cube."""
    corner, offset = snap_centers(centers_mm, cfg)
    start, end, alive = person_validity(corner, bbox, cfg)
    end = torch.where(alive[:, None], end, start)
    cubes = torch.stack([
        sample_person_cube(heatmaps, rc, cfg, corner[p], start[p], end[p])
        for p in range(corner.shape[0])])
    return cubes, offset


def collapse_planes(cubes: torch.Tensor) -> torch.Tensor:
    """Tri-plane collapse of (P, X, Y, Z, J) cubes -> (3, P, A, B, J):
    xy = max over z, xz = max over y, yz = max over x."""
    return torch.stack([cubes.amax(dim=3), cubes.amax(dim=2),
                        cubes.amax(dim=1)])
