"""Wrappers of the two sampling kernels, K1 `whole_sample`
(csrc/whole_sample.cu) and K2 `person_planes` (csrc/person_planes.cu),
with their plain versions.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. K2 launches two kernels per frame: `person_layout` writes the
heatmaps pixel-major, (B, V, H, W, JP) with the joints padded to a
multiple of 4 with zeros (`pixel_major`), and `person_planes` samples and
collapses every person's cube from that layout, one block per (person,
16-x slab, TY-y rows) tile (`person_tiling`).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from fvp_torch.config import FVPConfig
from fvp_torch.geometry.grids import RigConstants
from fvp_torch.ops.kernels import Kernel, check, ptr
from fvp_torch.ops.sampling import (
    collapse_planes, fine_grid, person_validity, project_whole,
    sample_person_cube, snap_centers,
)

WHOLE_SAMPLE = Kernel("whole_sample", "fvp_whole_sample")
# the same kernel in sum mode (the view-sharded step), counted apart
WHOLE_SAMPLE_SUM = Kernel("whole_sample.sum", "fvp_whole_sample")
PERSON_LAYOUT = Kernel("person_planes.layout", "fvp_person_layout")
PERSON_PLANES = Kernel("person_planes", "fvp_person_planes")
TILE_X = 16              # x values a thread of person_planes loops over


# --------------------------------------------------------------------------
# K1: whole-space volume
# --------------------------------------------------------------------------

def row_block(rc: RigConstants, cfg: FVPConfig, x0: int,
              rows: int) -> RigConstants:
    """`rc` with whole_sample_px cut to the voxels of x-rows x0 ..
    x0+rows-1, made contiguous: the voxels are x-major, so a row block is
    one range of the N voxels of each view. Make it once per rig, not per
    frame (parallel/spatial.py)."""
    _, ny, nz = cfg.voxels_per_axis
    px = rc.whole_sample_px[..., x0 * ny * nz:(x0 + rows) * ny * nz]
    return dataclasses.replace(rc, whole_sample_px=px.contiguous())


def whole_sample_plain(heatmaps: torch.Tensor, rc: RigConstants,
                       cfg: FVPConfig, view_sum: bool = False,
                       rows: tuple[int, int] | None = None) -> torch.Tensor:
    """(B, V, J, H, W) -> (B, nx, ny, nz, J) whole-space volumes (view
    sums with `view_sum`; x-rows x0 .. x0+XL-1 alone with `rows` (x0,
    XL), as `whole_sample`)."""
    return torch.stack([project_whole(h, rc, cfg, view_sum,
                                      None if rows is None else rows[1])
                        for h in heatmaps])


def whole_sample(heatmaps: torch.Tensor, rc: RigConstants,
                 cfg: FVPConfig, view_sum: bool = False,
                 rows: tuple[int, int] | None = None) -> torch.Tensor:
    """(B, V, J, H, W) heatmaps -> (B, nx, ny, nz, J) volumes in [0, 1]:
    bilinear sample of every view at rc.whole_sample_px, view mean,
    clamp. With `view_sum` (sum mode), the float32 sum over the V views
    given, unnormalised and unclamped: rc.whole_sample_px then holds those
    views' coords (a slice of the rig's first axis), and
    ops/sampling.py::view_mean of the parts' sum is the volume. With
    `rows` (x0, XL), the volume's x-rows x0 .. x0+XL-1 alone, (B, XL, ny,
    nz, J): rc.whole_sample_px then holds those rows' coords
    (`row_block`), the spatially sharded step's block."""
    if not heatmaps.is_cuda:
        return whole_sample_plain(heatmaps, rc, cfg, view_sum, rows)
    B, V, J, H, W = heatmaps.shape
    nx, ny, nz = cfg.voxels_per_axis
    if rows is not None:
        x0, nx = rows
        if x0 < 0 or x0 + nx > cfg.voxels_per_axis[0]:
            raise ValueError(f"whole_sample: rows {rows} outside the "
                             f"space's {cfg.voxels_per_axis[0]}")
    N = nx * ny * nz
    if J not in (15, 17):
        raise ValueError(f"whole_sample: {J} joints; the kernel is built "
                         "for 15 and 17")
    check(heatmaps, "heatmaps")
    check(rc.whole_sample_px, "whole_sample_px", (V, 2, N),
          device=heatmaps.device)
    out = torch.empty((B, nx, ny, nz, J), dtype=torch.float32,
                      device=heatmaps.device)
    (WHOLE_SAMPLE_SUM if view_sum else WHOLE_SAMPLE)(
        ptr(heatmaps), ptr(rc.whole_sample_px), ptr(out), B, V, J, H, W, N,
        int(view_sum))
    return out


# --------------------------------------------------------------------------
# K2: per-person cubes collapsed to tri-planes
# --------------------------------------------------------------------------

def person_geometry(cfg: FVPConfig) -> tuple[float, ...]:
    """(pitch_x, pitch_y, pitch_z, origin_x, origin_y, origin_z, bound):
    the fine grid's float32 pitch and origin, and the projected-pixel clamp
    bound, as the kernel takes them."""
    pitch, origin = fine_grid(cfg)
    return (*(float(v) for v in pitch), *(float(v) for v in origin),
            float(max(cfg.ori_image_size)))


def person_bounds(centers_mm: torch.Tensor, bbox: torch.Tensor,
                  person_mask: torch.Tensor, cfg: FVPConfig):
    """(B, K, 3) centers, (B, K, 2) bbox, (B, K) mask -> corner, start,
    end (P, 3) int32 and offsets (B, K, 3), P = B*K. A person that is dead
    (empty crop) or not in the mask gets end == start: it takes no part."""
    B, K = centers_mm.shape[:2]
    corner, offset = snap_centers(centers_mm.reshape(B * K, 3), cfg)
    start, end, alive = person_validity(corner, bbox.reshape(B * K, 2), cfg)
    live = alive & person_mask.reshape(B * K)
    end = torch.where(live[:, None], end, start)
    return corner, start, end, offset.reshape(B, K, 3)


def person_planes_plain(heatmaps: torch.Tensor, rc: RigConstants,
                        cfg: FVPConfig, corner: torch.Tensor,
                        start: torch.Tensor, end: torch.Tensor
                        ) -> torch.Tensor:
    """Plain version of K2: each person's cube, then its tri-plane collapse.
    heatmaps (B, V, J, H, W); corner/start/end (P, 3), P = B*K.
    Returns planes (3, P, A, A, J)."""
    B, V, J = heatmaps.shape[:3]
    P = corner.shape[0]
    K = P // B
    n = cfg.ind_voxels_per_axis[0]
    planes = heatmaps.new_zeros((3, P, n, n, J))
    for p in range(P):
        if bool((end[p] <= start[p]).any()):
            continue                            # takes no part: zero planes
        cube = sample_person_cube(heatmaps[p // K], rc, cfg, corner[p],
                                  start[p], end[p])
        planes[:, p] = collapse_planes(cube[None])[:, 0]
    return planes


def padded_joints(J: int) -> int:
    return (J + 3) // 4 * 4


def pixel_major_plain(heatmaps: torch.Tensor) -> torch.Tensor:
    """(B, V, J, H, W) -> (B, V, H, W, JP), JP = J rounded up to 4, the
    padding zero: the layout K2 gathers from."""
    J = heatmaps.shape[2]
    hmp = heatmaps.permute(0, 1, 3, 4, 2)
    return F.pad(hmp, (0, padded_joints(J) - J)).contiguous()


def pixel_major(heatmaps: torch.Tensor) -> torch.Tensor:
    """pixel_major_plain, by the layout kernel for a CUDA tensor."""
    if not heatmaps.is_cuda:
        return pixel_major_plain(heatmaps)
    B, V, J, H, W = heatmaps.shape
    check(heatmaps, "heatmaps")
    JP = padded_joints(J)
    out = torch.empty((B, V, H, W, JP), dtype=torch.float32,
                      device=heatmaps.device)
    PERSON_LAYOUT(ptr(heatmaps), ptr(out), B * V, J, H, W, JP)
    return out


def person_tiling(n: int) -> tuple[int, int]:
    """(TY, blocks) of K2 for n^3 cubes: a block is n z-threads x TY y-rows
    (at most 512 threads) looping over TILE_X x values; blocks per person
    (n / TILE_X) x (n / TY)."""
    ty = min(512 // n, n)
    return ty, (n // TILE_X) * (n // ty)


def person_planes(heatmaps: torch.Tensor, rc: RigConstants, cfg: FVPConfig,
                  centers_mm: torch.Tensor, bbox: torch.Tensor,
                  person_mask: torch.Tensor):
    """JLN sampling: heatmaps (B, V, J, H, W), centers (B, K, 3), bbox
    (B, K, 2), person_mask (B, K) bool. Returns (planes (3, B*K, A, A, J)
    with xy = max over z, xz = max over y, yz = max over x; offsets
    (B, K, 3)). Persons outside the mask get zero planes."""
    corner, start, end, offsets = person_bounds(centers_mm, bbox,
                                                person_mask, cfg)
    if not heatmaps.is_cuda:
        return person_planes_plain(heatmaps, rc, cfg, corner, start,
                                   end), offsets
    B, V, J, H, W = heatmaps.shape
    P = corner.shape[0]
    n = cfg.ind_voxels_per_axis[0]
    if tuple(cfg.ind_voxels_per_axis) != (n, n, n) or n not in (16, 32, 64):
        raise ValueError(f"person_planes: cube {cfg.ind_voxels_per_axis} "
                         "must be isotropic with side 16, 32 or 64")
    if J not in (15, 17):
        raise ValueError(f"person_planes: {J} joints; the kernel is built "
                         "for 15 and 17")
    check(heatmaps, "heatmaps")
    check(rc.cam_params, "cam_params", (V, 27), device=heatmaps.device)
    corner, start, end = (t.contiguous() for t in (corner, start, end))
    for t, name in ((corner, "corner"), (start, "start"), (end, "end")):
        check(t, name, (P, 3), dtype=torch.int32, device=heatmaps.device)
    return sample_planes(pixel_major(heatmaps), rc, cfg, corner, start,
                         end, J), offsets


def sample_planes(hmp: torch.Tensor, rc: RigConstants, cfg: FVPConfig,
                  corner: torch.Tensor, start: torch.Tensor,
                  end: torch.Tensor, J: int) -> torch.Tensor:
    """The person_planes kernel alone on pixel-major heatmaps hmp (B, V, H,
    W, JP) (from `pixel_major`) and checked person bounds: planes (3, P,
    n, n, J)."""
    B, V, H, W, _ = hmp.shape
    P = corner.shape[0]
    n = cfg.ind_voxels_per_axis[0]
    check(hmp, "hmp", (B, V, H, W, padded_joints(J)))
    planes = torch.zeros((3, P, n, n, J), dtype=torch.float32,
                         device=hmp.device)
    PERSON_PLANES(ptr(hmp), ptr(rc.cam_params), ptr(corner), ptr(start),
                  ptr(end), ptr(planes), V, J, H, W, n, person_tiling(n)[0],
                  P // B, P, *person_geometry(cfg))
    return planes
