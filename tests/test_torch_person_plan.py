"""The premises of the person sampler's design (csrc/person_planes.cu),
checked on the CPU:

- the pixel-major layout's plain version (`pixel_major_plain`, what the
  layout kernel writes) holds the same values as the (V, J, H, W) maps,
  bit for bit, with the padded joints zero;
- `person_tiling`'s grid of blocks, threads and x loops covers every voxel
  of a cube once, within 512 threads and a block's shared memory;
- an emulation of the kernel's vector gather (the four taps of a voxel
  read as JP-joint vectors from the pixel-major layout) reproduces
  `person_planes_plain`.
"""

import numpy as np
import pytest
import torch

from fvp_torch.config import FVPConfig
from fvp_torch.geometry.cameras import default_ring_rig, project_points_uv
from fvp_torch.geometry.grids import build_rig_constants, to_sample_px_uv
from fvp_torch.ops import sampling as tsamp
from fvp_torch.ops.kernels import sampler as ksamp

MAX_SMEM = 232448


def _cfg(J, n):
    return FVPConfig(num_joints=J, num_views=3, heatmap_size=(60, 32),
                     voxels_per_axis=(16, 16, 8), ind_voxels_per_axis=(n,) * 3,
                     max_people=3, backbone="")


def _inputs(J, n, seed=0):
    cfg = _cfg(J, n)
    rng = np.random.RandomState(seed)
    rig = default_ring_rig(cfg.num_views, cfg.space_center,
                           cfg.ori_image_size)
    rc = build_rig_constants(cfg, rig).to("cpu")
    w, h = cfg.heatmap_size
    hm = torch.from_numpy(rng.rand(2, cfg.num_views, J, h, w)
                          .astype(np.float32))
    centers = np.stack([rng.uniform(-2500, 2500, (2, 3)),
                        rng.uniform(-3000, 2000, (2, 3)),
                        rng.uniform(400, 1400, (2, 3))], -1)
    centers[1, 2] = [9000.0, 9000.0, 800.0]              # dead: empty crop
    centers[0, 1] = [3900.0, 0.0, 900.0]                 # past the edge
    bbox = rng.uniform(0.2, 1.0, (2, 3, 2))
    mask = torch.tensor([[True, True, False], [True, True, True]])
    return (cfg, rc, hm, torch.from_numpy(centers.astype(np.float32)),
            torch.from_numpy(bbox.astype(np.float32)), mask)


@pytest.mark.parametrize("J", [15, 17])
def test_pixel_major_layout_is_exact(J):
    rng = np.random.RandomState(J)
    hm = torch.from_numpy(rng.rand(2, 3, J, 7, 9).astype(np.float32))
    hmp = ksamp.pixel_major(hm)                  # the CPU takes the plain one
    JP = ksamp.padded_joints(J)
    assert hmp.shape == (2, 3, 7, 9, JP) and hmp.is_contiguous()
    assert JP % 4 == 0 and JP - J < 4
    b, v, y, x, j = (rng.randint(0, s, 500) for s in (2, 3, 7, 9, J))
    assert torch.equal(hmp[b, v, y, x, j], hm[b, v, j, y, x])
    assert torch.equal(hmp[..., :J], hm.permute(0, 1, 3, 4, 2))
    assert float(hmp[..., J:].abs().sum()) == 0.0


@pytest.mark.parametrize("n", [16, 32, 64])
def test_tiles_cover_every_voxel_once(n):
    ty, blocks = ksamp.person_tiling(n)
    assert n * ty <= 512 and n % ty == 0 and n % ksamp.TILE_X == 0
    assert blocks == (n // ksamp.TILE_X) * (n // ty)
    count = np.zeros((n, n, n), np.int64)
    for bx in range(n // ksamp.TILE_X):
        for by in range(n // ty):
            for t in range(ty):                   # threadIdx.y
                for xi in range(ksamp.TILE_X):    # each thread's x loop
                    count[bx * ksamp.TILE_X + xi, by * ty + t, :] += 1
    assert count.min() == 1 and count.max() == 1
    for J in (15, 17):                            # xy_s + xz_s, int32
        assert 4 * ksamp.TILE_X * (ty + n) * J <= MAX_SMEM


def _vector_gather_planes(hm, rc, cfg, corner, start, end):
    """The kernel's arithmetic in PyTorch: each voxel's projection, its four
    taps read as JP-joint vectors from the pixel-major layout with their
    validity-zeroed bilinear weights, summed over views, the mean clamped,
    the crop applied, the cube collapsed."""
    hmp = ksamp.pixel_major_plain(hm)
    B, V, H, W, JP = hmp.shape
    J = hm.shape[2]
    P = corner.shape[0]
    n = cfg.ind_voxels_per_axis[0]
    planes = torch.zeros((3, P, n, n, J))
    rig = rc.rig
    for p in range(P):
        if bool((end[p] <= start[p]).any()):
            continue
        px, py, pz = tsamp.cube_positions_uv(corner[p], cfg)
        acc = torch.zeros((n ** 3, JP))
        for v in range(V):
            u, w = project_points_uv(px, py, pz, rig.R[v], rig.T[v],
                                     rig.f[v], rig.c[v], rig.k[v], rig.p[v])
            sx, sy = to_sample_px_uv(u, w, cfg, rc.hm_transform)
            fx, fy = torch.floor(sx), torch.floor(sy)
            ax, ay = sx - fx, sy - fy
            ix, iy = fx.long(), fy.long()
            img = hmp[p // (P // B), v]                      # (H, W, JP)
            for dx, dy, wt in ((0, 0, (1 - ax) * (1 - ay)),
                               (1, 0, ax * (1 - ay)),
                               (0, 1, (1 - ax) * ay), (1, 1, ax * ay)):
                xx, yy = ix + dx, iy + dy
                ok = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
                vec = img[yy.clamp(0, H - 1), xx.clamp(0, W - 1)]  # (N, JP)
                acc += vec * (wt * ok)[:, None]
        cube = torch.clamp(acc[:, :J] / V, 0.0, 1.0).reshape(n, n, n, J)
        idx = [corner[p][a] + torch.arange(n) for a in range(3)]
        ok = [(i >= start[p][a]) & (i < end[p][a]) for a, i in enumerate(idx)]
        valid = ok[0][:, None, None] & ok[1][None, :, None] \
            & ok[2][None, None, :]
        cube = cube * valid[..., None]
        planes[:, p] = tsamp.collapse_planes(cube[None])[:, 0]
    return planes


@pytest.mark.parametrize("J,n", [(15, 16), (17, 16), (15, 32)])
def test_vector_gather_matches_plain(J, n):
    cfg, rc, hm, centers, bbox, mask = _inputs(J, n, seed=n + J)
    corner, start, end, _ = ksamp.person_bounds(centers, bbox, mask, cfg)
    ref = ksamp.person_planes_plain(hm, rc, cfg, corner, start, end)
    got = _vector_gather_planes(hm, rc, cfg, corner, start, end)
    assert float(ref[:, 2].abs().max()) == 0.0            # unmatched
    assert float(ref[:, 5].abs().max()) == 0.0            # dead
    assert float(ref[:, 0].max()) > 0.0
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)
