"""The port's CUDA kernels against their plain versions on the card, at
shapes chip_smoke.py does not reach: 17 joints, 16- and 32-voxel cubes,
dead and unmatched persons, batches of two, odd pyramid widths, ragged
stem and deconv tiles, a 2048-channel deconv input; for the bf16 conv
kernels every op and width of P2PNet and the bottleneck stage at ragged
tiles, on both routes (conv_wgmma: Cin 16..256, N 16..256, 1x1 and 3x3,
every residual and output type, a level with fewer tiles than SMs), C2CNet
at Z = 8, 12 and 96, column counts that are no multiple of 8, many CTAs
and a weight ring of one slot, held also against its CPU emulation in the
kernel's own order of sums, WeightNet's pool in an odd number of bands and
in chunks of joints, and the `fuse_p2p` path; and the eval engine's
shapes (B = 8 frames, P = 80 people at the flagship widths), its device
splat, and run_validation on the card against the CPU; the entry points
computing float32 without TF32 whatever the global flags say; the
wrappers refusing inputs that require grad; a full-width train step
against the CPU, and the train CLI on the card.

These need an NVIDIA card and skip without one. The card's machine has no
JAX, so run them there without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels_cuda.py

They import nothing of the reference package.
"""

import numpy as np
import pytest
import torch

from fvp_torch.config import FVPConfig
from fvp_torch.engine.packing import pack_model
from fvp_torch.engine.serve import Predictor
from fvp_torch.geometry.cameras import default_ring_rig
from fvp_torch.geometry.grids import build_rig_constants
from fvp_torch.models.faster_voxelpose import FasterVoxelPose
from fvp_torch.engine.packing import pack_bottleneck_stage
from fvp_torch.ops.kernels import all_kernels, reset_launches
from fvp_torch.ops.kernels import c2cnet as kc2c
from fvp_torch.ops.kernels import centernet as kcn
from fvp_torch.ops.kernels import conv_bf16 as kcv
from fvp_torch.ops.kernels import hourglass as khg
from fvp_torch.ops.kernels import trunk as ktr
from fvp_torch.ops.kernels import deconv_head as kdh
from fvp_torch.ops.kernels import sampler as ksamp
from fvp_torch.ops.kernels import softargmax as ksa
from fvp_torch.ops.kernels import stem as kst
from fvp_torch.ops.kernels import weightnet as kwn

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cfg(J, n, **kw):
    return FVPConfig(num_joints=J, num_views=3, heatmap_size=(60, 32),
                     voxels_per_axis=(16, 16, 8), ind_voxels_per_axis=(n,) * 3,
                     max_people=3, backbone="", **kw)


def _inputs(cfg, dev, B=2, seed=0):
    rng = np.random.RandomState(seed)
    rig = default_ring_rig(cfg.num_views, cfg.space_center,
                           cfg.ori_image_size)
    rc = build_rig_constants(cfg, rig).to(dev)
    w, h = cfg.heatmap_size
    hm = torch.as_tensor(rng.rand(B, cfg.num_views, cfg.num_joints, h, w)
                         .astype(np.float32), device=dev)
    return rng, rig, rc, hm


def _model(J, dev):
    """A model with chip_smoke's seeded weights (task-net convs scaled so
    that outputs are not bias-dominated)."""
    from chip_smoke import random_state_dict

    model = FasterVoxelPose(_cfg(J, 16))
    model.load_state_dict(random_state_dict(model, seed=J))
    return model.to(dev).eval()


@pytest.mark.parametrize("J,B,voxels,outside", [
    (15, 2, (16, 16, 8), False),
    (17, 2, (16, 16, 8), False),
    (15, 1, (15, 13, 7), True),      # N = 1365: a ragged last block
    (17, 2, (9, 11, 5), True),       # N = 495, B = 2
])
def test_whole_sample_kernel(dev, J, B, voxels, outside):
    """B = 1 and 2, N no multiple of the 256-voxel block, and (outside)
    coordinates stretched past the heatmap on every side, so that corners
    fall outside it."""
    import dataclasses

    cfg = _cfg(J, 16).replace(voxels_per_axis=voxels)
    _, _, rc, hm = _inputs(cfg, dev, B=B)
    if outside:
        w, h = cfg.heatmap_size
        px = rc.whole_sample_px.clone()
        px[:, 0] = (px[:, 0] - w / 2) * 1.6 + w / 2
        px[:, 1] = (px[:, 1] - h / 2) * 1.6 + h / 2
        inside = ((px[:, 0] >= 0) & (px[:, 0] <= w - 1)
                  & (px[:, 1] >= 0) & (px[:, 1] <= h - 1))
        assert 0 < float(inside.float().mean()) < 1
        rc = dataclasses.replace(rc, whole_sample_px=px.contiguous())
    got = ksamp.whole_sample(hm, rc, cfg)
    ref = ksamp.whole_sample_plain(hm, rc, cfg)
    assert got.shape == (B, *voxels, J)
    # the same gather arithmetic; the view sum may contract into FMAs
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)


def _crosses_edge(cfg, rc, corner):
    """Whether some voxel of the cube at `corner` projects off the
    heatmap in some view, and some on it."""
    from fvp_torch.geometry.cameras import project_points_uv
    from fvp_torch.geometry.grids import to_sample_px_uv
    from fvp_torch.ops.sampling import cube_positions_uv

    w, h = cfg.heatmap_size
    px, py, pz = cube_positions_uv(corner, cfg)
    rig, out = rc.rig, []
    for v in range(cfg.num_views):
        u, q = project_points_uv(px, py, pz, rig.R[v], rig.T[v], rig.f[v],
                                 rig.c[v], rig.k[v], rig.p[v])
        sx, sy = to_sample_px_uv(u, q, cfg, rc.hm_transform)
        out.append(((sx < 0) | (sx > w - 1) | (sy < 0) | (sy > h - 1))
                   .float().mean())
    frac = torch.stack(out)
    return bool((frac > 0).any() and (frac < 1).any())


@pytest.mark.parametrize("J,n", [(15, 16), (17, 16), (15, 32), (17, 32),
                                 (15, 64), (17, 64)])
def test_person_planes_kernel(dev, J, n):
    """A dead person (empty crop), an unmatched one (outside the mask) and
    one whose footprint crosses the heatmap's edge, beside random ones."""
    from fvp_torch.ops.kernels.sampler import PERSON_LAYOUT, PERSON_PLANES

    cfg = _cfg(J, n)
    rng, _, rc, hm = _inputs(cfg, dev)
    centers = np.stack([rng.uniform(-2500, 2500, (2, 3)),
                        rng.uniform(-3000, 2000, (2, 3)),
                        rng.uniform(400, 1400, (2, 3))], -1)
    centers[1, 2] = [9000.0, 9000.0, 800.0]              # dead: empty crop
    centers[1, 0] = [0.0, 3900.0, 900.0]                 # across the edge
    bbox = rng.uniform(0.2, 1.0, (2, 3, 2))
    bbox[1, 0] = 1.0
    mask = np.array([[True, True, False], [True, True, True]])
    args = [torch.as_tensor(a.astype(np.float32), device=dev)
            for a in (centers, bbox)]
    mask = torch.as_tensor(mask, device=dev)
    before = (PERSON_LAYOUT.launches, PERSON_PLANES.launches)
    got, off = ksamp.person_planes(hm, rc, cfg, *args, mask)
    assert (PERSON_LAYOUT.launches, PERSON_PLANES.launches) == \
        (before[0] + 1, before[1] + 1)
    corner, start, end, off_r = ksamp.person_bounds(*args, mask, cfg)
    assert _crosses_edge(cfg, rc, corner[3])
    ref = ksamp.person_planes_plain(hm, rc, cfg, corner, start, end)
    # the projection rounds as the plain version does, so the taps are the
    # same; the bilinear sums may contract into FMAs
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)
    torch.testing.assert_close(off, off_r)
    assert torch.equal(got > 0, ref > 0)
    assert float(got[:, 2].abs().max()) == 0.0            # unmatched
    assert float(got[:, 5].abs().max()) == 0.0            # dead
    assert float(got[:, 0].max()) > 0.0 and float(got[:, 3].max()) > 0.0


@pytest.mark.parametrize("J", [15, 17])
def test_person_layout_kernel(dev, J):
    hm = torch.rand((2, 3, J, 31, 45), device=dev)
    got = ksamp.pixel_major(hm)
    assert torch.equal(got, ksamp.pixel_major_plain(hm))


@pytest.mark.parametrize("shape", [(2, 80, 80, 15), (1, 40, 24, 17),
                                   (1, 16, 16, 15), (3, 80, 80, 17),
                                   (8, 80, 80, 15)])
def test_centernet_kernel(dev, shape):
    """One launch per call; ragged and small levels ((1, 40, 24, 17): a
    10 x 6 deepest level; (1, 16, 16, 15): stages of fewer tiles than
    SMs), batches of 2 and 3, and the eval engine's batch of 8 BEV maps
    (the persistent cooperative grid at 8x the tiles)."""
    J = shape[-1]
    packed = pack_model(_model(J, dev))["center_net"]
    bev = torch.rand(shape, device=dev)
    before = kcn.CENTERNET.launches
    got = kcn.centernet_forward(packed, bev)
    assert kcn.CENTERNET.launches == before + 1
    ref = kcn.centernet_plain(packed, bev)
    for g, r in zip(got, ref):
        # float32 convs summed in another order than cuDNN's
        assert g.shape == r.shape and torch.isfinite(g).all()
        scale = max(float(r.abs().max()), 1.0)
        torch.testing.assert_close(g, r, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("shape", [(1, 40, 24, 15), (2, 80, 80, 15)])
def test_centernet_stages_one_by_one(dev, shape):
    """The plan's stages launched one by one (plain launches, no grid
    barrier) give the single cooperative launch's outputs, bit for bit:
    every tile is computed by one block in a fixed order either way."""
    packed = pack_model(_model(shape[-1], dev))["center_net"]
    bev = torch.rand(shape, device=dev)
    plan = kcn.centernet_plan(*shape)
    ref = kcn.centernet_forward(packed, bev)
    arena = torch.empty(plan.arena_floats, device=dev)
    for s in range(len(plan.stages)):
        kcn.launch(packed, bev, arena, s, s + 1)
    for g, r in zip(kcn.outputs(plan, arena), ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("J,P,N", [(15, 4, 256), (17, 4, 4096),
                                   (15, 1, 4096), (17, 1, 4096),
                                   (15, 10, 4096), (17, 10, 4096),
                                   (15, 30, 4096), (17, 30, 4096),
                                   (17, 2, 1000), (15, 80, 4096)])
def test_soft_argmax_kernel(dev, J, P, N):
    """One launch a call (G = 1 .. 8 blocks a map of 512 rows; N = 1000
    leaves the last block a ragged chunk; P = 80, the eval engine's 8
    frames of 10 people: 1920 blocks and 80 last-block counters), two calls
    bitwise equal (the blocks' partials and the confidences are added in a
    fixed order)."""
    rng = np.random.RandomState(1)
    planes = rng.randn(3, P, N, J).astype(np.float32) * 0.05
    planes[:, :, rng.randint(0, N), :] += 1.0
    planes = torch.as_tensor(planes, device=dev)
    grid = torch.as_tensor(rng.uniform(-1000, 1000, (3, N, 2))
                           .astype(np.float32), device=dev)
    before = ksa.SOFT_ARGMAX.launches
    c, p = ksa.soft_argmax(planes, grid, 100.0)
    assert ksa.SOFT_ARGMAX.launches == before + 1
    c_r, p_r = ksa.soft_argmax_plain(planes, grid, 100.0)
    # softmax sums in another order: ~1e-6 relative of mm coords
    torch.testing.assert_close(c, c_r, rtol=1e-5, atol=1e-2)
    torch.testing.assert_close(p, p_r, rtol=1e-5, atol=1e-6)
    c2, p2 = ksa.soft_argmax(planes, grid, 100.0)
    assert torch.equal(c2, c) and torch.equal(p2, p)


@pytest.mark.parametrize("J", [15, 17])
def test_soft_argmax_peak_in_the_last_chunk(dev, J):
    """Each map's maximum in the last block's chunk (its last row, and one
    map with it in the first row): the other blocks' exp-sums are rescaled
    by exp(beta (m_g - m_map)) ~ 0 and the last block's carry the map."""
    rng = np.random.RandomState(2)
    P, N = 10, 4096
    plan = ksa.softargmax_plan(3, P, N, J)
    assert plan.ctas_per_map > 1
    planes = rng.randn(3, P, N, J).astype(np.float32) * 0.05
    planes[:, :, N - 1, :] += 1.0
    planes[0, 0, N - 1, :] -= 1.0
    planes[0, 0, 0, :] += 1.0
    planes = torch.as_tensor(planes, device=dev)
    grid = torch.as_tensor(rng.uniform(-1000, 1000, (3, N, 2))
                           .astype(np.float32), device=dev)
    c, p = ksa.soft_argmax(planes, grid, 100.0)
    c_r, p_r = ksa.soft_argmax_plain(planes, grid, 100.0)
    torch.testing.assert_close(c, c_r, rtol=1e-5, atol=1e-2)
    torch.testing.assert_close(p, p_r, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(c[1, 3, 0], grid[1, N - 1], rtol=0, atol=1.0)


@pytest.mark.parametrize("shape,rows", [
    ((6, 16, 16, 15), None), ((4, 64, 64, 17), None),
    ((2, 40, 24, 15), 16), ((30, 64, 64, 15), None), ((1, 6, 258, 100), None),
    ((3, 10, 6, 2), 4), ((240, 64, 64, 15), None)])
def test_weightnet_pool_kernel(dev, shape, rows):
    """(2, 40, 24, 15) in 3 bands (16, 16, 8 rows); (1, 6, 258, 100) in
    chunks of 50 joints; (240, 64, 64, 15): the eval engine's 3 planes of
    80 people; two calls give the same bits (the mean's fixed order)."""
    packed = pack_model(_model(shape[-1], dev))["weight_net"]
    planes = torch.as_tensor(np.random.RandomState(0).randn(*shape)
                             .astype(np.float32), device=dev)

    def call():
        if rows is None:
            return kwn.weightnet_pool(planes, packed)
        out = torch.empty((shape[0], shape[3], 32), device=dev)
        kwn.launch(planes, packed, out, kwn.weightnet_plan(*shape, rows))
        return out

    before = kwn.WEIGHTNET_POOL.launches
    got = call()
    assert kwn.WEIGHTNET_POOL.launches == before + 1
    ref = kwn.weightnet_pool_plain(planes, packed)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    assert torch.equal(call(), got)


def _assert_within_one_bf16_ulp(got, ref):
    """bf16 kernel vs its plain version: the same float32 sums in another
    order, rounded to bf16, so one bf16 ulp (2**-7 of the value) plus the
    float32 summation-order difference (1e-4 of the scale)."""
    g, r = got.float(), ref.float()
    assert g.shape == r.shape and got.dtype == ref.dtype == torch.bfloat16
    bound = 2.0 ** -7 * torch.maximum(g.abs(), r.abs()) \
        + 1e-4 * float(r.abs().max())
    assert bool(((g - r).abs() <= bound).all()), \
        float(((g - r).abs() - bound).max())
    assert float(r.abs().max()) > 0


def _bn_aff(rng, f, dev):
    return torch.as_tensor(np.stack([rng.rand(f) + 0.5, rng.randn(f) * 0.1])
                           .astype(np.float32), device=dev)


@pytest.mark.parametrize("N,H,W", [(2, 100, 90), (1, 37, 61), (3, 64, 64),
                                   # 8 x 16 pooled tiles: ragged in both
                                   # directions, one tile, a 1-pixel row
                                   (1, 70, 130), (2, 9, 9), (1, 257, 95),
                                   (1, 3, 200)])
def test_stem_kernel(dev, N, H, W):
    """Ragged pooled tiles in both directions, and odd conv maps whose far
    pool windows hang over the edge."""
    rng = np.random.RandomState(H)
    x = torch.as_tensor(rng.randn(N, H, W, 3).astype(np.float32), device=dev)
    packed = {"w": torch.as_tensor(rng.randn(7, 7, 3, 64).astype(np.float32)
                                   * 0.1, device=dev).to(torch.bfloat16),
              "aff": _bn_aff(rng, 64, dev)}
    got = kst.stem(x, packed)
    ref = kst.stem_plain(x, packed)
    assert got.shape == (N, kst.out_size(H)[1], kst.out_size(W)[1], 64)
    _assert_within_one_bf16_ulp(got, ref)


@pytest.mark.parametrize("V,H,W,C,F,dtype", [
    (2, 5, 7, 2048, 256, torch.float32),      # Cin 2048, ragged M tile
    (1, 9, 13, 64, 128, torch.bfloat16),
    (3, 16, 30, 256, 256, torch.bfloat16),
    # the three stages of the ResNet-50 head, exactly (stage 1 split along K
    # over a 4-CTA cluster)
    (5, 16, 30, 2048, 256, torch.float32),
    (5, 32, 60, 256, 256, torch.bfloat16),
    (5, 64, 120, 256, 256, torch.bfloat16),
    # one 16 x 8 patch over a 3 x 6 map: it hangs over the right and bottom
    # edges, and its taps over the left and top ones
    (1, 3, 6, 64, 128, torch.bfloat16),
    # 4 x 32 patches whose last row and column hang over the edges
    (2, 5, 37, 128, 128, torch.bfloat16),
])
def test_deconv_stage_kernel(dev, V, H, W, C, F, dtype):
    rng = np.random.RandomState(C + W)
    x = torch.as_tensor(rng.randn(V, H, W, C).astype(np.float32),
                        device=dev).to(dtype)
    w = torch.as_tensor(rng.randn(C, F, 4, 4).astype(np.float32)
                        / np.sqrt(4 * C), device=dev)
    packed = {"w": kdh.pack_deconv_weight(w), "aff": _bn_aff(rng, F, dev)}
    got = kdh.deconv_stage(x, packed)
    ref = kdh.deconv_stage_plain(x, packed)
    assert got.shape == (V, 2 * H, 2 * W, F)
    _assert_within_one_bf16_ulp(got, ref)


def test_wrappers_reject_bad_cuda_input(dev):
    cfg = _cfg(15, 16)
    _, _, rc, hm = _inputs(cfg, dev)
    with pytest.raises(ValueError, match="contiguous"):
        ksamp.whole_sample(hm.transpose(3, 4).contiguous().transpose(3, 4),
                           rc, cfg)
    with pytest.raises(ValueError, match="dtype"):
        ksa.soft_argmax(torch.zeros((3, 2, 64, 15), device=dev,
                                    dtype=torch.float64),
                        torch.zeros((3, 64, 2), device=dev), 100.0)
    with pytest.raises(ValueError, match="multiple of 4"):
        ksa.soft_argmax(torch.zeros((3, 2, 66, 15), device=dev),
                        torch.zeros((3, 66, 2), device=dev), 100.0)
    with pytest.raises(ValueError, match="joints"):
        ksa.soft_argmax(torch.zeros((3, 2, 64, 16), device=dev),
                        torch.zeros((3, 64, 2), device=dev), 100.0)
    with pytest.raises(ValueError, match="Cin % 64"):
        kdh.deconv_stage(torch.zeros((1, 2, 2, 32), device=dev),
                         {"w": torch.zeros((4, 4, 32, 128), device=dev,
                                           dtype=torch.bfloat16),
                          "aff": torch.zeros((2, 128), device=dev)})
    with pytest.raises(ValueError, match="F % 128"):
        kdh.deconv_stage(torch.zeros((1, 2, 2, 64), device=dev),
                         {"w": torch.zeros((4, 4, 64, 96), device=dev,
                                           dtype=torch.bfloat16),
                          "aff": torch.zeros((2, 96), device=dev)})


# kernels the default heatmap path does not launch: the backbone's, the
# fuse_p2p path's and the bottleneck stage (the bf16 image path's layer1)
_FUSE_ONLY = ("p2pnet.conv.wgmma", "p2pnet.conv.wmma", "p2pnet.pool",
              "c2cnet")
_STAGE = ("bottleneck_stage.wgmma", "bottleneck_stage.wmma")
_OFF_HEATMAP_PATH = ("stem", "deconv_stage") + _STAGE + _FUSE_ONLY


def test_predictor_cuda_matches_cpu(dev):
    """The whole slice on the card through every kernel, against the same
    Predictor on the CPU (the plain path)."""
    from chip_smoke import blob_heatmaps, random_state_dict

    # chip_smoke's seeded weights give this small config detection
    # confidences -0.1115, -0.1104, -0.1055: all three clear this gate
    cfg = _cfg(15, 16, min_score=-0.115)
    _, rig, _, _ = _inputs(cfg, dev)
    state = random_state_dict(FasterVoxelPose(cfg), seed=3)
    hm = blob_heatmaps(cfg, rig, seed=0)
    pred = Predictor.from_state_dict(cfg, state, rig, device=dev)
    reset_launches()
    got = pred(hm)
    counts = {n: k.launches for n, k in all_kernels().items()}
    off = {n: counts.pop(n) for n in _OFF_HEATMAP_PATH}
    assert all(c > 0 for c in counts.values()), counts
    assert all(c == 0 for c in off.values()), off
    ref = Predictor.from_state_dict(cfg, state, rig, device="cpu")(hm)
    assert int(ref["mask"].sum()) >= 2
    with torch.inference_mode():
        det = pred.model.detect(torch.as_tensor(hm, device=dev), pred.rc,
                                pred.packed)
    conf = det["proposals"][..., 4]
    assert float((conf - cfg.min_score).abs().min()) > 1e-4
    assert torch.equal(got["mask"].cpu(), ref["mask"])
    torch.testing.assert_close(got["fused_poses"].cpu(), ref["fused_poses"],
                               rtol=1e-5, atol=5e-2)


def test_image_predictor_cuda_matches_cpu(dev):
    """The image path on the card through all seven kernels: a seeded
    ResNet-18 at 128x256, its heatmaps against the CPU's (the trunk's
    float32 sums in another order flip a few bf16 roundings in the stem and
    head: 2e-2 of the scale, as chip_smoke.py states), and the HDN+JLN on
    the card's heatmaps against the CPU on the same heatmaps, every
    proposal through the gate."""
    from chip_smoke import random_state_dict

    from fvp_torch.models.resnet import PoseResNet, seeded_state_dict

    cfg = _cfg(15, 16, min_score=-10.0).replace(
        image_size=(256, 128), heatmap_size=(64, 32), resnet_layers=18)
    _, rig, _, _ = _inputs(cfg, dev)
    state = random_state_dict(FasterVoxelPose(cfg), seed=3)
    bb = seeded_state_dict(PoseResNet(15, 18), seed=1)
    images = np.random.RandomState(2).randn(1, 3, 128, 256, 3).astype(
        np.float32)
    pred = Predictor.from_state_dict(cfg, state, rig, device=dev,
                                     backbone_state_dict=bb)
    reset_launches()
    got = pred(images)
    counts = {n: k.launches for n, k in all_kernels().items()}
    off = {n: counts.pop(n) for n in _FUSE_ONLY + _STAGE}
    assert all(c > 0 for c in counts.values()), counts
    assert all(c == 0 for c in off.values()), off
    cpu = Predictor.from_state_dict(cfg, state, rig, device="cpu",
                                    backbone_state_dict=bb)
    hm = pred.heatmaps(images)
    hm_cpu = cpu.heatmaps(images)
    scale = float(hm_cpu.abs().max())
    torch.testing.assert_close(hm.cpu(), hm_cpu, rtol=0, atol=2e-2 * scale)
    ref = Predictor.from_state_dict(cfg, state, rig, device="cpu")(hm.cpu())
    assert torch.equal(got["mask"].cpu(), ref["mask"])
    assert bool(ref["mask"].all())
    torch.testing.assert_close(got["fused_poses"].cpu(), ref["fused_poses"],
                               rtol=1e-5, atol=5e-2)


def _bf16_layer(rng, taps, cin, f, dev, up=False):
    shape = (2, 2, cin, f) if up else (taps, cin, f)
    w = rng.randn(*shape).astype(np.float32) / np.sqrt(taps * cin)
    return {"w": torch.as_tensor(w, device=dev).to(torch.bfloat16),
            "aff": _bn_aff(rng, f, dev)}


_BF, _F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("N,H,W,cin,f,taps,xdt,res,out", [
    (3, 64, 64, 15, 16, 49, _F32, None, _BF),              # front (wmma)
    (2, 17, 23, 16, 32, 9, _BF, None, _BF),
    (2, 17, 23, 16, 32, 1, _BF, None, _F32),               # proj
    (1, 33, 30, 32, 32, 9, _BF, _BF, _BF),                 # join
    (2, 9, 11, 64, 128, 9, _BF, _F32, _BF),
    (1, 20, 37, 32, 15, 1, _BF, None, _F32),               # output (wmma)
    (1, 19, 37, 256, 64, 1, _BF, None, _BF),
    (1, 19, 37, 64, 256, 1, _BF, _BF, _BF),                # conv3
    (1, 8, 8, 24, 40, 9, _BF, None, _BF),                  # odd C (wmma)
    # conv_wgmma at every K block width (Cin 16, 32, 64..) and N tile
    # (16..256), ragged patches, every residual and output type
    (2, 16, 16, 16, 16, 9, _BF, None, _BF),
    (1, 19, 21, 16, 64, 1, _BF, _F32, _BF),
    (2, 13, 40, 32, 128, 9, _BF, _BF, _F32),
    (1, 24, 9, 64, 32, 9, _BF, _F32, _BF),
    (1, 11, 70, 128, 256, 9, _BF, None, _F32),             # two f32 halves
    (2, 30, 33, 256, 256, 1, _BF, _BF, _BF),
    (1, 7, 5, 256, 16, 1, _BF, _F32, _F32),                # 8 x 16 patch
    (1, 20, 20, 32, 32, 9, _F32, None, _BF),               # x rounded once
    (30, 16, 16, 128, 128, 9, _BF, _F32, _BF),             # 60 tiles < SMs
    (5, 128, 240, 64, 256, 1, _BF, _BF, _BF),              # layer1's widths
])
def test_conv_bf16_kernel(dev, N, H, W, cin, f, taps, xdt, res, out):
    """Every conv of P2PNet and the bottleneck stage, at ragged M tiles, on
    the route conv_plan gives it: one bf16 ulp (float32 outputs: their
    float32 sums in another order)."""
    rng = np.random.RandomState(H * W + f)
    x = torch.as_tensor(rng.randn(N, H, W, cin).astype(np.float32),
                        device=dev).to(xdt)
    layer = _bf16_layer(rng, taps, cin, f, dev)
    r = None if res is None else torch.as_tensor(
        rng.randn(N, H, W, f).astype(np.float32), device=dev).to(res)
    kern = kcv.conv_kernel("test.conv")
    ops = kcv.make_ops(kern)
    route = kcv.conv_plan(N, H, W, cin, f, int(np.sqrt(taps)), 0).route
    for relu in (False, True):
        got = ops.conv(x, layer, res=r, relu=relu, out_dtype=out)
        ref = kcv.conv_plain(x, layer, res=r, relu=relu, out_dtype=out)
        assert got.dtype == ref.dtype == out
        if out == torch.float32:
            scale = float(ref.abs().max())
            torch.testing.assert_close(got, ref, rtol=1e-5,
                                       atol=1e-5 * scale)
        else:
            _assert_within_one_bf16_ulp(got, ref)
    assert getattr(kern, route).launches == 2 and kern.launches == 2


@pytest.mark.parametrize("N,H,W,cin,f", [(3, 8, 8, 128, 64),
                                         (2, 9, 13, 64, 32),
                                         (1, 5, 7, 24, 16),
                                         # conv_wgmma, 4 F = 256, 128, 64
                                         (30, 16, 16, 128, 64),
                                         (1, 3, 37, 256, 32),
                                         (2, 5, 9, 16, 16)])
def test_upconv_and_pool_bf16_kernels(dev, N, H, W, cin, f):
    rng = np.random.RandomState(cin + W)
    x = torch.as_tensor(rng.randn(N, H, W, cin).astype(np.float32),
                        device=dev).to(torch.bfloat16)
    layer = _bf16_layer(rng, 1, cin, f, dev, up=True)
    skip = torch.as_tensor(rng.randn(N, 2 * H, 2 * W, f).astype(np.float32),
                           device=dev).to(torch.bfloat16)
    kern = kcv.conv_kernel("test.conv")
    ops = kcv.make_ops(kern, kcv.pool_kernel("test.pool"))
    _assert_within_one_bf16_ulp(ops.upconv(x, layer, skip),
                                kcv.upconv_plain(x, layer, skip))
    route = kcv.conv_plan(N, H, W, cin, f, 1, 1).route
    assert getattr(kern, route).launches == 1
    x2 = x[:, :H // 2 * 2, :W // 2 * 2].contiguous()
    assert torch.equal(ops.pool(x2), kcv.pool_plain(x2))


def _fuse_model(J, dev, n=32):
    from chip_smoke import random_state_dict

    model = FasterVoxelPose(_cfg(J, n, fuse_p2p=True))
    model.load_state_dict(random_state_dict(model, seed=J))
    return model.to(dev).eval()


@pytest.mark.parametrize("shape", [(3, 36, 44, 15), (2, 64, 64, 17)])
def test_p2pnet_kernel(dev, shape):
    """The whole net: bf16 flips in early layers carry on, so it is held at
    1e-2 of the output's scale (as against the reference on the CPU); each
    layer alone is held at one ulp above."""
    packed = pack_model(_fuse_model(shape[-1], dev))["p2p_net"]
    planes = torch.rand(shape, device=dev)
    before = khg.launches()
    got = khg.p2pnet(packed, planes)
    assert khg.launches() == before + 25
    ref = khg.p2pnet_plain(packed, planes)
    scale = float(ref.abs().max())
    assert scale > 0 and got.shape == ref.shape
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-2 * scale)


C2C_SHAPES = [(13, 8, 15), (7, 12, 17), (10, 20, 15), (40, 20, 15),
              (3, 96, 15)]


def _c2cnet(packed, cols, depth):
    """The kernel on the plan's ring depth (None) or the one given."""
    if depth is None:
        return kc2c.c2cnet(packed, cols)
    out = torch.empty(cols.shape[:2], device=cols.device)
    kc2c.launch(packed, cols, out, kc2c.c2cnet_plan(*cols.shape, depth))
    return out


def _columns(shape, seed, dev):
    return torch.as_tensor(np.random.RandomState(seed).rand(*shape)
                           .astype(np.float32), device=dev)


@pytest.mark.parametrize("depth", [None, 1])
@pytest.mark.parametrize("N,Z,J", C2C_SHAPES)
def test_c2cnet_kernel(dev, N, Z, J, depth):
    """N = 40 (B = 4) runs 20 CTAs; Z = 96 and depth 1 a ring of one
    slot."""
    packed = pack_model(_fuse_model(J, dev))["c2c_net"]
    cols = _columns((N, Z, J), 0, dev)
    before = kc2c.C2C.launches
    got = _c2cnet(packed, cols, depth)
    assert kc2c.C2C.launches == before + 1
    ref = kc2c.c2cnet_plain(packed, cols)
    scale = float(ref.abs().max())
    assert scale > 0 and got.shape == ref.shape == (N, Z)
    torch.testing.assert_close(got, ref, rtol=0, atol=5e-3 * scale)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("N,Z,J", C2C_SHAPES)
def test_c2cnet_kernel_follows_its_emulation(dev, N, Z, J, seed):
    """The kernel against its CPU emulation
    (tests/test_torch_c2cnet_plan.py::emulate), which sums in the kernel's
    order: each k16 step's products exactly, rounded toward zero to
    float32, the steps added in K order. Bit for bit: so where the kernel
    parts from the plain version (cuDNN's float32 sums in another order,
    an activation rounded to the other bf16 neighbour and carried on
    through the net), that is the order of the sums, not a fault of the
    kernel."""
    # pytest puts tests/ on the path (another installed package may be
    # called `tests`)
    from test_torch_c2cnet_plan import emulate

    packed = pack_model(_fuse_model(J, dev))["c2c_net"]
    cols = _columns((N, Z, J), seed, dev)
    got = kc2c.c2cnet(packed, cols).cpu()
    cpu = {k: v.cpu() for k, v in packed.items() if torch.is_tensor(v)}
    ref = emulate(kc2c.c2cnet_plan(N, Z, J), cpu, cols.cpu())
    assert torch.equal(got, ref), float((got - ref).abs().max())


@pytest.mark.parametrize("V,H,W,blocks,cmid,cin", [(2, 19, 37, 3, 16, 32),
                                                   (1, 16, 24, 2, 64, 64)])
def test_bottleneck_stage_kernel(dev, V, H, W, blocks, cmid, cin):
    from fvp_torch.models.resnet import Bottleneck, _down

    torch.manual_seed(V * H)
    mods = []
    for i in range(blocks):
        c = cin if i == 0 else 4 * cmid
        mods.append(Bottleneck(c, cmid, 1, _down(c, 4 * cmid, 1)
                               if i == 0 and c != 4 * cmid else None))
    stage = torch.nn.Sequential(*mods).eval()
    for m in stage.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            torch.nn.init.uniform_(m.weight, 0.5, 1.0)
            torch.nn.init.normal_(m.running_mean, 0, 0.05)
    packed = pack_bottleneck_stage(stage.to(dev))
    cfg = tuple((cmid, stage[i].downsample is not None)
                for i in range(blocks))
    x = torch.randn((V, H, W, cin), device=dev).to(torch.bfloat16)
    got = ktr.bottleneck_stage(x, packed, cfg)
    ref = ktr.bottleneck_stage_plain(x, packed, cfg)
    scale = float(ref.float().abs().max())
    assert scale > 0 and got.shape == ref.shape == (V, H, W, 4 * cmid)
    torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                               atol=1e-2 * scale)


def test_fuse_p2p_predictor_cuda_matches_cpu(dev):
    """The fuse_p2p path on the card through p2pnet and c2cnet (32^3 cubes
    pass the P2PNet gate), against the same Predictor on the CPU."""
    from chip_smoke import blob_heatmaps, random_state_dict

    cfg = _cfg(15, 32, min_score=-10.0, fuse_p2p=True)
    _, rig, _, _ = _inputs(cfg, dev)
    state = random_state_dict(FasterVoxelPose(cfg), seed=3)
    hm = blob_heatmaps(cfg, rig, seed=0)
    pred = Predictor.from_state_dict(cfg, state, rig, device=dev)
    reset_launches()
    got = pred(hm)
    counts = {n: k.launches for n, k in all_kernels().items()}
    assert all(counts[n] > 0 for n in _FUSE_ONLY), counts
    ref = Predictor.from_state_dict(cfg, state, rig, device="cpu")(hm)
    assert bool(ref["mask"].all())
    assert torch.equal(got["mask"].cpu(), ref["mask"])
    # bf16 flips between the card's and the CPU's sums move the soft-argmax
    torch.testing.assert_close(got["fused_poses"].cpu(), ref["fused_poses"],
                               rtol=0, atol=1.0)


@pytest.mark.parametrize("H,W", [(64, 96), (72, 104)])
def test_bf16_trunk_cuda_matches_plain(dev, H, W):
    """The bf16 trunk of a seeded ResNet-50: layer1 on the stage kernel (10
    conv_wgmma launches) and layers 2-4 as bf16 cuDNN copies, against its
    plain version (the stage's plain version, the same modules), and the
    whole bf16 backbone against the CPU's, at bf16 tolerance: each launch
    rounds like its plain op within one ulp, and flips carry on through
    the 16 blocks (2e-2 of the scale, as chip_smoke.py holds the heatmaps);
    (72, 104) leaves ragged stage tiles."""
    from fvp_torch.engine.packing import pack_backbone
    from fvp_torch.models.resnet import PoseResNet, seeded_state_dict

    state = seeded_state_dict(PoseResNet(15, 50), seed=0)
    nets = {}
    for where in (dev, torch.device("cpu")):
        m = PoseResNet(15, 50)
        m.load_state_dict(state)
        m = m.eval().to(where)
        nets[where.type] = (m, pack_backbone(m, "bfloat16"))
    model, packed = nets["cuda"]
    images = torch.as_tensor(np.random.RandomState(4).randn(2, H, W, 3)
                             .astype(np.float32), device=dev)
    with torch.inference_mode():
        x = kst.stem(images, packed["stem"])
        reset_launches()
        got = model.trunk(x, packed)
        assert ktr.CONV.wgmma.launches == 10 and ktr.CONV.wmma.launches == 0
        layer1 = ktr.bottleneck_stage_plain(x, *packed["layer1"])
        ref = _trunk_after_layer1(packed, layer1)
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        scale = float(ref.float().abs().max())
        torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                                   atol=2e-2 * scale)
        hm = model(images, packed)
        cpu, cpu_packed = nets["cpu"]
        hm_cpu = cpu(images.cpu(), cpu_packed)
    scale = float(hm_cpu.abs().max())
    torch.testing.assert_close(hm.cpu(), hm_cpu, rtol=0, atol=2e-2 * scale)


def _trunk_after_layer1(packed, x):
    """Layers 2-4, the bf16 copies in `packed`, on layer1's NHWC bf16
    output."""
    x = x.permute(0, 3, 1, 2)
    for layer in packed["trunk"]:
        x = layer(x)
    return x.permute(0, 2, 3, 1).contiguous()


# ---------------------------------------------------------------------------
# the eval engine's shapes: a batch of B = 8 frames at the flagship widths
# (5 views of 15 joints at 240x128, an 80x80x20 space), P = B * K = 80
# people in 64^3 cubes
# ---------------------------------------------------------------------------

def _flagship(dev, B=8, seed=0):
    cfg = FVPConfig(backbone="")
    rng, rig, rc, hm = _inputs(cfg, dev, B=B, seed=seed)
    return cfg, rng, rig, rc, hm


def test_whole_sample_kernel_at_eval_batch(dev):
    cfg, _, _, rc, hm = _flagship(dev)
    got = ksamp.whole_sample(hm, rc, cfg)
    ref = ksamp.whole_sample_plain(hm, rc, cfg)
    assert got.shape == (8, 80, 80, 20, 15)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)


def test_person_planes_kernel_at_eval_batch(dev):
    """80 people over 8 frames: live ones across the space, some outside
    the mask, one dead (empty crop) per frame."""
    cfg, rng, _, rc, hm = _flagship(dev)
    B, K = 8, cfg.max_people
    centers = np.stack([rng.uniform(-3500, 3500, (B, K)),
                        rng.uniform(-4000, 3000, (B, K)),
                        rng.uniform(0, 1600, (B, K))], -1)
    centers[:, -1] = [9000.0, 9000.0, 800.0]             # dead: empty crop
    bbox = rng.uniform(0.2, 1.0, (B, K, 2))
    mask = rng.rand(B, K) > 0.3
    args = [torch.as_tensor(a.astype(np.float32), device=dev)
            for a in (centers, bbox)]
    mask_t = torch.as_tensor(mask, device=dev)
    got, off = ksamp.person_planes(hm, rc, cfg, *args, mask_t)
    corner, start, end, off_r = ksamp.person_bounds(*args, mask_t, cfg)
    ref = ksamp.person_planes_plain(hm, rc, cfg, corner, start, end)
    assert got.shape == (3, B * K, 64, 64, 15)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)
    torch.testing.assert_close(off, off_r)
    live = got.reshape(3, B * K, -1).amax(dim=(0, 2)) > 0
    assert int(live.sum()) >= 20
    assert not bool(live[torch.as_tensor(~mask.ravel(), device=dev)].any())


def test_render_heatmaps_device_cuda_matches_numpy(dev):
    """The device splat on the card for the eval phase's batch (8 held-out
    synthetic scenes, 5 views, augmentation on) against the numpy
    renderer on the same packed draws."""
    from fvp_torch.config import load_config
    from fvp_torch.data.heatmaps import generate_input_heatmap
    from fvp_torch.data.loader import build_samples, collate
    from fvp_torch.data.registry import build_dataset
    from fvp_torch.ops.heatmap_render import render_heatmaps_device

    cfg = load_config("configs/test/synthetic_convergence_r5.yaml",
                      synthetic_num_data=8)
    ds = build_dataset("synthetic", cfg, is_train=False)
    idx = np.arange(8)
    rp = collate(build_samples(ds, idx, np.random.RandomState(0)))[
        "render_params"]
    got = render_heatmaps_device(cfg, *(
        torch.as_tensor(rp[k], device=dev)
        for k in ("mu", "vis", "sigma", "scale", "occ"))).cpu().numpy()
    for b in idx:
        views_2d, views_vis = ds._project_gt_views(ds.records[b])
        for v, (j2d, jv) in enumerate(zip(views_2d, views_vis)):
            ref = generate_input_heatmap(
                cfg, j2d, joints_vis=jv, augment=True,
                draws=(rp["scale"][b, v], rp["occ"][b, v]))
            np.testing.assert_allclose(got[b, v], ref, rtol=0, atol=1e-5)
    assert got.max() > 0.5


def test_run_validation_cuda_matches_cpu(dev):
    """run_validation on the card against the CPU on the tiny synthetic
    config (20 scenes at batch 8, the last batch padded), chip_smoke's
    seeded weights; the gate in the widest gap of the CPU's detection
    confidences."""
    from chip_smoke import random_state_dict
    from fvp_torch.config import load_config
    from fvp_torch.data.registry import build_dataset
    from fvp_torch.engine.validate import run_validation

    base = load_config("configs/test/tiny_synthetic.yaml",
                       synthetic_num_data=20)
    state = random_state_dict(FasterVoxelPose(base), seed=5)
    ds = build_dataset("synthetic", base, is_train=False)

    def run(cfg, device):
        model = FasterVoxelPose(cfg)
        model.load_state_dict(state)
        return run_validation(cfg, model, ds, device=device,
                              log=lambda s: None)

    conf = np.sort(run(base.replace(min_score=1e9), "cpu")[
        "fused_poses"][..., 0, 4].ravel())
    lo, hi = int(0.3 * len(conf)), int(0.8 * len(conf))
    i = lo + int(np.argmax(np.diff(conf[lo:hi + 1])))
    cfg = base.replace(min_score=float((conf[i] + conf[i + 1]) / 2))
    assert conf[i + 1] - conf[i] > 2e-4
    reset_launches()
    got = run(cfg, dev)
    counts = {n: k.launches for n, k in all_kernels().items()}
    for n in ("whole_sample", "person_planes", "centernet", "soft_argmax",
              "weightnet_pool"):
        assert counts[n] == 3, counts                   # one a batch
    ref = run(cfg, "cpu")
    a, b = got["fused_poses"], ref["fused_poses"]
    mask = a[..., 0, 3] >= 0
    np.testing.assert_array_equal(mask, b[..., 0, 3] >= 0)
    assert 4 <= mask.sum() <= mask.size - 4
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=5e-2)
    assert got["metrics"]["total_gt"] == ref["metrics"]["total_gt"] > 0
    assert got["fps"] > 0


# ---------------------------------------------------------------------------
# float32 means float32: the entry points under PyTorch's default TF32 flags
# ---------------------------------------------------------------------------

@pytest.fixture
def tf32_on(dev):
    """TF32 on for cuDNN convs and matmuls, as PyTorch's default has it
    for convs, for one test; the fixture `dev`'s flags restored after."""
    saved = torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    yield dev
    torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32 = saved


# PyTorch's per-backend TF32 strings, parents before children (writing a
# parent writes its children)
FP32_PRECISION = ("", "cudnn", "cuda.matmul", "cudnn.conv", "cudnn.rnn")


def _backend(name):
    o = torch.backends
    for part in filter(None, name.split(".")):
        o = getattr(o, part)
    return o


@pytest.fixture(params=["allow_tf32", "fp32_precision"])
def tf32_api(request, dev):
    """TF32 switched on through the legacy flags, or through PyTorch's
    newer per-backend strings (torch.backends.fp32_precision = 'tf32',
    under which the legacy flags can no longer be read), for one test;
    every flag restored after. Yields (device, api)."""
    if request.param == "allow_tf32":
        saved = torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        yield dev, request.param
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = saved
        return
    saved = {n: _backend(n).fp32_precision for n in FP32_PRECISION}
    # a parent's string reaches only children left at 'none': `dev` set
    # cuda.matmul through the legacy flag, so name both backends too
    torch.backends.fp32_precision = "tf32"
    torch.backends.cuda.matmul.fp32_precision = "tf32"
    torch.backends.cudnn.conv.fp32_precision = "tf32"
    yield dev, request.param
    for n, v in saved.items():
        _backend(n).fp32_precision = v


def _tf32_still_on(api) -> None:
    """The global flags are left as the caller set them."""
    if api == "allow_tf32":
        assert torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    else:
        assert torch.backends.fp32_precision == "tf32"
        assert torch.backends.cudnn.conv.fp32_precision == "tf32"
        assert torch.backends.cuda.matmul.fp32_precision == "tf32"


def test_predictor_is_float32_under_tf32_flags(tf32_api):
    """test_predictor_cuda_matches_cpu with TF32 switched on first: the
    same masks and poses within the same 5e-2 mm, and the global flags
    left as the caller set them."""
    dev, api = tf32_api
    test_predictor_cuda_matches_cpu(dev)
    _tf32_still_on(api)


def test_run_validation_is_float32_under_tf32_flags(tf32_api):
    dev, api = tf32_api
    test_run_validation_cuda_matches_cpu(dev)
    _tf32_still_on(api)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def test_wrappers_reject_inputs_that_require_grad(dev):
    """No kernel has a backward: a CUDA input that requires grad raises
    rather than give an output cut from the graph."""
    cfg = _cfg(15, 16)
    _, _, rc, hm = _inputs(cfg, dev)
    hm.requires_grad_(True)
    with pytest.raises(ValueError, match="requires grad"):
        ksamp.whole_sample(hm, rc, cfg)
    B, K = hm.shape[0], cfg.max_people
    centers = torch.zeros((B, K, 3), device=dev)
    bbox = torch.full((B, K, 2), 0.5, device=dev)
    mask = torch.ones((B, K), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="requires grad"):
        ksamp.person_planes(hm, rc, cfg, centers, bbox, mask)
    planes = torch.zeros((3, 2, 64, 15), device=dev, requires_grad=True)
    with pytest.raises(ValueError, match="requires grad"):
        ksa.soft_argmax(planes, torch.zeros((3, 64, 2), device=dev), 100.0)
    model = _model(15, dev)
    packed = pack_model(model)
    feats = torch.zeros((6, 16, 16, 15), device=dev, requires_grad=True)
    with pytest.raises(ValueError, match="requires grad"):
        kwn.weightnet_pool(feats, packed["weight_net"])
    bev = torch.zeros((1, 16, 16, 15), device=dev, requires_grad=True)
    with pytest.raises(ValueError, match="requires grad"):
        kcn.centernet_forward(packed["center_net"], bev)


def test_train_step_cuda_matches_cpu(tf32_on):
    """One step of the trainer at the flagship widths (5 views of 240x128
    heatmaps rendered on the device, an 80x80x20 space, 10 people in 64^3
    cubes), chip_smoke's phase 9 first batch of 8 (people matched: the
    joint loss > 0) from its 'flax' init, under TF32 flags (the trainer
    computes float32 without them): the card against the CPU, with
    phase 9's tolerances (the conv biases before a BatchNorm, whose exact
    gradient is 0, not held); K1 and K2 launched once each (K2 with its
    layout), no other kernel."""
    import chip_smoke as cs
    from fvp_torch.config import load_config
    from fvp_torch.data.loader import seq_grouped_batches
    from fvp_torch.data.registry import build_dataset
    from fvp_torch.engine.init import flax_init
    from fvp_torch.engine.train import Trainer, step_inputs

    cfg = load_config(cs.EVAL_CFG, synthetic_num_data=cs.TRAIN_SCENES)
    ds = build_dataset("synthetic", cfg, is_train=True)
    _, batch = next(seq_grouped_batches(ds, cfg.batch_size, cfg.seed, 0))
    init = FasterVoxelPose(cfg)
    flax_init(init, torch.Generator().manual_seed(cfg.seed))
    state = init.state_dict()
    runs = {}
    for device in (tf32_on, "cpu"):
        model = FasterVoxelPose(cfg)
        model.load_state_dict(state)
        tr = Trainer(cfg, model, device)
        rc = build_rig_constants(cfg, ds.rigs["synthetic"]).to(device)
        x, targets, meta = step_inputs(batch, device)
        reset_launches()
        losses = tr.train_step(x, rc, targets, meta)
        counts = {n: k.launches for n, k in all_kernels().items()}
        runs[str(device)] = ({k: float(v) for k, v in losses.items()},
                             {n: p.grad.cpu() for n, p in
                              model.named_parameters()}, counts)
    (lg, gg, cg), (lc, gc, _) = runs["cuda"], runs["cpu"]
    assert lc["joint"] > 0
    assert {n: c for n, c in cg.items() if c} == {
        "whole_sample": 1, "person_planes": 1, "person_planes.layout": 1}
    for k, v in lc.items():
        assert abs(lg[k] - v) <= cs.TRAIN_LOSS_RTOL * max(abs(v), 1e-12), k
    net = {}
    for n, g in gc.items():
        key = ".".join(n.split(".")[:2])
        net[key] = max(net.get(key, 0.0), float(g.abs().max()))
    zero = cs.pre_bn_biases(FasterVoxelPose(cfg))     # exact gradient 0
    assert len(zero) > 40
    for n, g in gc.items():
        if n in zero:
            continue
        tol = cs.TRAIN_GRAD_RTOL * float(g.abs().max()) \
            + cs.TRAIN_GRAD_NET_RTOL * net[".".join(n.split(".")[:2])]
        assert float((gg[n] - g).abs().max()) <= tol, n


def test_train_cli_on_the_card(dev, tmp_path):
    """run/train_torch.py on the tiny synthetic config without --device:
    one epoch on the card, with its evaluation and checkpoint."""
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    text = open(os.path.join(root, "configs/test/tiny_synthetic.yaml")) \
        .read().replace("OUTPUT_DIR: '/tmp/fvp_out'",
                        f"OUTPUT_DIR: '{tmp_path}'")
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(text)
    spec = importlib.util.spec_from_file_location(
        "train_torch", os.path.join(root, "run/train_torch.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    assert cli.main(["--cfg", str(cfg_path), "--epochs", "1"]) == 0
    ckpt = torch.load(tmp_path / "tiny" / "checkpoint.pth",
                      weights_only=True, map_location="cpu")
    assert ckpt["epoch"] == 1 and ckpt["trainer"]["step"] == 3
