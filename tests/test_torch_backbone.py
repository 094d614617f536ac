"""The port's backbone on the CPU against the reference package: the stem
and deconv-head plain versions (and their wrappers on CPU tensors) against
the Pallas kernels in interpret mode, the port PoseResNet against flax
PoseResNet(stem='host_s2d', head='pallas'), the weight round trip through
the reference converter, and Predictor(device='cpu') on images against the
flax backbone + FasterVoxelPose.

The bf16 kernels and their plain versions round the same float32 sums to
bf16; sums taken in another order straddle a rounding boundary now and
then, so they agree within one bf16 ulp (2**-7 of the value) plus the
float32 summation-order difference (below 1e-4 of the output's scale)."""

import dataclasses

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

import fvp_torch.config as tcfg
import fvp_torch.geometry.cameras as tcam
from fvp_torch.engine.packing import bn_affine, pack_backbone
from fvp_torch.engine.serve import Predictor
from fvp_torch.models.convert import _deconv_w, from_jax_backbone_variables
from fvp_torch.models.resnet import PoseResNet, seeded_state_dict
from fvp_torch.ops.kernels import all_kernels
from fvp_torch.ops.kernels import deconv_head as kdh
from fvp_torch.ops.kernels import stem as kst
from fvp_tpu.geometry.grids import build_rig_constants
from fvp_tpu.models.faster_voxelpose import FasterVoxelPose
from fvp_tpu.models.resnet import PoseResNet as FlaxPoseResNet
from fvp_tpu.models.resnet import convert_torch_state
from fvp_tpu.ops.pallas import deconv_head as jdh
from fvp_tpu.ops.pallas.stem import pallas_stem, s2d_host
from tests.helpers import random_rig
from tests.test_torch_nets import perturbed_variables, small_cfg

# The seeded ResNet-18 and the perturbed task nets give detection
# confidences 0.107 .. 0.156 on the frames below; 0.125 lets four of eight
# through and none lies near it (asserted).
MIN_SCORE = 0.125
# Heatmaps, port vs flax: both round the stem's and the head's outputs to
# bf16 after float32 sums taken in another order, so a few values differ by
# one bf16 ulp (2**-8 relative) and the float32 trunk carries that on;
# measured 2.9e-3 of the heatmaps' scale at this size.
HM_RTOL = 1e-2
# Fused poses, port vs flax on images: the heatmaps' differences above move
# the soft-argmax (beta 100) coordinates by ~0.2 mm (measured 0.23 mm).
POSE_ATOL_MM = 1.0


def assert_within_one_bf16_ulp(got, ref):
    g = np.asarray(got, np.float32)
    r = np.asarray(ref, np.float32)
    assert g.shape == r.shape
    err = np.abs(g - r)
    bound = 2.0 ** -7 * np.maximum(np.abs(g), np.abs(r)) \
        + 1e-4 * np.abs(r).max()
    assert np.all(err <= bound), float((err - bound).max())
    assert np.abs(r).max() > 0


def _bn(rng, f):
    return (rng.rand(f).astype(np.float32) + 0.5,
            rng.randn(f).astype(np.float32) * 0.1,
            rng.randn(f).astype(np.float32) * 0.1,
            rng.rand(f).astype(np.float32) + 0.5)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _bf16(a):
    return _t(a).to(torch.bfloat16)


@pytest.mark.parametrize("fn", ["stem_plain", "stem"])
def test_stem_matches_pallas_stem(rng, fn):
    img = rng.randn(2, 128, 192, 3).astype(np.float32)
    k = rng.randn(7, 7, 3, 64).astype(np.float32) * 0.1
    aff = np.asarray(jdh.bn_affine(*map(jnp.asarray, _bn(rng, 64))))
    ref = pallas_stem(jnp.asarray(s2d_host(img)), jnp.asarray(k),
                      jnp.asarray(aff), interpret=True)
    packed = {"w": _bf16(k), "aff": _t(aff)}
    before = kst.STEM.launches
    got = getattr(kst, fn)(torch.from_numpy(img), packed)
    assert got.dtype == torch.bfloat16 and kst.STEM.launches == before
    assert_within_one_bf16_ulp(got.float().numpy(),
                               np.asarray(ref, np.float32))


@pytest.mark.parametrize("variant,W", [("rows1", 14), ("rows2", 14),
                                       ("chunked", 14), ("rows1", 15),
                                       ("chunked", 15)])
def test_deconv_stage_matches_pallas(rng, variant, W):
    """The plain version against both TPU kernels; the odd width pins the
    parity convention and the SAME crop."""
    V, H, C, F = 2, 8, 64, 32
    x = rng.randn(V, H, W, C).astype(np.float32)
    k = rng.randn(4, 4, C, F).astype(np.float32) * 0.05
    aff = np.asarray(jdh.bn_affine(*map(jnp.asarray, _bn(rng, F))))
    k4 = jdh.pack_k4(jnp.asarray(k))
    if variant == "chunked":
        ref = jdh.deconv_stage_chunked(jnp.asarray(x), k4, jnp.asarray(aff),
                                       NC=4, interpret=True)
    else:
        ref = jdh.deconv_stage_rows(jnp.asarray(x), k4, jnp.asarray(aff),
                                    NB=int(variant[-1]), interpret=True)
    packed = {"w": kdh.pack_deconv_weight(_t(_deconv_w(k))),
              "aff": _t(aff)}
    got = kdh.deconv_stage_plain(torch.from_numpy(x), packed)
    assert got.shape == (V, 2 * H, 2 * W, F)
    assert_within_one_bf16_ulp(got.float().numpy(),
                               np.asarray(ref, np.float32))


def test_deconv_stage_wrapper_on_cpu_takes_plain_version(rng):
    """The wrapper on a bf16 CPU tensor (stages 2 and 3 take bf16): the
    plain version's output, bit for bit, and no launch."""
    x = _bf16(rng.randn(1, 4, 5, 32))
    w = torch.from_numpy(rng.randn(32, 16, 4, 4).astype(np.float32) * 0.1)
    packed = {"w": kdh.pack_deconv_weight(w),
              "aff": torch.from_numpy(np.stack([
                  rng.rand(16) + 0.5, rng.randn(16) * 0.1]).astype(
                      np.float32))}
    before = kdh.DECONV.launches
    got = kdh.deconv_head(x, [packed])
    assert torch.equal(got, kdh.deconv_stage_plain(x, packed))
    assert kdh.DECONV.launches == before


def test_packing_matches_reference(rng):
    """pack_deconv_weight against the reference pack_k4 (bit for bit, in
    bf16), its inverse, and bn_affine against the reference fold."""
    C, F = 8, 16
    k = rng.randn(4, 4, C, F).astype(np.float32)
    w = _t(_deconv_w(k))                                 # torch (C, F, 4, 4)
    got = kdh.pack_deconv_weight(w).float().numpy()      # [2r+s, 2u+v]
    k4 = np.asarray(jdh.pack_k4(jnp.asarray(k)).astype(jnp.bfloat16),
                    np.float32)                          # [u, v, r, s]
    ref = k4.transpose(2, 3, 0, 1, 4, 5).reshape(4, 4, C, F)
    np.testing.assert_array_equal(got, ref)
    torch.testing.assert_close(
        kdh.unpack_deconv_weight(kdh.pack_deconv_weight(w)),
        w.to(torch.bfloat16).float(), rtol=0, atol=0)

    scale, bias, mean, var = _bn(rng, F)
    bn = torch.nn.BatchNorm2d(F).eval()
    with torch.no_grad():
        for p, a in zip((bn.weight, bn.bias, bn.running_mean,
                         bn.running_var), (scale, bias, mean, var)):
            p.copy_(torch.from_numpy(a))
    np.testing.assert_allclose(
        bn_affine(bn).numpy(),
        np.asarray(jdh.bn_affine(*map(jnp.asarray, (scale, bias, mean,
                                                    var)))),
        rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def resnet18():
    """A seeded port ResNet-18, its flax variables (the reference
    converter's), 2 frames of 2 views of 128x256 images, and the flax
    PoseResNet(stem='host_s2d', head='pallas') heatmaps of them."""
    port = PoseResNet(15, 18).eval()
    state = seeded_state_dict(port, 0)
    port.load_state_dict(state)
    variables = convert_torch_state({k: v.numpy() for k, v in state.items()},
                                    num_layers=18)
    images = np.random.RandomState(5).randn(2, 2, 128, 256, 3).astype(
        np.float32)
    flax = FlaxPoseResNet(num_joints=15, num_layers=18, stem="host_s2d",
                          head="pallas")
    flat = s2d_host(images.reshape(4, 128, 256, 3))
    hm = np.asarray(jax.jit(lambda v, x: flax.apply(v, x, train=False))(
        variables, jnp.asarray(flat)))                   # (4, 32, 64, J)
    return port, variables, images, hm


def test_pose_resnet_matches_flax(resnet18):
    port, _, images, ref = resnet18
    with torch.inference_mode():
        got = port(torch.from_numpy(images.reshape(4, 128, 256, 3)),
                   pack_backbone(port)).numpy()
    assert got.shape == ref.shape == (4, 32, 64, 15)
    scale = float(np.abs(ref).max())
    # non-vacuous: O(1) heatmaps with spread in every map
    assert 1.0 < scale < 100.0
    assert ref.std(axis=(1, 2)).min() > 1e-2 * scale
    np.testing.assert_allclose(got, ref, rtol=0, atol=HM_RTOL * scale)


def test_seeded_resnet50_keeps_activations_order_one():
    """seeded_state_dict at the serving depth: heatmaps of O(1) scale with
    spread in every joint's map (neither dead nor blown up)."""
    model = PoseResNet(15, 50).eval()
    model.load_state_dict(seeded_state_dict(model, 0))
    img = torch.from_numpy(np.random.RandomState(1).randn(1, 64, 128, 3)
                           .astype(np.float32))
    with torch.inference_mode():
        hm = model(img, pack_backbone(model))
    scale = float(hm.abs().max())
    assert hm.shape == (1, 16, 32, 15) and torch.isfinite(hm).all()
    assert 1.0 < scale < 100.0
    assert float(hm.std(dim=(1, 2)).min()) > 1e-2 * scale


def test_backbone_weights_round_trip_bit_exact():
    """flax ResNet-50 variables -> from_jax_backbone_variables -> port
    state_dict() -> the reference converter: the flax tree again."""
    flax = FlaxPoseResNet(num_joints=15, num_layers=50, stem="host_s2d",
                          head="pallas")
    shapes = jax.eval_shape(
        lambda: flax.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, 32, 32, 16)), train=False))
    rng = np.random.RandomState(3)
    variables = jtu.tree_map(
        lambda s: rng.randn(*s.shape).astype(np.float32), dict(shapes))
    port = PoseResNet(15, 50)
    port.load_state_dict(from_jax_backbone_variables(variables))
    back = convert_torch_state(
        {k: v.numpy() for k, v in port.state_dict().items()}, num_layers=50)
    flat_ref = jtu.tree_flatten_with_path(variables)[0]
    flat_got = dict(jtu.tree_flatten_with_path(back)[0])
    assert len(flat_got) == len(flat_ref)
    for path, ref in flat_ref:
        got = flat_got[path]
        assert got.dtype == ref.dtype and got.shape == ref.shape, path
        np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def image_cfg():
    """The small image config, its perturbed task-net variables (as in
    test_torch_model.py) and a rig, in the flax and the port types."""
    cfg = small_cfg(sampling_backend="exact", min_score=MIN_SCORE,
                    image_size=(256, 128), heatmap_size=(64, 32),
                    resnet_layers=18)
    variables = perturbed_variables(cfg, 7)
    p = variables["params"]
    p["center_net"]["Conv_1"]["kernel"] *= np.float32(30.0)   # hm head
    p["c2c_net"]["Conv_0"]["kernel"] *= np.float32(30.0)      # z head
    rig = random_rig(np.random.RandomState(11), num_views=cfg.num_views)
    trig = tcam.CameraRig(rig.R, rig.T, rig.f, rig.c, rig.k, rig.p)
    return cfg, variables, rig, trig


def test_predictor_on_images_matches_reference(resnet18, image_cfg):
    _, bb_vars, images, hm = resnet18
    cfg, variables, rig, trig = image_cfg
    rc = build_rig_constants(cfg, rig)
    heatmaps = hm.reshape(2, 2, 32, 64, 15).transpose(0, 1, 4, 2, 3)
    ref = jax.jit(lambda v, h: FasterVoxelPose(cfg=cfg).apply(
        v, h, rc, train=False))(variables, jnp.asarray(heatmaps))
    pred = Predictor(tcfg.FVPConfig(**dataclasses.asdict(cfg)), variables,
                     trig, device="cpu", backbone_variables_np=bb_vars)
    out = pred(images)

    # the gate is a hard threshold: every detection confidence clear of it
    # on the port's heatmaps, and the comparison non-vacuous
    with torch.inference_mode():
        det = pred.model.detect(pred.heatmaps(images), pred.rc, pred.packed)
    conf = det["proposals"][..., 4].numpy().ravel()
    assert np.min(np.abs(conf - cfg.min_score)) > 1e-4, conf
    assert int(np.sum(np.asarray(ref["mask"]))) >= 2
    np.testing.assert_array_equal(out["mask"].numpy(),
                                  np.asarray(ref["mask"]))
    np.testing.assert_allclose(out["proposals"].numpy(),
                               np.asarray(ref["proposals"]),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(out["fused_poses"].numpy(),
                               np.asarray(ref["fused_poses"]),
                               rtol=0, atol=POSE_ATOL_MM)
    for k in all_kernels().values():
        assert k.launches == 0, k.name


def test_predictor_with_backbone_without_device_needs_cuda(resnet18,
                                                           image_cfg):
    _, bb_vars, _, _ = resnet18
    cfg, variables, _, trig = image_cfg
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(tcfg.FVPConfig(**dataclasses.asdict(cfg)), variables, trig,
                  backbone_variables_np=bb_vars)


def test_predictor_rejects_heatmap_size_mismatch(resnet18, image_cfg):
    _, bb_vars, images, _ = resnet18
    cfg, variables, _, trig = image_cfg
    bad = tcfg.FVPConfig(**dataclasses.asdict(cfg)).replace(
        heatmap_size=(60, 32))
    pred = Predictor(bad, variables, trig, device="cpu",
                     backbone_variables_np=bb_vars)
    with pytest.raises(ValueError, match="heatmap_size"):
        pred(images[:1])
