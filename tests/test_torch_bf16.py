"""The port's `compute_dtype='bfloat16'` (the reference's serving
configuration, bench.py) on the CPU against the reference package's flax
modules built in bf16: C2CNet and P2PNet as cuDNN-style modules, the
ResNet-50 backbone (layer1 through the bottleneck stage's wrapper, so its
plain version, layers 2-4 as bf16 modules) against flax
PoseResNet(dtype=bfloat16, stem='host_s2d', head='pallas'), and
Predictor(device='cpu') on heatmaps, on images and with `fuse_p2p`
against FasterVoxelPose(compute_dtype='bfloat16').apply(train=False).

Both sides compute in bf16 operands with float32 sums, but round at other
points: the port's serving convs add their bias before the one rounding
to bf16 (flax rounds the conv, then the bias add), its bottleneck stage
rounds where the TPU stage kernel does, and its CenterNet and WeightNet
pool take their bf16 routes, which round where the TPU kernels do (the
reference's flax modules on the 'exact' backend round otherwise). So
each tolerance is bf16's: 2e-2 of the scale on heatmaps and net outputs
(as tests/test_hourglass.py holds the Pallas kernels against the float32
flax modules), and a stated mm tolerance, measured, on the fused poses.
The people are held one by one, paired by voxel pick
(tests/test_torch_pairing.py): two whose BEV scores lie within bf16's
reach of each other may come out of the top-K in either order."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fvp_torch.config as tcfg
import fvp_torch.geometry.cameras as tcam
import fvp_torch.models.resnet as tresnet
from fvp_torch.engine.packing import pack_backbone, pack_model
from fvp_torch.engine.serve import Predictor
from fvp_torch.models.resnet import PoseResNet, seeded_state_dict
from fvp_torch.ops.kernels import all_kernels
from fvp_tpu.geometry.grids import build_rig_constants
from fvp_tpu.models.cnns import C2CNet, P2PNet
from fvp_tpu.models.faster_voxelpose import FasterVoxelPose
from fvp_tpu.models.resnet import PoseResNet as FlaxPoseResNet
from fvp_tpu.models.resnet import convert_torch_state
from fvp_tpu.ops.pallas.stem import s2d_host
from tests.helpers import random_rig
from tests.test_torch_pairing import check_paired
from tests.test_torch_nets import perturbed_variables, port_model, small_cfg

BF16 = dict(compute_dtype="bfloat16")
# heatmaps and net outputs: of their scale
RTOL = 2e-2
# The gates, for the perturbed task nets (heads x30 more, as
# test_torch_model.py has them) on the inputs below: the heatmap and
# fuse_p2p frames' detection confidences are 0.1044, 0.0870 and 0.0762 on
# the port (the reference's bf16 C2CNet and CenterNet move them by up to
# 1e-3), so 0.081 lets two through with 4.5e-3 to spare; the image frame's
# are 0.0910, 0.1078, 0.0727 and 0.0896, and 0.085 lets three through with
# 4.6e-3 to spare. Asserted: at least two pass, none lies within 2e-3.
MIN_SCORE = 0.081
MIN_SCORE_IMG = 0.085
GATE_MARGIN = 2e-3
# fused_poses, port vs reference, in mm: the soft-argmax at beta = 100
# turns the bf16 nets' differences (the rounding points above) into
# coordinate shifts. Measured: 1.15 mm on heatmaps, 1.48 mm on images
# (ResNet-50 heatmaps within 1.1e-2 of their scale), 0.19 mm with
# fuse_p2p (the same bf16 kernels on both sides); 1/20 of a 62.5 mm
# voxel of the 32^3 cubes.
POSE_ATOL_MM = 3.0


def _rel_err(got, ref):
    ref = np.asarray(ref, np.float32)
    scale = float(np.abs(ref).max())
    assert scale > 0
    return float(np.abs(np.asarray(got, np.float32) - ref).max()) / scale


@pytest.fixture(scope="module")
def variables():
    """The perturbed task nets' flax variables (their shapes depend on the
    joints alone, 15 in every config below)."""
    v = perturbed_variables(small_cfg(**BF16), 7)
    p = v["params"]
    p["center_net"]["Conv_1"]["kernel"] *= np.float32(30.0)   # hm head
    p["c2c_net"]["Conv_0"]["kernel"] *= np.float32(30.0)      # z head
    return v


def _sub(variables, name):
    return {"params": variables["params"][name],
            "batch_stats": variables["batch_stats"][name]}


@pytest.mark.parametrize("name", ["p2p_net", "c2c_net"])
def test_bf16_modules_match_flax(variables, name):
    """P2PNet and C2CNet in bf16 up to their float32 heads: the bf16
    copies that the packing makes at load time."""
    model = port_model(small_cfg(**BF16), variables)
    rng = np.random.RandomState(1)
    if name == "p2p_net":
        x = rng.rand(6, 32, 32, 15).astype(np.float32)
        flax, key = P2PNet(num_joints=15, dtype=jnp.bfloat16), "conv_net"
    else:
        x = rng.rand(6, 8, 15).astype(np.float32)
        flax, key = C2CNet(dtype=jnp.bfloat16), "c2c_net"
    ref = np.asarray(jax.jit(lambda v, x: flax.apply(v, x, train=False))(
        _sub(variables, name), jnp.asarray(x)))
    net = pack_model(model, "bfloat16")["bf16_nets"][key]
    with torch.inference_mode():
        got = net(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert _rel_err(got.numpy(), ref) < RTOL


@pytest.fixture(scope="module")
def resnet50():
    """A seeded port ResNet-50, its flax variables, one frame of 2 views of
    64 x 96 images and the flax bf16 PoseResNet's heatmaps of them."""
    port = PoseResNet(15, 50).eval()
    state = seeded_state_dict(port, 0)
    port.load_state_dict(state)
    variables = convert_torch_state({k: v.numpy() for k, v in state.items()},
                                    num_layers=50)
    images = np.random.RandomState(5).randn(1, 2, 64, 96, 3).astype(
        np.float32)
    flax = FlaxPoseResNet(num_joints=15, num_layers=50, stem="host_s2d",
                          head="pallas", dtype=jnp.bfloat16)
    flat = s2d_host(images.reshape(2, 64, 96, 3))
    hm = np.asarray(jax.jit(lambda v, x: flax.apply(v, x, train=False))(
        variables, jnp.asarray(flat)))                   # (2, 16, 24, J)
    return port, state, images, hm


def test_pose_resnet50_bf16_matches_flax(resnet50, monkeypatch):
    """Layer1 through the stage kernel's wrapper (its plain version on the
    CPU, no launch), the trunk's output bf16 into the head."""
    port, _, images, ref = resnet50
    stages, heads = [], []
    stage, head = tresnet.bottleneck_stage, tresnet.deconv_head
    monkeypatch.setattr(tresnet, "bottleneck_stage",
                        lambda x, *a: stages.append(x.shape) or stage(x, *a))
    monkeypatch.setattr(tresnet, "deconv_head",
                        lambda x, *a: heads.append(x) or head(x, *a))
    packed = pack_backbone(port, "bfloat16")
    with torch.inference_mode():
        got = port(torch.from_numpy(images.reshape(2, 64, 96, 3)),
                   packed).numpy()
    assert stages == [(2, 16, 24, 64)]
    assert heads[0].dtype == torch.bfloat16
    assert heads[0].shape == (2, 2, 3, 2048)
    assert got.shape == ref.shape == (2, 16, 24, 15)
    scale = float(np.abs(ref).max())
    assert 1.0 < scale < 100.0
    assert ref.std(axis=(1, 2)).min() > 1e-2 * scale
    assert _rel_err(got, ref) < RTOL
    for k in all_kernels().values():
        assert k.launches == 0, k.name


def _check_predictor(out, ref, det, rc, min_score, what):
    conf = det["proposals"][..., 4].numpy().ravel()
    assert np.min(np.abs(conf - min_score)) > GATE_MARGIN, (what, conf)
    assert int(np.sum(np.asarray(ref["mask"]))) >= 2, what
    # person by person: each reference proposal against the port's at the
    # same voxel pick (mm centres within a float32 rounding), the same
    # voxels on both sides, two slots in the other order only where the
    # reference's BEV scores lie within RTOL of the map's scale (a top-K
    # near-tie that neither side's bf16 arithmetic orders reliably); then
    # per pair the mask, the match index, the confidences and boxes in
    # bf16 and the fused poses
    check_paired(out, ref, rc.voxel_to_mm.numpy(), POSE_ATOL_MM, RTOL)
    for k in all_kernels().values():
        assert k.launches == 0, k.name


def _rigs(cfg, seed=11):
    rng = np.random.RandomState(seed)
    rig = random_rig(rng, num_views=cfg.num_views)
    return rng, rig, tcam.CameraRig(rig.R, rig.T, rig.f, rig.c, rig.k,
                                    rig.p)


@pytest.mark.parametrize("fuse", [False, True])
def test_predictor_bf16_on_heatmaps_matches_reference(variables, fuse):
    """Without fuse_p2p the cuDNN-style bf16 nets (the reference's exact
    sampling path); with it the bf16 kernels' plain versions against the
    reference's fused path (its Pallas kernels in interpret mode)."""
    kw = dict(sampling_backend="pallas", fuse_p2p=True,
              ind_voxels_per_axis=(32, 32, 32), whole_band_height=1024,
              jln_band_height=1024) if fuse else \
        dict(sampling_backend="exact")
    cfg = small_cfg(min_score=MIN_SCORE, max_people=3, **BF16, **kw)
    rng, rig, trig = _rigs(cfg)
    w, h = cfg.heatmap_size
    # bf16 values: the reference's Pallas samplers read bf16 heatmaps
    hm = np.array(jnp.asarray(rng.rand(1, cfg.num_views, cfg.num_joints,
                                       h, w).astype(np.float32))
                  .astype(jnp.bfloat16).astype(jnp.float32))
    rc = build_rig_constants(cfg, rig)
    ref = jax.jit(lambda v, x: FasterVoxelPose(cfg=cfg).apply(
        v, x, rc, train=False))(variables, jnp.asarray(hm))
    pred = Predictor(tcfg.FVPConfig(**dataclasses.asdict(cfg)), variables,
                     trig, device="cpu")
    out = pred(hm)
    with torch.inference_mode():
        det = pred.model.detect(torch.from_numpy(hm), pred.rc, pred.packed)
    # the nets' raw maps: CenterNet's bf16 route here, the reference's
    # bf16 module or kernel there
    assert _rel_err(det["hm2d"].numpy(), ref["hm2d"]) < RTOL
    assert _rel_err(det["hm1d"].numpy(), ref["hm1d"]) < RTOL
    _check_predictor(out, ref, det, pred.rc, cfg.min_score,
                     "fuse_p2p" if fuse else "heatmaps")


def test_predictor_bf16_on_images_matches_reference(variables, resnet50):
    """The image predictor: the bf16 backbone's heatmaps within RTOL of
    flax's, then the HDN + JLN in bf16 against the reference on flax's
    heatmaps."""
    _, state, images, hm = resnet50
    cfg = small_cfg(sampling_backend="exact", min_score=MIN_SCORE_IMG,
                    image_size=(96, 64), heatmap_size=(24, 16),
                    resnet_layers=50, **BF16)
    _, rig, trig = _rigs(cfg)
    heatmaps = hm.reshape(1, 2, 16, 24, 15).transpose(0, 1, 4, 2, 3)
    rc = build_rig_constants(cfg, rig)
    ref = jax.jit(lambda v, x: FasterVoxelPose(cfg=cfg).apply(
        v, x, rc, train=False))(variables, jnp.asarray(heatmaps))
    pred = Predictor(tcfg.FVPConfig(**dataclasses.asdict(cfg)), variables,
                     trig, device="cpu",
                     backbone_variables_np=convert_torch_state(
                         {k: v.numpy() for k, v in state.items()},
                         num_layers=50))
    assert pred.backbone_packed["compute_dtype"] == "bfloat16"
    assert "layer1" in pred.backbone_packed
    got_hm = pred.heatmaps(images)
    assert _rel_err(got_hm.numpy(), heatmaps) < RTOL
    out = pred(images)
    with torch.inference_mode():
        det = pred.model.detect(got_hm, pred.rc, pred.packed)
    _check_predictor(out, ref, det, pred.rc, cfg.min_score, "images")
