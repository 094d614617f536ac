"""The port's `fuse_p2p` path and bottleneck stage on the CPU against the
reference package: the bf16 packers against the reference packers, the
plain versions of the P2PNet, C2CNet and bottleneck-stage kernels (through
their wrappers, on CPU tensors) against the Pallas kernels in interpret
mode, the routing of `fuse_p2p`, and Predictor(device='cpu') with
`fuse_p2p` against FasterVoxelPose.apply(train=False) on the reference's
fused path.

Both sides compute in bf16 operands with float32 sums and round to bf16 at
the same points; only the float32 summation order differs. Where a sum
straddles a rounding boundary the two round one bf16 ulp apart, and the
nets carry such flips on, so each tolerance below is measured and stated
with a margin; all are tighter than the 2e-2 of the output's scale at which
tests/test_hourglass.py holds the Pallas kernels against the float32 flax
modules."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fvp_torch.config as tcfg
import fvp_torch.geometry.cameras as tcam
import fvp_torch.geometry.grids as tgrids
import fvp_torch.models.faster_voxelpose as tfvp
from fvp_torch.engine.packing import (hourglass_layers,
                                      pack_bottleneck_stage, pack_c2cnet,
                                      pack_model, pack_p2pnet)
from fvp_torch.engine.serve import Predictor
from fvp_torch.models.resnet import Bottleneck, _down
from fvp_torch.ops.kernels import all_kernels
from fvp_torch.ops.kernels import c2cnet as kc2c
from fvp_torch.ops.kernels import hourglass as khg
from fvp_torch.ops.kernels import trunk as ktr
from fvp_tpu.geometry.grids import build_rig_constants
from fvp_tpu.models.faster_voxelpose import FasterVoxelPose
from fvp_tpu.ops.pallas import hourglass as jhg
from fvp_tpu.ops.pallas import trunk as jtr
from tests.helpers import random_rig
from tests.test_torch_nets import perturbed_variables, port_model, small_cfg

# P2PNet, plain version vs pallas_p2pnet at (2, 32, 32, 15): measured
# 2.7e-3 of the output's scale (23 convs carry the bf16 flips on).
P2P_RTOL = 1e-2
# C2CNet vs pallas_c2cnet: measured 0 at both shapes (short float32 sums
# over at most 384 terms round alike); a flip would cost ~1 bf16 ulp of an
# activation, about 4e-3 of the scale at the output.
C2C_RTOL = 5e-3
# The bottleneck stage vs pallas_bottleneck_stage, bf16 out: one bf16 ulp
# of the value where the last rounding flips, plus what earlier flips carry
# on: measured 3.6e-3 of the scale (3 blocks; 0.2% of the values differ)
# and 0 (2 blocks).
STAGE_RTOL = 1e-2


@pytest.fixture(scope="module")
def nets():
    cfg = small_cfg(fuse_p2p=True)
    variables = perturbed_variables(cfg, 5)
    return cfg, variables, port_model(cfg, variables)


def _sub(variables, name):
    return {"params": variables["params"][name],
            "batch_stats": variables["batch_stats"][name]}


def _rel_err(got, ref):
    ref = np.asarray(ref, np.float32)
    scale = float(np.abs(ref).max())
    assert scale > 0
    return float(np.abs(np.asarray(got, np.float32) - ref).max()) / scale


def _assert_bf16_equal(got, ref):
    """bf16 weights: bit for bit."""
    g = got.float().numpy()
    r = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    assert g.shape == r.shape
    np.testing.assert_array_equal(g, r)


def _assert_affine_close(got, ref):
    """float32 folded affines: within one float32 ulp."""
    g = got.numpy()
    r = np.asarray(ref, np.float32)
    assert g.shape == r.shape and g.dtype == r.dtype
    np.testing.assert_array_max_ulp(g, r, maxulp=1)


def test_pack_p2pnet_matches_reference(nets):
    _, variables, model = nets
    ref = jhg.pack_p2pnet(_sub(variables, "p2p_net"))
    got = pack_p2pnet(model.joint_net.conv_net)
    layers = hourglass_layers(got)
    assert 2 * len(layers) == len(ref["body"])
    for lay, w_r, a_r in zip(layers, ref["body"][0::2], ref["body"][1::2]):
        _assert_bf16_equal(lay["w"].reshape(w_r.shape), w_r)
        _assert_affine_close(lay["aff"], a_r)
    _assert_bf16_equal(got["final"]["w"][0], ref["final_w"])
    _assert_affine_close(got["final"]["aff"][1:], ref["final_b"])
    np.testing.assert_array_equal(got["final"]["aff"][0].numpy(), 1.0)


def test_pack_c2cnet_matches_reference(nets):
    _, variables, model = nets
    ref = jhg.pack_c2cnet(_sub(variables, "c2c_net"))
    got = pack_c2cnet(model.pose_net.c2c_net)
    layers = hourglass_layers(got)
    assert 2 * len(layers) == len(ref["body"])
    for lay, w_r, a_r in zip(layers, ref["body"][0::2], ref["body"][1::2]):
        _assert_bf16_equal(lay["w"].reshape(w_r.shape), w_r)
        _assert_affine_close(lay["aff"], a_r)
    _assert_bf16_equal(got["final"]["w"], ref["wf"])
    _assert_affine_close(got["final"]["aff"][1:], ref["bf"])
    # the layers are views into the flat buffers, in layer_shapes' order
    shapes = kc2c.layer_shapes(15)
    assert len(shapes) == len(layers) + 1
    w_off = a_off = 0
    for lay, (_, t, ci, f) in zip(layers + [got["final"]], shapes):
        assert tuple(lay["w"].shape)[-2:] == (ci, f)
        assert lay["w"].data_ptr() == got["w_flat"][w_off:].data_ptr()
        assert lay["aff"].data_ptr() == got["aff_flat"][a_off:].data_ptr()
        w_off += t * ci * f
        a_off += 2 * f
    assert (w_off, a_off) == (got["w_flat"].numel(), got["aff_flat"].numel())


@pytest.mark.parametrize("fn", ["p2pnet", "p2pnet_plain"])
def test_p2pnet_matches_pallas(nets, fn):
    _, variables, model = nets
    x = np.random.RandomState(1).rand(2, 32, 32, 15).astype(np.float32)
    assert jhg.hourglass_supported(x.shape)
    ref = jhg.pallas_p2pnet(_sub(variables, "p2p_net"), jnp.asarray(x), 15,
                            interpret=True)
    before = khg.launches()
    got = getattr(khg, fn)(pack_p2pnet(model.joint_net.conv_net),
                           torch.from_numpy(x))
    assert khg.launches() == before
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert _rel_err(got.numpy(), ref) < P2P_RTOL


@pytest.mark.parametrize("shape", [(10, 20, 15), (5, 8, 15)])
def test_c2cnet_matches_pallas(nets, shape):
    """N = 5 is no multiple of the 8 sublanes the reference pads to."""
    _, variables, model = nets
    cols = np.random.RandomState(2).rand(*shape).astype(np.float32)
    ref = jhg.pallas_c2cnet(_sub(variables, "c2c_net"), jnp.asarray(cols),
                            interpret=True)
    before = kc2c.C2C.launches
    got = kc2c.c2cnet(pack_c2cnet(model.pose_net.c2c_net),
                      torch.from_numpy(cols))
    assert kc2c.C2C.launches == before
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert _rel_err(got.numpy(), ref) < C2C_RTOL


def test_hourglass_supported_matches_reference():
    for shape in [(30, 64, 64, 15), (30, 16, 16, 15), (1, 80, 80, 15),
                  (2, 32, 32, 15), (2, 32, 48, 15), (2, 48, 32, 15),
                  (4, 24, 24, 15), (1, 96, 40, 17), (1, 16, 32, 15),
                  (3, 128, 128, 15)]:
        assert khg.hourglass_supported(shape) == \
            jhg.hourglass_supported(shape), shape


# -- the bottleneck stage -----------------------------------------------------

def _stage(rng, blocks: int, cmid: int, cin: int):
    """A port stage of stride-1 Bottlenecks with seeded weights and the
    same weights as the reference's (params, stats) keyed 'layer1_<i>'."""
    mods = []
    for i in range(blocks):
        c = cin if i == 0 else 4 * cmid
        down = _down(c, 4 * cmid, 1) if i == 0 and c != 4 * cmid else None
        mods.append(Bottleneck(c, cmid, 1, down))
    stage = torch.nn.Sequential(*mods).eval()
    params, stats = {}, {}
    for i, blk in enumerate(stage):
        p, s = params.setdefault(f"layer1_{i}", {}), \
            stats.setdefault(f"layer1_{i}", {})
        pairs = [("conv1", blk.conv1, "bn1", blk.bn1),
                 ("conv2", blk.conv2, "bn2", blk.bn2),
                 ("conv3", blk.conv3, "bn3", blk.bn3)]
        if blk.downsample is not None:
            pairs.append(("down_conv", blk.downsample[0], "down_bn",
                          blk.downsample[1]))
        for cname, conv, bname, bn in pairs:
            w = rng.randn(*conv.weight.shape).astype(np.float32) \
                * np.sqrt(2.0 / np.prod(conv.weight.shape[1:]))
            f = w.shape[0]
            g = (1.0 + rng.uniform(-0.1, 0.1, f)).astype(np.float32)
            b, m = (rng.randn(2, f) * 0.05).astype(np.float32)
            var = (1.0 + rng.uniform(0, 0.1, f)).astype(np.float32)
            with torch.no_grad():
                conv.weight.copy_(torch.from_numpy(w))
                for t, a in zip((bn.weight, bn.bias, bn.running_mean,
                                 bn.running_var), (g, b, m, var)):
                    t.copy_(torch.from_numpy(a))
            p[cname] = {"kernel": jnp.asarray(w.transpose(2, 3, 1, 0))}
            p[bname] = {"BatchNorm_0": {"scale": jnp.asarray(g),
                                        "bias": jnp.asarray(b)}}
            s[bname] = {"BatchNorm_0": {"mean": jnp.asarray(m),
                                        "var": jnp.asarray(var)}}
    return stage, params, stats


@pytest.mark.parametrize("blocks,cmid,shape", [
    (3, 16, (2, 32, 48)),      # layer1-like (downsample on block 0)
    (2, 8, (1, 16, 24)),
])
def test_bottleneck_stage_matches_pallas(blocks, cmid, shape):
    rng = np.random.RandomState(blocks)
    V, H, W = shape
    cin = cmid * 2
    stage, params, stats = _stage(rng, blocks, cmid, cin)
    x = jnp.asarray(rng.rand(V, H, W, cin).astype(np.float32) - 0.3
                    ).astype(jnp.bfloat16)
    names = tuple(f"layer1_{i}" for i in range(blocks))
    cfg = tuple((cmid, i == 0) for i in range(blocks))
    ref_packed = jtr.pack_bottleneck_stage(params, stats, names)
    ref = jtr.pallas_bottleneck_stage(x, ref_packed, cfg, R=8,
                                      interpret=True)

    packed = pack_bottleneck_stage(stage)
    flat = []
    for blk in packed:
        flat += [blk["c1"], blk["c2"], blk["c3"]] + \
            ([blk["down"]] if blk["down"] else [])
    assert 2 * len(flat) == len(ref_packed["weights"])
    for lay, w_r, a_r in zip(flat, ref_packed["weights"][0::2],
                             ref_packed["weights"][1::2]):
        _assert_bf16_equal(lay["w"].reshape(w_r.shape), w_r)
        _assert_affine_close(lay["aff"], a_r)

    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16)
    before = ktr.CONV.launches
    got = ktr.bottleneck_stage(xt, packed, cfg)
    assert ktr.CONV.launches == before
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    assert _rel_err(got.float().numpy(), ref.astype(jnp.float32)) \
        < STAGE_RTOL


def test_bottleneck_stage_rejects_mismatched_config():
    stage, _, _ = _stage(np.random.RandomState(0), 2, 8, 16)
    x = torch.zeros((1, 8, 8, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="does not match"):
        ktr.bottleneck_stage(x, pack_bottleneck_stage(stage),
                             ((8, False), (8, False)))


# -- routing ------------------------------------------------------------------

def _port_rc(cfg):
    rig = random_rig(np.random.RandomState(0), num_views=cfg.num_views)
    return tgrids.build_rig_constants(
        tcfg.FVPConfig(**dataclasses.asdict(cfg)),
        tcam.CameraRig(rig.R, rig.T, rig.f, rig.c, rig.k, rig.p)).to("cpu")


def _spy(monkeypatch, name):
    calls = []
    real = getattr(tfvp, name)

    def spy(*a):
        calls.append(a[1].shape)
        return real(*a)

    monkeypatch.setattr(tfvp, name, spy)
    return calls


@pytest.mark.parametrize("fuse", [True, False])
def test_fuse_p2p_routes_nets(nets, monkeypatch, fuse):
    """fuse_p2p on the CPU: the kernels' wrappers (and so their plain
    versions) run and the cuDNN modules do not; off, the reverse."""
    cfg = small_cfg(fuse_p2p=fuse, ind_voxels_per_axis=(32, 32, 32),
                    max_people=2)
    model = port_model(cfg, nets[1])
    packed = pack_model(model)
    assert ("p2p_net" in packed) == ("c2c_net" in packed) == fuse
    p2p, c2c = _spy(monkeypatch, "p2pnet"), _spy(monkeypatch, "c2cnet")
    modules = []
    for net in (model.joint_net.conv_net, model.pose_net.c2c_net):
        net.register_forward_hook(lambda m, i, o: modules.append(type(m)))
    rc = _port_rc(cfg)
    w, h = cfg.heatmap_size
    hm = torch.rand(1, cfg.num_views, cfg.num_joints, h, w)
    with torch.inference_mode():
        out = model(hm, rc, packed)
    assert torch.isfinite(out["fused_poses"]).all()
    if fuse:
        assert p2p == [(6, 32, 32, 15)] and c2c == [(2, 8, 15)]
        assert modules == []
    else:
        assert p2p == c2c == []
        assert sorted(m.__name__ for m in modules) == ["C2CNet", "P2PNet"]


def test_fuse_p2p_keeps_module_where_gate_refuses(nets, monkeypatch):
    """16^3 cubes fail hourglass_supported, as in the reference: P2PNet
    stays the module while C2CNet (Z = 8) takes the kernel's wrapper."""
    cfg = small_cfg(fuse_p2p=True, ind_voxels_per_axis=(16, 16, 16),
                    max_people=2)
    model = port_model(cfg, nets[1])
    p2p, c2c = _spy(monkeypatch, "p2pnet"), _spy(monkeypatch, "c2cnet")
    rc = _port_rc(cfg)
    w, h = cfg.heatmap_size
    with torch.inference_mode():
        model(torch.rand(1, cfg.num_views, cfg.num_joints, h, w), rc,
              pack_model(model))
    assert p2p == [] and c2c == [(2, 8, 15)]


# -- the slice as a whole -----------------------------------------------------

# The perturbed nets below (output heads of CenterNet and C2CNet x30 more,
# as test_torch_model.py does) give detection confidences 0.0762, 0.0870
# and 0.1044; this gate lets two of three through and none lies within
# 1e-4 of it (asserted).
SLICE_MIN_SCORE = 0.08
# fused_poses, port vs reference on the fused path, in mm: both sides run
# P2PNet and C2CNet in bf16 with the same roundings, but the reference's
# WeightNet pool computes in bf16 (its Pallas kernel) where the port's K5
# computes in float32, and the soft-argmax at beta = 100 turns that and the
# nets' bf16 flips into coordinate shifts: measured 0.19 mm.
SLICE_POSE_ATOL_MM = 0.5


def test_predictor_fuse_p2p_matches_reference():
    rng = np.random.RandomState(11)
    cfg = small_cfg(sampling_backend="pallas", fuse_p2p=True,
                    min_score=SLICE_MIN_SCORE, max_people=3,
                    ind_voxels_per_axis=(32, 32, 32),
                    whole_band_height=1024, jln_band_height=1024)
    variables = perturbed_variables(cfg, 7)
    p = variables["params"]
    p["center_net"]["Conv_1"]["kernel"] *= np.float32(30.0)   # hm head
    p["c2c_net"]["Conv_0"]["kernel"] *= np.float32(30.0)      # z head
    rig = random_rig(rng, num_views=cfg.num_views)
    w, h = cfg.heatmap_size
    # bf16 values: the reference's Pallas samplers read bf16 heatmaps
    hm = np.array(jnp.asarray(rng.rand(1, cfg.num_views, cfg.num_joints,
                                       h, w).astype(np.float32))
                  .astype(jnp.bfloat16).astype(jnp.float32))
    # the reference's gates route both nets to its fused kernels
    assert jhg.hourglass_supported((3 * cfg.max_people, 32, 32, 15))
    assert cfg.voxels_per_axis[2] % 4 == 0
    rc = build_rig_constants(cfg, rig)
    ref = jax.jit(lambda v, x: FasterVoxelPose(cfg=cfg).apply(
        v, x, rc, train=False))(variables, jnp.asarray(hm))
    trig = tcam.CameraRig(rig.R, rig.T, rig.f, rig.c, rig.k, rig.p)
    pred = Predictor(tcfg.FVPConfig(**dataclasses.asdict(cfg)), variables,
                     trig, device="cpu")
    out = pred(hm)

    with torch.inference_mode():
        det = pred.model.detect(torch.from_numpy(hm), pred.rc, pred.packed)
    conf = det["proposals"][..., 4].numpy().ravel()
    assert np.min(np.abs(conf - cfg.min_score)) > 1e-4, conf
    assert int(np.sum(np.asarray(ref["mask"]))) >= 2
    np.testing.assert_array_equal(out["mask"].numpy(),
                                  np.asarray(ref["mask"]))
    # proposals: the same voxel picks, and confidences from the same bf16
    # C2CNet (the matched ones carry the JLN's confidence)
    np.testing.assert_allclose(out["proposals"].numpy(),
                               np.asarray(ref["proposals"]),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(out["fused_poses"].numpy(),
                               np.asarray(ref["fused_poses"]),
                               rtol=0, atol=SLICE_POSE_ATOL_MM)
    for k in all_kernels().values():
        assert k.launches == 0, k.name
