"""The bf16 routes of CenterNet and WeightNet's pool (the kernels that
`compute_dtype='bfloat16'` takes on the card) through their plain
versions, against the reference's TPU kernels in interpret mode on the
same seeded inputs: fvp_tpu/ops/pallas/hourglass.py::pallas_centernet and
fvp_tpu/ops/pallas/weightnet.py::pallas_weightnet_pool, which compute in
bf16 inside. Both sides round at the same points, so only the order of the
float32 sums differs; a sum that lands on either side of a bf16 rounding
boundary moves one value by one bf16 ulp and carries on through the net.
Then the Predictor under bf16 with sampling_backend='pallas' against the
reference's fused path (its Pallas kernels in interpret mode)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fvp_torch.config as tcfg
from fvp_torch.engine.packing import (pack_centernet_bf16, pack_model,
                                      pack_weightnet_bf16)
from fvp_torch.engine.serve import Predictor
from fvp_torch.ops.kernels import all_kernels
from fvp_torch.ops.kernels.centernet import centernet_bf16
from fvp_torch.ops.kernels.weightnet import weightnet_pool_bf16
from fvp_tpu.geometry.grids import build_rig_constants
from fvp_tpu.ops import fast_sampling
from fvp_tpu.models.faster_voxelpose import FasterVoxelPose
from fvp_tpu.ops.pallas.hourglass import pallas_centernet
from fvp_tpu.ops.pallas.weightnet import pallas_weightnet_pool
from tests.test_torch_bf16 import (BF16, GATE_MARGIN, MIN_SCORE,
                                   POSE_ATOL_MM, RTOL, _rel_err, _rigs)
from tests.test_torch_nets import perturbed_variables, port_model, small_cfg
from tests.test_torch_pairing import check_paired
from tests.test_torch_validate import _snap_centers_op_by_op

# Measured, port's plain version against the interpret-mode kernel on the
# inputs below: WeightNet's pooled features 0 (bit for bit: 9 exact
# products of bf16 values, the same float32 affine), CenterNet's maps
# within 6.5e-3 of their scale (one-ulp flips of the bf16 activations
# where the conv sums land on a rounding boundary in another order).
POOL_TOL = 1e-6
CENTERNET_TOL = 1e-2


def _sub(variables, name):
    return {"params": variables["params"][name],
            "batch_stats": variables["batch_stats"][name]}


@pytest.fixture(scope="module")
def variables():
    v = perturbed_variables(small_cfg(**BF16), 7)
    v["params"]["center_net"]["Conv_1"]["kernel"] *= np.float32(30.0)
    v["params"]["c2c_net"]["Conv_0"]["kernel"] *= np.float32(30.0)
    return v


@pytest.fixture(scope="module")
def model(variables):
    return port_model(small_cfg(**BF16), variables)


def test_weightnet_pool_bf16_matches_tpu_kernel(variables, model):
    planes = np.random.RandomState(4).rand(6, 16, 16, 15).astype(np.float32)
    v = _sub(variables, "weight_net")
    p, s = v["params"], v["batch_stats"]
    from fvp_tpu.ops.pallas.deconv_head import bn_affine
    aff = bn_affine(p["BatchNorm_0"]["scale"], p["BatchNorm_0"]["bias"],
                    s["BatchNorm_0"]["mean"], s["BatchNorm_0"]["var"])
    ref = np.asarray(pallas_weightnet_pool(
        jnp.asarray(planes), p["Conv_0"]["kernel"], p["Conv_0"]["bias"],
        aff, interpret=True))
    packed = pack_weightnet_bf16(model.joint_net.weight_net)
    assert packed["w"].dtype == torch.bfloat16
    assert not packed["w"][9:].any()
    got = weightnet_pool_bf16(torch.from_numpy(planes), packed).numpy()
    assert got.shape == ref.shape == (6, 15, 32)
    assert float(np.abs(ref).max()) > 1e-2
    err = _rel_err(got, ref)
    print(f"weightnet_pool_bf16 vs the TPU kernel: {err:.3e} of scale")
    assert err < POOL_TOL
    assert all_kernels()["weightnet_pool_bf16"].launches == 0


@pytest.mark.parametrize("batch", [1, 2])
def test_centernet_bf16_matches_tpu_kernel(variables, model, batch):
    bev = np.random.RandomState(6 + batch).rand(batch, 32, 32, 15) \
        .astype(np.float32)
    hm_r, size_r = pallas_centernet(_sub(variables, "center_net"),
                                    jnp.asarray(bev), interpret=True)
    packed = pack_centernet_bf16(model.pose_net.center_net)
    hm, size = centernet_bf16(packed, torch.from_numpy(bev))
    assert hm.shape == hm_r.shape == (batch, 32, 32, 1)
    assert size.shape == size_r.shape == (batch, 32, 32, 2)
    assert hm.dtype == size.dtype == torch.float32
    e_hm, e_size = _rel_err(hm, hm_r), _rel_err(size, size_r)
    print(f"centernet_bf16 vs the TPU kernel (B = {batch}): hm {e_hm:.3e}, "
          f"size {e_size:.3e} of scale")
    assert e_hm < CENTERNET_TOL and e_size < CENTERNET_TOL
    for name in ("centernet_bf16.conv.wgmma", "centernet_bf16.conv.wmma",
                 "centernet_bf16.pool"):
        assert all_kernels()[name].launches == 0


def test_pack_model_bf16_routes(model):
    packed = pack_model(model, "bfloat16")
    assert {"center_net_bf16", "weight_net_bf16"} <= set(packed)
    assert "center_net_bf16" not in pack_model(model, "float32")


def test_predictor_bf16_pallas_matches_reference(variables, monkeypatch):
    """The Predictor under bf16 with fuse_p2p (its CenterNet and pool on
    their bf16 routes' plain versions, C2CNet and P2PNet on the bf16
    kernels' plain versions) against the reference's fused path, every
    net on a Pallas kernel in interpret mode: its CenterNet as
    pallas_centernet (32 x 32 cells pass its gate), its pool as
    pallas_weightnet_pool."""
    cfg = small_cfg(min_score=MIN_SCORE, max_people=3,
                    voxels_per_axis=(32, 32, 8), sampling_backend="pallas",
                    fuse_p2p=True, ind_voxels_per_axis=(32, 32, 32),
                    whole_band_height=1024, jln_band_height=1024, **BF16)
    rng, rig, trig = _rigs(cfg)
    w, h = cfg.heatmap_size
    hm = np.array(jnp.asarray(rng.rand(1, cfg.num_views, cfg.num_joints,
                                       h, w).astype(np.float32))
                  .astype(jnp.bfloat16).astype(jnp.float32))
    rc = build_rig_constants(cfg, rig)
    # every person here snaps its cube corner from an exact x.5 tie, which
    # the jitted reference rounds either way (its XLA contracts the snap's
    # multiply-add; ROADMAP Queue 3): its corner op by op, as the port
    # computes it (tests/test_torch_validate.py)
    monkeypatch.setattr(fast_sampling, "snap_centers",
                        _snap_centers_op_by_op)
    ref = jax.jit(lambda v, x: FasterVoxelPose(cfg=cfg).apply(
        v, x, rc, train=False))(variables, jnp.asarray(hm))
    pred = Predictor(tcfg.FVPConfig(**dataclasses.asdict(cfg)), variables,
                     trig, device="cpu")
    out = pred(hm)
    with torch.inference_mode():
        det = pred.model.detect(torch.from_numpy(hm), pred.rc, pred.packed)
    e = _rel_err(det["hm2d"].numpy(), ref["hm2d"])
    print(f"bf16 Predictor hm2d vs the reference's pallas_centernet: "
          f"{e:.3e} of scale")
    assert e < RTOL
    # the gate: detection confidences 0.0854, 0.0924 and 0.0723 on the
    # port, so MIN_SCORE lets two through, none within GATE_MARGIN
    conf = det["proposals"][..., 4].numpy().ravel()
    assert np.min(np.abs(conf - cfg.min_score)) > GATE_MARGIN, conf
    assert int(np.sum(np.asarray(ref["mask"]))) >= 2
    check_paired(out, ref, pred.rc.voxel_to_mm.numpy(), POSE_ATOL_MM, RTOL)


@pytest.fixture
def world1():
    import torch.distributed as dist
    from fvp_torch.parallel.mesh import free_port, init_distributed
    init_distributed(f"127.0.0.1:{free_port()}", 1, 0, "cpu")
    yield
    dist.destroy_process_group()


def test_spatial_centernet_bf16_is_the_module(model, world1):
    """The spatial path keeps the CenterNet module, which computes in bf16
    under 'bfloat16' there too: on one 'space' rank its halo convs (the
    outer halos zeros, y padded alone) give the module's own maps within
    a bf16 flip (the same sums over explicitly padded rows)."""
    from fvp_torch.parallel import make_spatial_mesh
    from fvp_torch.parallel.spatial import spatial_centernet
    net = model.pose_net.center_net
    assert net.front_layers[0].block[0].compute_dtype == torch.bfloat16
    bev = torch.from_numpy(np.random.RandomState(9).rand(1, 16, 16, 15)
                           .astype(np.float32))
    with torch.inference_mode():
        want = net.bev_forward(bev)
        got = spatial_centernet(net, bev, make_spatial_mesh(1))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float32
        assert _rel_err(g.numpy(), w.numpy()) < 1e-2
