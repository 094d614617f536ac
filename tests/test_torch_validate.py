"""The port's run_validation (fvp_torch/engine/validate.py) on the CPU
against the reference package's (fvp_tpu/engine/validate.py) on the tiny
synthetic config with the same weights (from_jax_variables), DEVICE_RENDER
on and off, 10 held-out scenes at batch 8 (the second batch padded).

The reference runs twice. As it is, jitted: identical masks, and fused
poses within 1e-2 mm for every person whose cube-corner snap is not an
exact float32 tie (x.5), which must be most of them. On such a tie the
reference's XLA contracts the snap's multiply-add
(fvp_tpu/ops/sampling.py:102) into one fused multiply-add and rounds the
other way, a whole fine voxel; op by op (jax.disable_jit) it rounds as the
port does. Then with its snap_centers computing the corner op by op
(float32 numpy on the host through a callback, checked against the
reference's own snap_centers without jit): every person within 1e-2 mm,
and equal metrics.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fvp_torch.config as tcfg
import fvp_tpu.data.native as jnative
import fvp_tpu.ops.sampling as jsampling
from fvp_torch.data.loader import build_samples, collate
from fvp_torch.data.registry import build_dataset as tbuild
from fvp_torch.engine.serve import Engine
from fvp_torch.engine.validate import (RENDER_KEYS, batch_input, eval_batches,
                                       eval_rng, run_validation)
from fvp_torch.ops.heatmap_render import render_heatmaps_device
from fvp_torch.ops.kernels import all_kernels
from fvp_torch.ops.sampling import snap_centers as t_snap
from fvp_tpu.config import load_config
from fvp_tpu.data.registry import build_dataset as jbuild
from fvp_tpu.engine import validate as jval
from fvp_tpu.geometry.grids import build_rig_constants
from fvp_tpu.models.faster_voxelpose import FasterVoxelPose
from fvp_tpu.ops.sampling import snap_centers as j_snap
from tests.test_torch_nets import perturbed_variables, port_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs/test/tiny_synthetic.yaml")
NUM_DATA = 10          # batches of 8 and 2 padded to 8
POSE_ATOL_MM_CPU = 1e-2


def _variables(cfg):
    """Seeded weights whose kept people mostly pick voxels off the edges
    of the space (where the snap ties lie): CenterNet's heatmap head
    scaled x30 and both confidence heads' biases raised by 2, which
    spreads the detection confidences (their product) well apart."""
    v = perturbed_variables(cfg, 0)
    p = v["params"]
    p["center_net"]["Conv_1"]["kernel"] *= np.float32(30.0)   # hm head
    p["center_net"]["Conv_1"]["bias"] += np.float32(2.0)
    p["c2c_net"]["Conv_0"]["bias"] += np.float32(2.0)          # z head
    return v


def _gate(conf):
    """min_score in the widest gap of the middle of the confidences (so
    that a good share of people pass and a good share do not), with its
    distance to the nearest confidence."""
    c = np.sort(conf.ravel())
    lo, hi = int(0.3 * len(c)), int(0.8 * len(c))
    i = lo + int(np.argmax(np.diff(c[lo:hi + 1])))
    return float((c[i] + c[i + 1]) / 2), float((c[i + 1] - c[i]) / 2)


def _proposals(cfg, model, ds):
    """The port's proposals (NUM_DATA, K, 7) in record order, from each
    eval batch's inputs as run_validation draws them (its fixed eval RNG)
    through the HDN alone. Their centers and confidences do not depend on
    min_score."""
    engine = Engine(cfg, model, "cpu")
    rng = eval_rng(cfg)
    out = None
    for seq, idx, valid in eval_batches(ds, cfg.test_batch_size):
        x = batch_input(collate(build_samples(ds, idx, rng=rng)), "cpu")
        rc = engine.rig_constants(ds.rigs[seq])
        with torch.inference_mode():
            hm = render_heatmaps_device(cfg, *(x[k] for k in RENDER_KEYS)) \
                if isinstance(x, dict) else x
            p = engine.model.detect(hm, rc, engine.packed)["proposals"]
        if out is None:
            out = np.zeros((len(ds),) + tuple(p.shape[1:]), np.float32)
        out[idx[:valid]] = p.numpy()[:valid]
    return out


@functools.lru_cache(maxsize=None)
def _weights():
    return _variables(load_config(TINY))


def _host_corner(cfg, centers):
    """snap_centers' corner in float32 numpy, one rounding per operation
    (the reference's arithmetic op by op)."""
    space = np.asarray(cfg.space_size, np.float32)
    center = np.asarray(cfg.space_center, np.float32)
    ind = np.asarray(cfg.ind_space_size, np.float32)
    fine = np.asarray(cfg.fine_voxels_per_axis, np.float32)
    scale = (fine - np.float32(1.0)) / space
    bias = -ind / np.float32(2.0) / space * (fine - np.float32(1.0)) \
        - scale * (center - space / np.float32(2.0))
    return np.round(np.asarray(centers, np.float32) * scale + bias) \
        .astype(np.int32)


def _snap_centers_op_by_op(centers_mm, cfg):
    """The reference's snap_centers with its corner from _host_corner."""
    corner = jax.pure_callback(
        functools.partial(_host_corner, cfg),
        jax.ShapeDtypeStruct(centers_mm.shape, jnp.int32), centers_mm,
        vmap_method="expand_dims")
    space = jnp.asarray(cfg.space_size, jnp.float32)
    ind = jnp.asarray(cfg.ind_space_size, jnp.float32)
    fine = jnp.asarray(cfg.fine_voxels_per_axis, jnp.float32)
    offset = corner.astype(jnp.float32) / (fine - 1.0) * space \
        - space / 2.0 + ind / 2.0
    return corner, offset


def _reference(cfg, variables, op_by_op_snap):
    ds = jbuild("synthetic", cfg, is_train=False)
    rcs = {seq: jax.tree_util.tree_map(jnp.asarray,
                                       build_rig_constants(cfg, rig))
           for seq, rig in ds.rigs.items()}
    with pytest.MonkeyPatch.context() as mp:
        if op_by_op_snap:
            mp.setattr(jsampling, "snap_centers", _snap_centers_op_by_op)
        return jval.run_validation(cfg, FasterVoxelPose(cfg=cfg), variables,
                                   ds, rcs, log=lambda s: None)


@pytest.fixture(scope="module", params=[True, False],
                ids=["device_render", "host_render"])
def both_runs(request):
    """The port's run_validation and the reference's (as it is, and with
    its snap op by op) on the tiny config, the gate chosen from the port's
    detection confidences."""
    with pytest.MonkeyPatch.context() as mp:
        # the reference's host renderer on its numpy path, the port's
        mp.setattr(jnative, "get_lib", lambda: None)
        cfg = load_config(TINY, synthetic_num_data=NUM_DATA,
                          device_render=request.param)
        variables = _weights()
        tc = tcfg.FVPConfig(**dataclasses.asdict(cfg))
        ds_t = tbuild("synthetic", tc, is_train=False)
        props = _proposals(tc, port_model(cfg, variables), ds_t)
        min_score, margin = _gate(props[..., 4])
        cfg = cfg.replace(min_score=min_score)
        got = run_validation(tcfg.FVPConfig(**dataclasses.asdict(cfg)),
                             port_model(cfg, variables), ds_t, device="cpu",
                             log=lambda s: None)
        ref = _reference(cfg, variables, op_by_op_snap=True)
        ref_jit = _reference(cfg, variables, op_by_op_snap=False)
    return cfg, got, ref, ref_jit, props, margin


def test_host_corner_is_the_references_op_by_op_snap(both_runs):
    cfg, _, _, _, props, _ = both_runs
    centers = props[..., :3].reshape(-1, 3)
    with jax.disable_jit():
        ref = np.asarray(j_snap(jnp.asarray(centers), cfg)[0])
    np.testing.assert_array_equal(_host_corner(cfg, centers), ref)


def test_run_validation_matches_reference(both_runs):
    cfg, got, ref, _, _, margin = both_runs
    a, b = got["fused_poses"], ref["fused_poses"]
    assert a.shape == b.shape == (NUM_DATA, cfg.max_people,
                                  cfg.num_joints, 5)
    mask = a[..., 0, 3] >= 0
    np.testing.assert_array_equal(mask, b[..., 0, 3] >= 0)
    assert margin > 1e-4 and 4 <= mask.sum() <= mask.size - 4, margin
    np.testing.assert_allclose(a, b, rtol=0, atol=POSE_ATOL_MM_CPU)
    # metrics: AP and recall equal, MPJPE within 1e-3 mm
    mg, mr = got["metrics"], ref["metrics"]
    assert mg["ap"] == mr["ap"] and mg["total_gt"] == mr["total_gt"] > 0
    assert mg["recall@500"] == mr["recall@500"]
    assert mg["mpjpe@500"] == pytest.approx(mr["mpjpe@500"], abs=1e-3) \
        or mg["mpjpe@500"] == mr["mpjpe@500"] == np.inf
    assert got["fps"] > 0 and set(got["batch_ms"]) == {"mean", "min", "max"}
    for k in all_kernels().values():
        assert k.launches == 0, k.name


def test_run_validation_against_jitted_reference(both_runs):
    """The reference as it is, jitted: identical masks; every kept person
    within 1e-2 mm unless its cube corner's snap is an exact tie (on which
    the port's corner is the reference's op-by-op corner), and most kept
    people no tie."""
    cfg, got, _, ref_jit, props, _ = both_runs
    a, b = got["fused_poses"], ref_jit["fused_poses"]
    mask = a[..., 0, 3] >= 0
    np.testing.assert_array_equal(mask, b[..., 0, 3] >= 0)
    centers = props[mask][:, :3]
    c_port = t_snap(torch.from_numpy(centers), cfg)[0].numpy()
    with jax.disable_jit():
        c_eager = np.asarray(j_snap(jnp.asarray(centers), cfg)[0])
    np.testing.assert_array_equal(c_port, c_eager)
    fine = np.asarray(cfg.fine_voxels_per_axis, np.float64)
    space = np.asarray(cfg.space_size, np.float64)
    lo = np.asarray(cfg.space_center, np.float64) - space / 2
    exact = (centers - lo) * (fine - 1) / space \
        - np.asarray(cfg.ind_space_size) / 2 / space * (fine - 1)
    tie = (np.abs(np.abs(exact - np.floor(exact)) - 0.5) < 1e-4).any(axis=1)
    assert 4 <= mask.sum() and tie.sum() < mask.sum() / 2, (mask.sum(), tie)
    err = np.abs(a[mask] - b[mask]).max(axis=(1, 2))
    assert (err[~tie] <= POSE_ATOL_MM_CPU).all(), (err, tie)
