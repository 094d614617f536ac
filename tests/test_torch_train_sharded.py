"""The port's data-parallel train step
(fvp_torch/parallel/sharding.py::make_sharded_train_step) on the CPU over
gloo, at tests/test_parallel.py's `par_cfg` (2 views of 60x32, a 32x32x8
space, K = 4, the HDN window k = 2) with batches of 4 scenes. One
spawned job of four ranks on a (2 data, 2 view) mesh runs the
distributed BatchNorms against one process on the joined batch, then two
sharded steps (`tests/torch_ranks.py::train_rank`); they are held
against the reference package's make_sharded_train_step on its
make_mesh(2, 2) and against the port's single-device Trainer. A (1, 1)
mesh is `Trainer.train_step` bit for bit.

The batches are tests/test_torch_train_lockstep.py's: the synthetic
scenes with their people moved onto the model's own train-mode proposals
off the space's edge voxels (no snap tie, ROADMAP Queue 3 item 3), 1, 0,
2 and 1 people in the first batch's scenes (so rank row 0 holds a scene
that matches nobody) and 0, 1, 1 and 2 in the second's."""

import dataclasses
import functools

import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch
import torch.distributed as dist

import fvp_torch.config as tcfg
import fvp_torch.geometry.cameras as tcam
from fvp_torch.engine.train import Trainer
from fvp_torch.geometry.grids import build_rig_constants as \
    port_rig_constants
from fvp_torch.models.blocks import BatchNorm2d
from fvp_torch.models.convert import from_jax_variables
from fvp_torch.models.faster_voxelpose import FasterVoxelPose as TModel
from fvp_torch.parallel import (make_mesh, make_sharded_train_step,
                                shard_batch, shard_data)
from fvp_torch.parallel.mesh import free_port, init_distributed
from fvp_tpu.engine.train import TrainState, make_optimizers
from fvp_tpu.geometry.grids import build_rig_constants
from fvp_tpu.models.convert_tasknets import convert_task_nets
from fvp_tpu.models.faster_voxelpose import FasterVoxelPose
from fvp_tpu.parallel.mesh import make_mesh as ref_make_mesh
from fvp_tpu.parallel.sharding import make_sharded_train_step as ref_step
from tests.helpers import random_rig
from tests.test_parallel import par_cfg
from tests.test_torch_spatial import _variables
from tests.test_torch_train_lockstep import make_batches
from tests.torch_ranks import run_ranks, train_rank

SHAPE = (2, 2)
# people of each scene of the two batches (rank row 0 holds scenes 0-1)
PEOPLE = [(1, 0, 2, 1), (0, 1, 1, 2)]
# Sharded against the single Trainer (both the port, float32): the
# sharded step sums the views over ranks, takes CenterNet's and C2CNet's
# BatchNorm statistics in two passes over the ranks (the single step:
# F.batch_norm), divides the losses' block numerators by global
# denominators and sums gradients over ranks, so each differs in its
# last bits. Losses relative: measured 9.3e-7 (both steps).
LOSS_RTOL = 1e-5
# Parameters after two steps, in units of the learning rate, as
# tests/test_torch_train_lockstep.py holds them: Adam moves an entry by
# ~lr a step whatever its gradient's size, so an entry whose gradient is
# float32 noise on both sides (a conv bias before a BatchNorm: 0 in exact
# arithmetic) can move 2 lr a step apart: each tensor within 2 lr per
# update its optimizer applied (the JLN two, the HDN one; measured 3.97 lr
# on a JLN tensor), and at most 1% of all entries more than 1 lr apart
# (measured 2073 of 2636788, 0.079%; printed).
PARAM_LR_PER_UPDATE = 2.0
# an entry whose gradient's sign differs lands 2 lr a update away
# exactly, up to the float32 rounding of the two parameters: this much
# room above the bound
PARAM_ROUNDING_LR = 1e-2
PARAM_FRAC_OVER_LR = 1e-2
UPDATES = {"pose_net": 1, "joint_net": 2}
# BatchNorm running statistics after two steps, against each tensor's
# largest entry: the second step's statistics follow the parameters that
# the first JLN update moved apart (above); measured 1.03e-3, within
# tests/test_torch_train_lockstep.py's 2e-3 for the steps after the first.
STATS_RTOL = 2e-3
# The distributed BatchNorm against one process on the joined batch:
# outputs, gradients and running statistics against their largest entry
# (measured 1.3e-7 unmasked; masked: 9e-8 for the weight gradient, the
# rest bit for bit).
BN_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(cfg):
    return tcfg.FVPConfig(**dataclasses.asdict(cfg))


def _port_rig(rig):
    return tcam.CameraRig(rig.R, rig.T, rig.f, rig.c, rig.k, rig.p)


def _torch(d):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in d.items()}


@functools.lru_cache(maxsize=None)
def _setup():
    cfg = par_cfg().replace(batch_size=4)
    rig = random_rig(np.random.RandomState(5), num_views=cfg.num_views)
    rc = build_rig_constants(cfg, rig)
    variables = _variables()
    return cfg, rig, rc, variables, make_batches(cfg, rig, rc, variables,
                                                 people=PEOPLE)


def _bn_inputs():
    """Inputs of the distributed BatchNorm check: an unmasked one (4
    scenes) and a masked one (4 groups of 3 members, group 1, on rank row
    0, with no member in the mask); each with the upstream gradient."""
    rng = np.random.RandomState(3)
    x = (rng.randn(4, 8, 6, 5) * 2 + 1).astype(np.float32)
    g = rng.randn(*x.shape).astype(np.float32)
    xm = (rng.randn(12, 8, 6, 5) * 2 + 1).astype(np.float32)
    gm = rng.randn(*xm.shape).astype(np.float32)
    mask = np.array([[1, 0, 1], [0, 0, 0], [1, 1, 1], [0, 1, 0]], bool)
    bn = BatchNorm2d(8)
    with torch.no_grad():
        for t in (bn.weight, bn.bias, bn.running_mean):
            t.copy_(torch.from_numpy(rng.randn(8).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(
            rng.rand(8).astype(np.float32) + 0.5))
    return {"plain": (x, g, None), "masked": (xm, gm, mask)}, \
        bn.state_dict()


@pytest.fixture(scope="module")
def job():
    cfg, rig, _, variables, batches = _setup()
    bn, bn_state = _bn_inputs()
    inp = {"shape": SHAPE, "cfg": _port(cfg), "rig": _port_rig(rig),
           "variables": variables, "batches": batches, "bn": bn,
           "bn_state": bn_state}
    return run_ranks(train_rank, 4, (inp,), timeout=240.0)


@functools.lru_cache(maxsize=None)
def _single():
    """The port's single-device Trainer over the two whole batches: per
    step its losses and state dict after."""
    cfg, rig, _, variables, batches = _setup()
    tc = _port(cfg)
    model = TModel(tc)
    model.load_state_dict(from_jax_variables(variables))
    trainer = Trainer(tc, model, "cpu")
    rc = port_rig_constants(tc, _port_rig(rig)).to("cpu")
    out = []
    for hm, targets, meta in batches:
        losses = trainer.train_step(torch.as_tensor(hm), rc,
                                    _torch(targets), _torch(meta))
        out.append({"losses": {k: float(v) for k, v in losses.items()},
                    "state": {k: v.detach().clone().numpy()
                              for k, v in model.state_dict().items()}})
    return out


def test_every_rank_takes_the_same_step(job):
    """The four ranks' losses and state dicts agree bit for bit, and the
    run is not vacuous: people matched in both steps, the JLN moved in
    both, the HDN in the second only (window k = 2)."""
    for i in range(2):
        for r in range(1, 4):
            assert job[r]["steps"][i]["losses"] == job[0]["steps"][i][
                "losses"]
            for k, v in job[0]["steps"][i]["state"].items():
                np.testing.assert_array_equal(job[r]["steps"][i]["state"][k],
                                              v, err_msg=k)
    cfg, _, _, variables, _ = _setup()
    init = TModel(_port(cfg))
    init.load_state_dict(from_jax_variables(variables))
    prev = {k: v.numpy() for k, v in init.state_dict().items()}
    moved = []
    for rec in job[0]["steps"]:
        assert rec["losses"]["joint"] > 0
        moved.append({net: any(not np.array_equal(prev[k], v)
                               for k, v in rec["state"].items()
                               if k.startswith(net) and "running" not in k
                               and "num_batches" not in k)
                      for net in ("pose_net", "joint_net")})
        prev = rec["state"]
    assert moved == [{"pose_net": False, "joint_net": True},
                     {"pose_net": True, "joint_net": True}]


def test_matches_single_trainer(job):
    """The (2, 2) mesh against the port's single Trainer on the same two
    batches of 4: losses of both steps, parameters and BatchNorm running
    statistics after the second (the HDN's window closed), within the
    tolerances measured and stated above."""
    cfg = _setup()[0]
    single = _single()
    worst = {"loss": 0.0, "lr": 0.0, "stats": 0.0}
    over = total = 0
    for i in range(2):
        for k, v in single[i]["losses"].items():
            got = job[0]["steps"][i]["losses"][k]
            worst["loss"] = max(worst["loss"], abs(got - v) / abs(v))
            np.testing.assert_allclose(got, v, rtol=LOSS_RTOL, atol=1e-9,
                                       err_msg=f"step {i} {k}")
    got, ref = job[0]["steps"][1]["state"], single[1]["state"]
    for k, r in ref.items():
        if "num_batches" in k:
            continue
        if "running" in k:
            err = float(np.abs(got[k] - r).max()) / float(np.abs(r).max())
            worst["stats"] = max(worst["stats"], err)
            assert err <= STATS_RTOL, (k, err)
        else:
            d = np.abs(got[k] - r) / cfg.lr
            worst["lr"] = max(worst["lr"], float(d.max()))
            over += int((d > 1.0).sum())
            total += d.size
            bound = PARAM_LR_PER_UPDATE * UPDATES[k.split(".")[0]] \
                + PARAM_ROUNDING_LR
            assert d.max() <= bound, (k, float(d.max()))
    print(f"sharded vs single: worst {worst}, {over} of {total} parameter "
          "entries more than 1 lr apart")
    assert over <= PARAM_FRAC_OVER_LR * total


def test_matches_reference_sharded_step(job):
    """The first sharded step against the reference's
    make_sharded_train_step on its make_mesh(2, 2) of the CPU mesh, from
    the same weights: losses rtol 2e-3, parameters rtol 2e-2, atol 2e-4
    (tests/test_parallel.py's)."""
    cfg, _, rc, variables, batches = _setup()
    model = FasterVoxelPose(cfg=cfg)
    hdn_tx, jln_tx = make_optimizers(cfg)
    params = jtu.tree_map(jnp.asarray, variables["params"])
    hdn = {k: v for k, v in params.items() if k in ("center_net", "c2c_net")}
    jln = {k: v for k, v in params.items() if k not in hdn}
    state = TrainState(
        params=params,
        batch_stats=jtu.tree_map(jnp.asarray, variables["batch_stats"]),
        hdn_opt=hdn_tx.init(hdn), jln_opt=jln_tx.init(jln),
        step=jnp.zeros((), jnp.int32), acc_grads=None, acc_loss=None,
        acc_count=None)
    hm, targets, meta = batches[0]
    mesh = ref_make_mesh(*SHAPE)
    with mesh:
        state, losses = ref_step(cfg, model, mesh)(
            state, jnp.asarray(hm), rc, jtu.tree_map(jnp.asarray, targets),
            jtu.tree_map(jnp.asarray, meta))
    got = job[0]["steps"][0]
    for k, v in losses.items():
        np.testing.assert_allclose(got["losses"][k], float(v), rtol=2e-3,
                                   atol=1e-5, err_msg=k)
    conv = convert_task_nets({k: torch.as_tensor(v)
                              for k, v in got["state"].items()})
    ref_leaves = jtu.tree_flatten_with_path(state.params)[0]
    got_leaves = jtu.tree_leaves(conv["params"])
    assert len(ref_leaves) == len(got_leaves)
    for (path, r), g in zip(ref_leaves, got_leaves):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r), rtol=2e-2,
                                   atol=2e-4, err_msg=jtu.keystr(path))


@pytest.mark.parametrize("name", ["plain", "masked"])
def test_distributed_batch_norm(job, name):
    """The train-mode BatchNorms over 'data' on 2 ranks against one
    process on the joined batch: outputs and input gradients (the blocks
    joined), weight and bias gradients (summed over the ranks, as the
    step sums them), running statistics (every rank); the masked one
    with a group on rank row 0 that has no member (its running update
    skips it, in the global group order)."""
    bn_in, state = _bn_inputs()
    x, g, mask = bn_in[name]
    bn = BatchNorm2d(x.shape[1]).train()
    bn.load_state_dict(state)
    xt = torch.tensor(x, requires_grad=True)
    y = bn(xt, None if mask is None else torch.as_tensor(mask))
    (y * torch.as_tensor(g)).sum().backward()
    ranks = (0, 2)                      # rank 0's 'data' group

    def close(got, ref, what):
        err = float(np.abs(got - ref).max()) / float(np.abs(ref).max())
        print(f"distributed BN {name} {what}: {err:.3g} of its scale")
        assert err <= BN_RTOL, (name, what, err)

    close(np.concatenate([job[r][name]["y"] for r in ranks]),
          y.detach().numpy(), "y")
    close(np.concatenate([job[r][name]["dx"] for r in ranks]),
          xt.grad.numpy(), "dx")
    for key, ref in (("dw", bn.weight.grad), ("db", bn.bias.grad)):
        close(sum(job[r][name][key] for r in ranks), ref.numpy(), key)
    for r in range(4):
        close(job[r][name]["mean"], bn.running_mean.numpy(), "mean")
        close(job[r][name]["var"], bn.running_var.numpy(), "var")
    assert not np.array_equal(bn.running_mean.numpy(),
                              state["running_mean"].numpy())


@pytest.fixture
def world1():
    init_distributed(f"127.0.0.1:{free_port()}", 1, 0, "cpu")
    yield
    dist.destroy_process_group()


def test_world1_is_the_trainer_bit_for_bit(world1):
    """A (1, 1) mesh: two sharded steps (K1 in sum mode, the view
    all-reduce and gather over a group of one) give Trainer.train_step's
    losses, parameters and running statistics bit for bit."""
    cfg, rig, _, variables, batches = _setup()
    tc = _port(cfg)
    rc = port_rig_constants(tc, _port_rig(rig)).to("cpu")
    trainers = []
    for _ in range(2):
        model = TModel(tc)
        model.load_state_dict(from_jax_variables(variables))
        trainers.append(Trainer(tc, model, "cpu"))
    mesh = make_mesh(1, 1)
    step = make_sharded_train_step(trainers[0], mesh)
    for hm, targets, meta in batches:
        a = step(shard_batch(mesh, torch.as_tensor(hm)), rc,
                 _torch(shard_data(mesh, targets)),
                 _torch(shard_data(mesh, meta)))
        b = trainers[1].train_step(torch.as_tensor(hm), rc, _torch(targets),
                                   _torch(meta))
        for k in a:
            assert torch.equal(a[k], b[k]), k
    sa, sb = (t.model.state_dict() for t in trainers)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
