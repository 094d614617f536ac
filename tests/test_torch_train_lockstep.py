"""The port's trainer (fvp_torch/engine/train.py) in lockstep with the
reference package's (fvp_tpu/engine/train.py::make_train_step_fn) on the
CPU: the same weights (from_jax_variables), the same seeded batches, four
steps with ACCUMULATION_QUIRK off and on, at small shapes (3 views of
60x32, a 32x32x8 space, K = 4 people in 16^3 cubes, B = 2).

The batches are the synthetic dataset's heatmaps with their people moved
onto the model's own proposals (within 150 mm, of the train-mode forward
at the starting weights), so that proposals match: one or two people a
scene; the third step's batch has nobody, so nothing matches there and
the JLN step is skipped. The people go to proposals off the edge voxels
of the space: a cube corner there is an exact x.5 tie, which the
reference rounds the other way under jit (ROADMAP Queue 3); the tests
assert that no matched proposal lies there. Held: the losses of every
step, the gradients of the first, the parameters after four steps, the
BatchNorm statistics, and the steps at which each optimizer changed its
parameters, each with the tolerance measured and stated below.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

import fvp_torch.config as tcfg
import fvp_torch.geometry.cameras as tcam
from fvp_torch.engine.train import Trainer
from fvp_torch.geometry.grids import build_rig_constants as t_rig_constants
from fvp_torch.models.convert import from_jax_variables
from fvp_torch.models.faster_voxelpose import FasterVoxelPose as TModel
from fvp_tpu.data.loader import collate
from fvp_tpu.data.synthetic import SyntheticDataset
from fvp_tpu.engine.train import (TrainState, make_optimizers,
                                  make_train_step_fn)
from fvp_tpu.geometry.grids import build_rig_constants
from fvp_tpu.models.convert_tasknets import convert_task_nets
from fvp_tpu.models.faster_voxelpose import FasterVoxelPose, compute_losses
from tests.helpers import random_rig
from tests.test_torch_nets import perturbed_variables
from tests.test_train_e2e import e2e_cfg


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread at these small shapes: parallel test workers
    then do not oversubscribe the cores (the previous count restored)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STEPS = 4
# people of each scene of a batch; the third batch has nobody
PEOPLE = [(2, 1), (1, 2), (0, 0), (2, 2)]
# The losses: relative. The first step's agree to the float32 summation
# order (3.4e-7 measured); later steps run on parameters that the two
# Adams moved apart (below), 1.5e-4 measured.
LOSS_RTOL_FIRST = 1e-5
LOSS_RTOL = 5e-4
# The first step's gradients, each tensor within GRAD_RTOL of its own
# largest entry plus GRAD_NET_RTOL of its net's largest gradient. The
# second term is the float32 rounding of gradients that cancel: held
# against a float64 run of the port, the reference's own float32
# gradients are off by up to 1e-3 of a CenterNet kernel's scale and 2.5e-2
# of a P2PNet one's (the port's by 1.5e-6 and 3.1e-3), and a conv bias
# before a BatchNorm has a gradient of exactly 0 in exact arithmetic,
# float32 noise on both sides. Measured worst: 1.17e-3 of P2PNet's
# largest gradient, on the kernel that the reference misses by 2.5e-2
# (EncoderDecoder_0/ResBlock_2/Conv_0); the test prints its margin.
GRAD_RTOL = 1e-4
GRAD_NET_RTOL = 3e-3
# Parameters after four steps, in units of the learning rate: Adam moves
# an entry by up to ~lr a step whatever its gradient's size, so an entry
# whose gradient is float32 noise on both sides (above) can move 2 lr a
# step apart: each tensor within 2 lr per update its optimizer applied
# (5.83 lr measured after three JLN updates), and at most 1% of all
# entries more than 1 lr apart (0.11% measured).
PARAM_LR_PER_UPDATE = 2.0
PARAM_FRAC_OVER_LR = 1e-2
# BatchNorm running statistics after each step, each tensor against its
# largest entry: 1e-6 after the first step; later steps follow the
# parameters (4e-4 measured)
STATS_RTOL_FIRST = 1e-5
STATS_RTOL = 2e-3


def train_cfg(**kw):
    return e2e_cfg(lr=1e-4, synthetic_num_data=8, **kw)


def port_cfg(cfg):
    return tcfg.FVPConfig(**dataclasses.asdict(cfg))


def port_rig(rig):
    return tcam.CameraRig(rig.R, rig.T, rig.f, rig.c, rig.k, rig.p)


def seeded_weights(cfg):
    """perturbed_variables with CenterNet's and C2CNet's heads scaled x30
    more (as tests/test_torch_model.py does), so that the detection maps
    have no near-ties for NMS, top-K and the z argmax to break apart."""
    v = perturbed_variables(cfg, 2)
    p = v["params"]
    p["center_net"]["Conv_1"]["kernel"] *= np.float32(30.0)
    p["c2c_net"]["Conv_0"]["kernel"] *= np.float32(30.0)
    return v


def interior(centers, cfg):
    """(B, K) whether each proposal center lies off the space's first and
    last voxel on every axis (its cube corner is no x.5 tie)."""
    space = np.asarray(cfg.space_size)
    vox = np.asarray(cfg.voxels_per_axis)
    idx = np.round((centers - (np.asarray(cfg.space_center) - space / 2))
                   / (space / (vox - 1)))
    return np.all((idx > 0) & (idx < vox - 1), axis=-1)


def _people_at(centers, people, rng, cfg, meta):
    """meta with scene b's people placed near its first people[b]
    interior proposals (roots within 150 mm, joints within 400 mm)."""
    meta = {k: np.array(v) for k, v in meta.items()}
    G, J = cfg.max_people, cfg.num_joints
    B = centers.shape[0]
    meta["roots_3d"] = np.zeros((B, G, 3), np.float32)
    meta["joints_3d"] = np.zeros((B, G, J, 3), np.float32)
    meta["joints_3d_vis"] = np.zeros((B, G, J), np.float32)
    meta["num_person"] = np.asarray(people, np.int32)
    inner = interior(centers, cfg)
    for b, n in enumerate(people):
        picks = np.flatnonzero(inner[b])[:n]
        assert len(picks) == n, "too few proposals off the edges"
        roots = centers[b, picks] + rng.uniform(-150, 150, (n, 3))
        meta["roots_3d"][b, :n] = roots
        meta["joints_3d"][b, :n] = roots[:, None] + rng.uniform(
            -400, 400, (n, J, 3))
        meta["joints_3d_vis"][b, :n] = rng.rand(n, J) < 0.9
    meta["bbox"] = rng.uniform(0.3, 0.9, (B, G, 2)).astype(np.float32)
    return meta


def make_batches(cfg, rig, rc, variables, people=PEOPLE, seed=0):
    """[(heatmaps, targets, meta)] as numpy: the dataset's batches, their
    people moved onto the train-mode proposals at `variables`."""
    ds = SyntheticDataset(cfg, rig, seed=3)
    model = FasterVoxelPose(cfg=cfg)
    fwd = jax.jit(lambda v, h, m: model.apply(v, h, rc, train=True, meta=m,
                                              mutable=["batch_stats"])[0])
    rng = np.random.RandomState(seed)
    out = []
    for i, ppl in enumerate(people):
        batch = collate([ds.sample((2 * i + b) % len(ds),
                                   rng=np.random.RandomState(10 * i + b))
                         for b in range(cfg.batch_size)])
        hm = batch["input_heatmaps"]
        nobody = dict(batch["meta"], num_person=np.zeros(
            cfg.batch_size, np.int32))
        centers = np.asarray(fwd(variables, jnp.asarray(hm), jtu.tree_map(
            jnp.asarray, nobody))["proposals"])[..., :3]
        meta = _people_at(centers, ppl, rng, cfg, batch["meta"])
        props = np.asarray(fwd(variables, jnp.asarray(hm), jtu.tree_map(
            jnp.asarray, meta))["proposals"])
        matched = props[..., 3] >= 0
        assert matched.sum() == sum(ppl)
        assert interior(props[..., :3], cfg)[matched].all()
        out.append((hm, batch["targets"], meta))
    return out


def _grads_tree(model):
    """The port model's parameter gradients in the reference package's
    params layout (its converter on a state dict holding the grads)."""
    state = _snapshot(model)
    for name, p in model.named_parameters():
        state[name] = p.grad.clone() if p.grad is not None \
            else torch.zeros_like(p)
    return convert_task_nets(state)["params"]


def _snapshot(model):
    """A copy of the model's state dict (its tensors share the live
    parameters' memory, which the optimizers update in place)."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _torch(d):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in d.items()}


def run_reference(cfg, rc, variables, batches):
    """The reference's jitted step over `batches`: per step the losses,
    params and batch_stats after."""
    model = FasterVoxelPose(cfg=cfg)
    hdn_tx, jln_tx = make_optimizers(cfg)
    params = jtu.tree_map(jnp.asarray, variables["params"])
    hdn = {k: v for k, v in params.items() if k in ("center_net", "c2c_net")}
    jln = {k: v for k, v in params.items() if k not in hdn}
    quirk = cfg.accumulation_quirk
    state = TrainState(
        params=params,
        batch_stats=jtu.tree_map(jnp.asarray, variables["batch_stats"]),
        hdn_opt=hdn_tx.init(hdn), jln_opt=jln_tx.init(jln),
        step=jnp.zeros((), jnp.int32),
        acc_grads=jtu.tree_map(jnp.zeros_like, hdn) if quirk else None,
        acc_loss=jnp.zeros((), jnp.float32) if quirk else None,
        acc_count=jnp.zeros((), jnp.int32) if quirk else None)
    step = jax.jit(make_train_step_fn(cfg, model))
    out = []
    for hm, targets, meta in batches:
        state, losses = step(state, jnp.asarray(hm), rc,
                             jtu.tree_map(jnp.asarray, targets),
                             jtu.tree_map(jnp.asarray, meta))
        out.append({"losses": {k: float(v) for k, v in losses.items()},
                    "params": jtu.tree_map(np.asarray, state.params),
                    "batch_stats": jtu.tree_map(np.asarray,
                                                state.batch_stats)})
    return out


def reference_gradients(cfg, rc, variables, batch):
    """The reference's gradients of the total loss on `batch`, as its step
    takes them (one backward of the summed losses)."""
    model = FasterVoxelPose(cfg=cfg)
    hm, targets, meta = (jtu.tree_map(jnp.asarray, x) for x in batch)

    def loss(p):
        o, _ = model.apply({"params": p,
                            "batch_stats": variables["batch_stats"]},
                           hm, rc, train=True, meta=meta,
                           mutable=["batch_stats"])
        return compute_losses(cfg, o, targets, meta)["total"]
    return jtu.tree_map(np.asarray, jax.jit(jax.grad(loss))(
        variables["params"]))


def run_port(cfg, rig, variables, batches, trainer=None):
    """The port's trainer over `batches` on the CPU: per step the losses,
    the gradients (of the first step), params and batch_stats after, as
    the reference's trees."""
    tc = port_cfg(cfg)
    if trainer is None:
        model = TModel(tc)
        model.load_state_dict(from_jax_variables(variables))
        trainer = Trainer(tc, model, "cpu")
    rc = t_rig_constants(tc, port_rig(rig)).to("cpu")
    out = []
    for hm, targets, meta in batches:
        losses = trainer.train_step(torch.as_tensor(hm), rc,
                                    _torch(targets), _torch(meta))
        rec = {"losses": {k: float(v) for k, v in losses.items()}}
        if not out:
            rec["grads"] = _grads_tree(trainer.model)
        conv = convert_task_nets(_snapshot(trainer.model))
        rec["params"], rec["batch_stats"] = conv["params"], \
            conv["batch_stats"]
        out.append(rec)
    return out, trainer


@functools.lru_cache(maxsize=None)
def _setup():
    cfg = train_cfg()
    rig = random_rig(np.random.RandomState(5), num_views=cfg.num_views)
    rc = build_rig_constants(cfg, rig)
    variables = seeded_weights(cfg)
    return cfg, rig, rc, variables, make_batches(cfg, rig, rc, variables)


@functools.lru_cache(maxsize=None)
def _runs(quirk: bool):
    cfg, rig, rc, variables, batches = _setup()
    cfg = cfg.replace(accumulation_quirk=quirk)
    ref = run_reference(cfg, rc, variables, batches)
    ref[0]["grads"] = _reference_gradients()
    got, _ = run_port(cfg, rig, variables, batches)
    return cfg, variables, ref, got


@functools.lru_cache(maxsize=None)
def _reference_gradients():
    cfg, _, rc, variables, batches = _setup()
    return reference_gradients(cfg, rc, variables, batches[0])


def _changed(a, b):
    return [not np.array_equal(x, y) for x, y in
            zip(jtu.tree_leaves(a), jtu.tree_leaves(b))]


def _pattern(cfg, variables, run, nets):
    """Per step: whether any parameter of `nets` changed in that step."""
    prev = variables["params"]
    out = []
    for rec in run:
        out.append(any(any(_changed(prev[n], rec["params"][n]))
                       for n in nets))
        prev = rec["params"]
    return out


def _pairs(a, b):
    return zip(jtu.tree_flatten_with_path(a)[0],
               (x for _, x in jtu.tree_flatten_with_path(b)[0]))


@pytest.mark.parametrize("quirk", [False, True])
def test_lockstep_losses(quirk):
    _, _, ref, got = _runs(quirk)
    for i, (r, g) in enumerate(zip(ref, got)):
        for k, v in r["losses"].items():
            np.testing.assert_allclose(
                g["losses"][k], v, atol=1e-9,
                rtol=LOSS_RTOL_FIRST if i == 0 else LOSS_RTOL,
                err_msg=f"step {i} {k}")
    # non-vacuous: people matched in steps 0, 1, 3, none in step 2
    joint = [r["losses"]["joint"] for r in ref]
    assert joint[0] > 0 and joint[1] > 0 and joint[3] > 0 and joint[2] == 0


@pytest.mark.parametrize("quirk", [False, True])
def test_lockstep_first_step_gradients(quirk):
    _, _, ref, got = _runs(quirk)
    net_scale = {n: max(float(np.abs(x).max()) for x in jtu.tree_leaves(t))
                 for n, t in ref[0]["grads"].items()}
    worst = 0.0
    for (path, r), g in _pairs(ref[0]["grads"], got[0]["grads"]):
        assert g.shape == r.shape, path
        tol = GRAD_RTOL * float(np.abs(r).max()) \
            + GRAD_NET_RTOL * net_scale[path[0].key]
        err = float(np.abs(g - r).max())
        worst = max(worst, err / tol)
        assert err <= tol, (jtu.keystr(path), err, tol)
    print(f"quirk {quirk}: first-step gradients within {worst:.3g} of "
          "their tolerance")
    assert min(net_scale.values()) > 0


@pytest.mark.parametrize("quirk", [False, True])
def test_lockstep_update_pattern(quirk):
    """HDN on the accumulation window's k-th calls (quirk: and a window
    loss > 0); JLN whenever the joint loss is > 0: both sides alike."""
    cfg, variables, ref, got = _runs(quirk)
    hdn, jln = ("center_net", "c2c_net"), ("p2p_net", "weight_net")
    for nets in (hdn, jln):
        assert _pattern(cfg, variables, got, nets) == \
            _pattern(cfg, variables, ref, nets), nets
    assert _pattern(cfg, variables, ref, hdn) == [False, True, False, True]
    assert _pattern(cfg, variables, ref, jln) == [True, True, False, True]


@pytest.mark.parametrize("quirk", [False, True])
def test_lockstep_parameters(quirk):
    cfg, variables, ref, got = _runs(quirk)
    updates = {n: sum(_pattern(cfg, variables, ref, (n,)))
               for n in ref[-1]["params"]}
    worst, over, total = 0.0, 0, 0
    for (path, r), g in _pairs(ref[-1]["params"], got[-1]["params"]):
        d = np.abs(g - r) / cfg.lr
        worst = max(worst, float(d.max()))
        over += int((d > 1.0).sum())
        total += d.size
        assert d.max() <= PARAM_LR_PER_UPDATE * updates[path[0].key], \
            (jtu.keystr(path), float(d.max()))
    print(f"quirk {quirk}: parameters after {STEPS} steps within "
          f"{worst:.3g} lr, {over} of {total} entries more than 1 lr apart")
    assert over <= PARAM_FRAC_OVER_LR * total


@pytest.mark.parametrize("quirk", [False, True])
def test_lockstep_batch_stats(quirk):
    _, _, ref, got = _runs(quirk)
    for i in range(STEPS):
        rtol = STATS_RTOL_FIRST if i == 0 else STATS_RTOL
        for (path, r), g in _pairs(ref[i]["batch_stats"],
                                   got[i]["batch_stats"]):
            err = float(np.abs(g - r).max())
            assert err <= rtol * float(np.abs(r).max()), \
                (i, jtu.keystr(path), err)
