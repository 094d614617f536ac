"""Resuming the reference's train state: its save_checkpoint writes
checkpoint.msgpack after two steps of its jitted train step
(tests/test_torch_train_lockstep.py's weights and batches, the
ACCUMULATION_QUIRK off and on), and the port's Trainer resumes from that
file (fvp_torch/engine/checkpoint.py::load_reference_checkpoint): its
parameters, BatchNorm statistics, both Adams' moments and counts, the
HDN's window and the counters match bit for bit, and a third step on
both sides holds at the float32 lockstep's tolerances. Then the train
CLI's --resume picks a reference checkpoint.msgpack up."""

import functools

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from fvp_torch.engine.checkpoint import (load_reference_checkpoint,
                                         train_state_layout)
from fvp_torch.engine.train import Trainer
from fvp_torch.geometry.grids import build_rig_constants as \
    port_rig_constants
from fvp_torch.models.convert import to_jax_variables
from fvp_torch.models.faster_voxelpose import FasterVoxelPose as TModel
from fvp_tpu.engine.checkpoint import save_checkpoint
from fvp_tpu.engine.train import (TrainState, create_train_state,
                                  make_optimizers, make_train_step_fn)
from fvp_tpu.models.faster_voxelpose import FasterVoxelPose
from tests import test_torch_train_lockstep as lock
from tests.test_torch_train_cli import _cli, _tiny_yaml


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(cfg, variables):
    """The reference's TrainState at `variables`, as run_reference makes
    it."""
    hdn_tx, jln_tx = make_optimizers(cfg)
    params = jtu.tree_map(jnp.asarray, variables["params"])
    hdn = {k: v for k, v in params.items() if k in ("center_net", "c2c_net")}
    jln = {k: v for k, v in params.items() if k not in hdn}
    quirk = cfg.accumulation_quirk
    return TrainState(
        params=params,
        batch_stats=jtu.tree_map(jnp.asarray, variables["batch_stats"]),
        hdn_opt=hdn_tx.init(hdn), jln_opt=jln_tx.init(jln),
        step=jnp.zeros((), jnp.int32),
        acc_grads=jtu.tree_map(jnp.zeros_like, hdn) if quirk else None,
        acc_loss=jnp.zeros((), jnp.float32) if quirk else None,
        acc_count=jnp.zeros((), jnp.int32) if quirk else None)


@functools.lru_cache(maxsize=None)
def _reference(quirk: bool):
    """Two reference steps, the state after them, and a third step on the
    lockstep's fourth batch (people matched: the JLN updates)."""
    cfg, rig, rc, variables, batches = lock._setup()
    cfg = cfg.replace(accumulation_quirk=quirk)
    step = jax.jit(make_train_step_fn(cfg, FasterVoxelPose(cfg=cfg)))
    state = _state(cfg, variables)

    def run(state, batch):
        hm, targets, meta = batch
        return step(state, jnp.asarray(hm), rc,
                    jtu.tree_map(jnp.asarray, targets),
                    jtu.tree_map(jnp.asarray, meta))
    for batch in batches[:2]:
        state, _ = run(state, batch)
    state2 = jtu.tree_map(np.asarray, state)
    state3, losses3 = run(state, batches[3])
    return cfg, rig, variables, batches, state2, \
        jtu.tree_map(np.asarray, state3), \
        {k: float(v) for k, v in losses3.items()}


def _resumed(quirk, tmp_path):
    cfg, rig, variables, batches, state2, _, _ = _reference(quirk)
    save_checkpoint(str(tmp_path), state2, epoch=3, best_metric=0.25,
                    step_in_epoch=2)
    tc = lock.port_cfg(cfg)
    trainer = Trainer(tc, TModel(tc), "cpu")       # its own initial weights
    restored = load_reference_checkpoint(str(tmp_path), trainer)
    return cfg, rig, batches, state2, trainer, restored


def _as_flax(trainer, tensors):
    """{parameter name: tensor} -> the reference's params tree (the
    inverse converter), the other entries from the model."""
    state = {k: v.detach().clone() for k, v in
             trainer.model.state_dict().items()}
    state.update(tensors)
    return to_jax_variables(state)["params"]


def _adam(opt_state, quirk, which):
    """(count, mu, nu) of the reference's optax Adam state."""
    if which == "hdn" and not quirk:
        opt_state = opt_state.inner_opt_state
    adam = opt_state[0]
    return int(adam.count), adam.mu, adam.nu


@pytest.mark.parametrize("quirk", [False, True])
def test_layout_is_the_train_states_leaf_order(quirk):
    """The port's description of the leaf order against the TrainState's
    own flattening: the same number of leaves and the same shapes."""
    cfg, _, variables, _, state2, _, _ = _reference(quirk)
    layout = train_state_layout(cfg, variables)
    leaves = jtu.tree_leaves(state2)
    assert len(layout) == len(leaves)
    assert [s for _, _, s in layout] == [np.shape(x) for x in leaves]
    paths = [jtu.keystr(p) for p, _ in jtu.tree_flatten_with_path(state2)[0]]
    for (part, path, _), got in zip(layout, paths):
        names = [{"schedule_count": "count"}.get(k, k) for k in path]
        assert part in got and all(k in got for k in names), \
            (part, path, got)


@pytest.mark.parametrize("quirk", [False, True])
def test_resume_carries_the_state_bit_for_bit(quirk, tmp_path):
    cfg, _, _, state2, trainer, restored = _resumed(quirk, tmp_path)
    assert restored == (3, 0.25, 2)
    # parameters and statistics
    got = to_jax_variables(trainer.model.state_dict())
    for part in ("params", "batch_stats"):
        for (path, r), g in lock._pairs(getattr(state2, part), got[part]):
            assert np.array_equal(g, r), (part, jtu.keystr(path))
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    for which, opt in (("hdn", trainer.hdn_opt), ("jln", trainer.jln_opt)):
        count, mu, nu = _adam(getattr(state2, f"{which}_opt"), quirk, which)
        params = opt.param_groups[0]["params"]
        assert count > 0
        for p in params:
            assert float(opt.state[p]["step"]) == count
        for key, ref in (("exp_avg", mu), ("exp_avg_sq", nu)):
            tree = _as_flax(trainer, {names[id(p)]: opt.state[p][key]
                                      for p in params})
            for net, sub in ref.items():
                for (path, r), g in lock._pairs(sub, tree[net]):
                    assert np.array_equal(g, r), (which, key, net,
                                                  jtu.keystr(path))
        assert (trainer.hdn_updates if which == "hdn"
                else trainer.jln_updates) == count
    assert trainer.step == int(state2.step) == 2
    # the HDN's window
    if quirk:
        acc, n = state2.acc_grads, int(state2.acc_count)
        assert float(trainer.acc_loss) == float(state2.acc_loss)
    else:
        acc, n = state2.hdn_opt.acc_grads, int(state2.hdn_opt.mini_step)
    assert trainer.acc_count == n
    tree = _as_flax(trainer, {names[id(p)]: a for p, a in
                              zip(trainer.hdn_params, trainer.acc_grads)})
    for net, sub in acc.items():
        for (path, r), g in lock._pairs(sub, tree[net]):
            assert np.array_equal(g, r), (net, jtu.keystr(path))


@pytest.mark.parametrize("quirk", [False, True])
def test_third_step_after_resume_matches(quirk, tmp_path):
    """The resumed Trainer's next step against the reference's, held as
    tests/test_torch_train_lockstep.py holds the steps after the first:
    losses within LOSS_RTOL, parameters within 2 lr per update (each
    optimizer's three), statistics within STATS_RTOL."""
    cfg, rig, batches, _, trainer, _ = _resumed(quirk, tmp_path)
    _, _, _, _, _, state3, losses3 = _reference(quirk)
    hm, targets, meta = batches[3]
    rc = port_rig_constants(trainer.cfg, lock.port_rig(rig)).to("cpu")
    losses = trainer.train_step(torch.as_tensor(hm), rc, lock._torch(targets),
                                lock._torch(meta))
    for k, v in losses3.items():
        np.testing.assert_allclose(float(losses[k]), v, atol=1e-9,
                                   rtol=lock.LOSS_RTOL, err_msg=k)
    assert losses3["joint"] > 0
    got = to_jax_variables(trainer.model.state_dict())
    worst = 0.0
    for (path, r), g in lock._pairs(state3.params, got["params"]):
        d = float((np.abs(g - r) / cfg.lr).max())
        worst = max(worst, d)
        assert d <= lock.PARAM_LR_PER_UPDATE * 3, (jtu.keystr(path), d)
    for (path, r), g in lock._pairs(state3.batch_stats, got["batch_stats"]):
        err = float(np.abs(g - r).max())
        assert err <= lock.STATS_RTOL * float(np.abs(r).max()), \
            jtu.keystr(path)
    print(f"quirk {quirk}: step 3 after the resume, parameters within "
          f"{worst:.3g} lr")


def test_train_cli_resumes_a_reference_checkpoint(tmp_path):
    """--resume with no checkpoint.pth but the reference's
    checkpoint.msgpack (its train state at initialisation, epoch 1) in the
    output directory: the CLI logs the file it took and trains epoch 1
    from there."""
    from fvp_tpu.config import load_config as ref_load_config
    from tests.helpers import random_rig

    from fvp_tpu.geometry.grids import build_rig_constants

    cli = _cli()
    cfg_path = _tiny_yaml(tmp_path)
    out = tmp_path / "out" / "tiny"
    cfg = ref_load_config(cfg_path)
    rig = random_rig(np.random.RandomState(0), num_views=cfg.num_views)
    w, h = cfg.heatmap_size
    state = create_train_state(
        cfg, FasterVoxelPose(cfg=cfg), build_rig_constants(cfg, rig),
        jnp.zeros((1, cfg.num_views, cfg.num_joints, h, w)),
        jax.random.PRNGKey(1))
    save_checkpoint(str(out), jtu.tree_map(np.asarray, state), epoch=1,
                    best_metric=-1.0)
    assert cli.main(["--cfg", cfg_path, "--epochs", "2", "--resume",
                     "--device", "cpu"]) == 0
    ckpt = torch.load(out / "checkpoint.pth", weights_only=True)
    assert ckpt["epoch"] == 2 and ckpt["trainer"]["step"] == 3
    text = "".join(p.read_text() for p in out.iterdir()
                   if p.name.startswith("train_torch"))
    assert "checkpoint.msgpack (the reference's train state)" in text
    assert "resumed from epoch 1" in text and "epoch 1 metrics" in text
