"""The port's trainer around its step, on the CPU: checkpoints (the full
train state round trip, model_best, a resume in the middle of an epoch bit
for bit against an uninterrupted run), a batch with nobody matched (the
JLN's Adam does not advance), and image-source training through a frozen
ResNet-18 against the reference's backbone and train-mode forward."""

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from fvp_torch.config import load_config as t_load_config
from fvp_torch.data.loader import seq_grouped_batches
from fvp_torch.data.registry import build_dataset as t_build
from fvp_torch.engine.checkpoint import (load_best, load_checkpoint,
                                         save_checkpoint)
from fvp_torch.engine.init import flax_init
from fvp_torch.engine.train import Trainer, step_inputs
from fvp_torch.geometry.grids import build_rig_constants as t_rig_constants
from fvp_torch.models.convert import (from_jax_backbone_variables,
                                      from_jax_variables)
from fvp_torch.models.faster_voxelpose import FasterVoxelPose as TModel
from fvp_torch.models.resnet import PoseResNet as TPoseResNet
from fvp_tpu.data.loader import collate
from fvp_tpu.geometry.grids import build_rig_constants
from fvp_tpu.models.faster_voxelpose import FasterVoxelPose, compute_losses
from fvp_tpu.models.resnet import PoseResNet
from tests.test_torch_nets import perturbed_variables
from tests.test_torch_train_lockstep import (_setup, _snapshot, _torch,
                                             port_cfg, port_rig, run_port)
from tests.test_train_e2e import _dataset, e2e_cfg


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread at these small shapes: parallel test workers
    then do not oversubscribe the cores (the previous count restored)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = "configs/test/tiny_synthetic.yaml"


def _trainer(cfg, seed=0):
    model = TModel(cfg)
    flax_init(model, torch.Generator().manual_seed(seed))
    return Trainer(cfg, model, "cpu")


def _states_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_states_equal(a[k], b[k])
                                             for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_states_equal, a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def _epoch(trainer, ds, cfg, epoch, start=0, stop=None):
    """Steps start..stop-1 of an epoch, as run/train_torch.py takes them
    (the batches before `start` drawn and skipped)."""
    rcs = {s: t_rig_constants(cfg, r).to("cpu") for s, r in ds.rigs.items()}
    for i, (seq, batch) in enumerate(seq_grouped_batches(
            ds, cfg.batch_size, cfg.seed, epoch)):
        if i == stop:
            return
        if i >= start:
            trainer.train_step(*step_inputs(batch, "cpu")[:1], rcs[seq],
                               *step_inputs(batch, "cpu")[1:])


@pytest.fixture(scope="module")
def tiny():
    """The tiny synthetic config with 8 training scenes (4 steps an epoch),
    the quirk on (its window is part of the state) and a window of 3."""
    cfg = t_load_config(TINY, synthetic_num_data=8).replace(
        accumulation_quirk=True, accumulation_steps=3, lr=1e-2)
    return cfg, t_build(cfg.train_dataset, cfg, is_train=True)


def test_checkpoint_round_trip(tmp_path, tiny):
    cfg, ds = tiny
    tr = _trainer(cfg)
    _epoch(tr, ds, cfg, 0, stop=2)
    save_checkpoint(str(tmp_path), tr, epoch=3, best_metric=0.25,
                    is_best=True, step_in_epoch=2)
    other = _trainer(cfg, seed=1)
    assert not _states_equal(other.state_dict(), tr.state_dict())
    assert load_checkpoint(str(tmp_path), other) == (3, 0.25, 2)
    assert _states_equal(other.state_dict(), tr.state_dict())
    assert other.acc_count == 2 and float(other.acc_loss) > 0
    best = TModel(cfg)
    load_best(str(tmp_path), best)
    for k, v in tr.model.state_dict().items():
        assert torch.equal(best.state_dict()[k], v), k
    assert load_checkpoint(str(tmp_path / "none"), other) is None


def test_resume_mid_epoch_is_bit_exact(tmp_path, tiny):
    """Two epochs straight, against one interrupted after step 2 of the
    second epoch, checkpointed, and resumed in a fresh trainer: the same
    state bit for bit."""
    cfg, ds = tiny
    straight = _trainer(cfg)
    for epoch in range(2):
        straight.reset_accumulation()
        _epoch(straight, ds, cfg, epoch)

    first = _trainer(cfg)
    first.reset_accumulation()
    _epoch(first, ds, cfg, 0)
    first.reset_accumulation()
    _epoch(first, ds, cfg, 1, stop=2)
    save_checkpoint(str(tmp_path), first, epoch=1, best_metric=0.0,
                    step_in_epoch=2)
    resumed = _trainer(cfg, seed=3)
    assert load_checkpoint(str(tmp_path), resumed) == (1, 0.0, 2)
    _epoch(resumed, ds, cfg, 1, start=2)       # no reset: a mid-epoch resume
    assert resumed.step == straight.step == 8
    assert resumed.hdn_updates == straight.hdn_updates > 0
    assert _states_equal(resumed.state_dict(), straight.state_dict())


def test_no_match_skips_the_jln_step():
    """The lockstep's third batch has nobody: the joint loss is 0, the JLN
    keeps its parameters and its Adam state (step count, moments)."""
    cfg, rig, rc, variables, batches = _setup()
    _, tr = run_port(cfg, rig, variables, batches[:2])
    before = _snapshot(tr.model)
    jln_state = {k: {n: v.clone() for n, v in s.items()}
                 for k, s in tr.jln_opt.state_dict()["state"].items()}
    updates = tr.jln_updates
    got, _ = run_port(cfg, rig, variables, batches[2:3], trainer=tr)
    assert got[0]["losses"]["joint"] == 0.0
    assert tr.jln_updates == updates == 2
    for k, v in _snapshot(tr.model).items():
        if k.startswith("joint_net.") and "running" not in k \
                and "num_batches" not in k:
            assert torch.equal(v, before[k]), k
    assert _states_equal(tr.jln_opt.state_dict()["state"], jln_state)


def test_image_source_training_through_frozen_backbone(rng):
    """TRAIN_HEATMAP_SRC=image: the reference's test setup (2 views of
    240x128 images, a seeded ResNet-18, 2 scenes; the parity tests'
    perturbed task-net weights) with the heatmap size
    the backbone gives them (64x32: the port checks it, the reference does
    not). The port's trainer takes the images through the frozen backbone
    in its serving lowering (the stem and deconv head round to bf16 where
    their kernels do): its heatmaps against the reference backbone's
    within 2e-2 of their scale, as tests/test_torch_backbone.py holds
    them; then the first step's losses against the reference's train-mode
    forward on those heatmaps, with the lockstep's first-step tolerance,
    and a second step. Nothing matches (random weights), so the JLN does
    not step; the HDN moves each step (a window of 1), the backbone does
    not."""
    from tests.test_torch_train_lockstep import LOSS_RTOL_FIRST

    cfg = e2e_cfg(num_views=2, max_people=2, synthetic_max_people=1,
                  image_size=(240, 128), heatmap_size=(64, 32),
                  ori_image_size=(1920, 1080), accumulation_steps=1)
    ds, rig = _dataset(rng, cfg)
    rc = build_rig_constants(cfg, rig)
    model = FasterVoxelPose(cfg=cfg)
    backbone = PoseResNet(num_joints=cfg.num_joints, num_layers=18)
    B, V = cfg.batch_size, cfg.num_views
    images = rng.rand(B, V, 128, 240, 3).astype(np.float32)
    bvars = jax.jit(lambda k, x: backbone.init(k, x, train=False))(
        jax.random.PRNGKey(1), jnp.asarray(images[0]))
    hm_ref = np.asarray(jax.jit(lambda v, x: backbone.apply(
        v, x, train=False))(bvars, jnp.asarray(images.reshape(
            B * V, 128, 240, 3)))).reshape(B, V, 32, 64, -1) \
        .transpose(0, 1, 4, 2, 3)

    variables = perturbed_variables(cfg, 3)
    batch = collate([ds.sample(i, rng=np.random.RandomState(i))
                     for i in range(B)])
    tc = port_cfg(cfg)
    tmodel = TModel(tc)
    tmodel.load_state_dict(from_jax_variables(variables))
    tback = TPoseResNet(tc.num_joints, 18)
    tback.load_state_dict(from_jax_backbone_variables(
        jtu.tree_map(np.asarray, bvars)))
    tr = Trainer(tc, tmodel, "cpu", backbone=tback)
    bb_before = {k: v.clone() for k, v in tback.state_dict().items()}
    p_before = _snapshot(tmodel)
    x = torch.from_numpy(images)
    hm = tr.heatmaps(x).numpy()                            # (B, V, J, h, w)
    assert float(np.abs(hm - hm_ref).max()) <= 2e-2 * np.abs(hm_ref).max()

    ref, _ = jax.jit(lambda v, h, m: model.apply(
        v, h, rc, train=True, meta=m, mutable=["batch_stats"]))(
            variables, jnp.asarray(hm), jtu.tree_map(jnp.asarray,
                                                     batch["meta"]))
    ref = compute_losses(cfg, ref, *(jtu.tree_map(jnp.asarray, batch[k])
                                     for k in ("targets", "meta")))
    rc_t = t_rig_constants(tc, port_rig(rig)).to("cpu")
    got = [tr.train_step(x, rc_t, _torch(batch["targets"]),
                         _torch(batch["meta"])) for _ in range(2)]
    assert float(got[0]["joint"]) == float(ref["joint"]) == 0.0
    for k, v in ref.items():
        np.testing.assert_allclose(float(got[0][k]), float(v), atol=1e-9,
                                   rtol=LOSS_RTOL_FIRST, err_msg=k)
    assert all(np.isfinite(float(v)) for v in got[1].values())
    assert tr.step == 2 and tr.hdn_updates == 2 and tr.jln_updates == 0
    for k, v in tback.state_dict().items():
        assert torch.equal(v, bb_before[k]), k
    after = _snapshot(tmodel)
    assert any(not torch.equal(after[k], p_before[k])
               for k in after if k.startswith("pose_net."))
