"""The port's training modules on the CPU against the reference package's,
module by module: train-mode BatchNorm (flax's convention, and
MaskedBatchNorm with an all-empty group), GT matching, the four losses,
the train-mode forward of the whole model (outputs, losses, new batch
statistics), the LR schedule's boundaries and the initialisation schemes'
distributions."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from fvp_torch.engine import init as tinit
from fvp_torch.engine.train import Trainer, lr_at
from fvp_torch.geometry.grids import build_rig_constants as t_rig_constants
from fvp_torch.models.blocks import BatchNorm1d, BatchNorm2d
from fvp_torch.models.convert import from_jax_variables
from fvp_torch.models.faster_voxelpose import FasterVoxelPose as TModel
from fvp_torch.models.faster_voxelpose import \
    compute_losses as t_compute_losses
from fvp_torch.models.faster_voxelpose import \
    match_proposals_to_gt as t_match
from fvp_tpu.engine.train import _lr_schedule
from fvp_tpu.models.blocks import MaskedBatchNorm
from fvp_tpu.models.convert_tasknets import convert_task_nets
from fvp_tpu.models.faster_voxelpose import FasterVoxelPose, compute_losses
from fvp_tpu.models.faster_voxelpose import match_proposals_to_gt
from tests.test_torch_nets import F32
from tests.test_torch_train_lockstep import (_setup, _snapshot, _torch,
                                             port_cfg, port_rig, train_cfg)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread at these small shapes: parallel test workers
    then do not oversubscribe the cores (the previous count restored)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bn_vars(rng, C):
    return (rng.rand(C).astype(np.float32) + 0.5,
            rng.rand(C).astype(np.float32) - 0.5,
            rng.rand(C).astype(np.float32) - 0.5,
            rng.rand(C).astype(np.float32) + 0.5)


def _port_bn(cls, scale, bias, mean, var):
    bn = cls(len(scale)).train()
    with torch.no_grad():
        for t, a in ((bn.weight, scale), (bn.bias, bias),
                     (bn.running_mean, mean), (bn.running_var, var)):
            t.copy_(torch.from_numpy(a))
    return bn


@pytest.mark.parametrize("dims", [1, 2])
def test_train_bn_follows_flax(rng, dims):
    """batch statistics normalise; the running variance moves towards the
    *biased* batch variance (flax's convention, not torch's)."""
    shape = (6, 9, 7, 5) if dims == 2 else (12, 9, 5)      # channels last
    x = (rng.rand(*shape).astype(np.float32) * 3 + 1)
    scale, bias, mean, var = _bn_vars(rng, 5)
    y, mut = fnn.BatchNorm(use_running_average=False, momentum=0.9).apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean, "var": var}}, jnp.asarray(x),
        mutable=["batch_stats"])
    bn = _port_bn(BatchNorm2d if dims == 2 else BatchNorm1d,
                  scale, bias, mean, var)
    xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy())
    got = np.moveaxis(bn(xt).detach().numpy(), 1, -1)
    np.testing.assert_allclose(got, np.asarray(y), atol=2e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               mut["batch_stats"]["mean"], atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               mut["batch_stats"]["var"], rtol=1e-5)
    # torch's own BatchNorm would take the unbiased variance: measurably
    # different at these sizes
    n = x.size // 5
    assert np.abs(bn.running_var.numpy() * n / (n - 1)
                  - bn.running_var.numpy()).max() > 1e-3


@pytest.mark.parametrize("empty", [False, True])
def test_masked_bn_matches_reference(rng, empty):
    """Per-group masked statistics, masked members zeroed, the sequential
    running update (a group without members skipped; all groups empty:
    the running statistics unchanged and every output zero)."""
    G, M, H, W, C = 4, 6, 8, 8, 5
    x = rng.rand(G * M, H, W, C).astype(np.float32) * 2 - 1
    mask = rng.rand(G, M) < 0.5
    mask[2] = False
    mask[[0, 1, 3], 0] = True
    if empty:
        mask[:] = False
    scale, bias, mean, var = _bn_vars(rng, C)
    y, mut = MaskedBatchNorm().apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean, "var": var}}, jnp.asarray(x),
        jnp.asarray(mask), mutable=["batch_stats"])
    bn = _port_bn(BatchNorm2d, scale, bias, mean, var)
    got = bn(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
             torch.from_numpy(mask)).detach().numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, np.asarray(y), atol=2e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               mut["batch_stats"]["mean"], atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               mut["batch_stats"]["var"], rtol=1e-5)
    if empty:
        assert not got.any()
        np.testing.assert_array_equal(bn.running_mean.numpy(), mean)
        np.testing.assert_array_equal(bn.running_var.numpy(), var)


def test_match_proposals_to_gt(rng):
    """Within 500 mm of a valid person or not, the whole-bbox replacement
    quirk (any coordinate too small -> the person's whole bbox), and a
    scene with nobody."""
    B, K, G = 3, 6, 4
    roots = rng.uniform(-2000, 2000, (B, G, 3)).astype(np.float32)
    num = np.array([3, 1, 0], np.int32)
    pick = rng.randint(0, G, (B, K))
    centers = roots[np.arange(B)[:, None], pick] + rng.uniform(
        -450, 450, (B, K, 3)).astype(np.float32)
    centers[:, -1] += 5000.0                       # far from everyone
    gt_bbox = rng.uniform(0.3, 0.9, (B, G, 2)).astype(np.float32)
    bbox = rng.uniform(0.1, 1.0, (B, K, 2)).astype(np.float32)
    p2g_r, adj_r = jax.vmap(match_proposals_to_gt)(
        *(jnp.asarray(a) for a in (centers, bbox, roots, gt_bbox, num)))
    p2g, adj = t_match(*(torch.from_numpy(a) for a in
                         (centers, bbox, roots, gt_bbox, num)))
    np.testing.assert_array_equal(p2g.numpy(), np.asarray(p2g_r))
    np.testing.assert_array_equal(adj.numpy(), np.asarray(adj_r))
    matched = p2g.numpy() >= 0
    assert 3 <= matched.sum() < B * K and not matched[2].any()
    assert (adj.numpy() != bbox).any(axis=-1)[matched].any()   # replaced


def _outputs(rng, cfg, B, matched):
    """Seeded model outputs and targets for compute_losses."""
    K, J, G = cfg.max_people, cfg.num_joints, cfg.max_people
    nx, ny, nz = cfg.voxels_per_axis
    p2g = np.where(rng.rand(B, K) < matched,
                   rng.randint(0, G, (B, K)), -1).astype(np.float32)
    prop = rng.rand(B, K, 7).astype(np.float32)
    prop[..., 3] = p2g
    outs = {"proposals": prop, "mask": p2g >= 0,
            "hm2d": rng.rand(B, nx, ny).astype(np.float32),
            "hm1d": rng.rand(B, K, nz).astype(np.float32),
            "bbox_flat": rng.rand(B, nx * ny, 2).astype(np.float32),
            "plane_poses": rng.uniform(-2e3, 2e3, (3, B, K, J, 2)
                                       ).astype(np.float32),
            "fused_poses": rng.uniform(-2e3, 2e3, (B, K, J, 5)
                                       ).astype(np.float32)}
    targets = {"2d_heatmaps": rng.rand(B, nx, ny).astype(np.float32),
               "1d_heatmaps": rng.rand(B, G, nz).astype(np.float32),
               "index": rng.randint(0, nx * ny, (B, G)).astype(np.int32),
               "bbox": rng.rand(B, G, 2).astype(np.float32),
               "mask": (np.arange(G)[None] <= rng.randint(0, G, (B, 1))
                        ).astype(np.float32)}
    meta = {"joints_3d": rng.uniform(-2e3, 2e3, (B, G, J, 3)
                                     ).astype(np.float32),
            "joints_3d_vis": (rng.rand(B, G, J) < 0.8).astype(np.float32)}
    return outs, targets, meta


@pytest.mark.parametrize("matched", [0.0, 0.5])
def test_compute_losses_matches_reference(rng, matched):
    cfg = train_cfg()
    outs, targets, meta = _outputs(rng, cfg, 2, matched)
    ref = compute_losses(cfg, *(jtu.tree_map(jnp.asarray, d)
                                for d in (outs, targets, meta)))
    got = t_compute_losses(port_cfg(cfg), *(_torch(d) for d in
                                            (outs, targets, meta)))
    for k, v in ref.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-6,
                                   err_msg=k)
    assert (float(ref["joint"]) > 0) == (matched > 0)


def test_train_forward_matches_reference():
    """FasterVoxelPose in train mode against the reference's
    apply(train=True, mutable=['batch_stats']) on the lockstep's first
    batch: the detection maps, the matched proposals, the poses of the
    matched people, the four losses and every new BatchNorm statistic."""
    cfg, rig, rc, variables, batches = _setup()
    hm, targets, meta = batches[0]
    ref, mut = jax.jit(lambda v: FasterVoxelPose(cfg=cfg).apply(
        v, jnp.asarray(hm), rc, train=True,
        meta=jtu.tree_map(jnp.asarray, meta),
        mutable=["batch_stats"]))(variables)
    ref_losses = compute_losses(cfg, ref, *(jtu.tree_map(jnp.asarray, d)
                                            for d in (targets, meta)))
    tc = port_cfg(cfg)
    model = TModel(tc)
    model.load_state_dict(from_jax_variables(variables))
    model.train()
    out = model(torch.as_tensor(hm), t_rig_constants(tc, port_rig(rig))
                .to("cpu"), train=True, meta=_torch(meta))
    losses = t_compute_losses(tc, out, _torch(targets), _torch(meta))

    mask = np.asarray(ref["mask"])
    np.testing.assert_array_equal(out["mask"].numpy(), mask)
    assert mask.sum() == 3
    for k in ("hm2d", "hm1d", "bbox_flat"):                # as test_torch_nets
        r = np.asarray(ref[k])
        err = float(np.abs(out[k].detach().numpy() - r).max())
        assert err <= F32 * np.abs(r).max(), (k, err)
    np.testing.assert_allclose(out["proposals"].detach().numpy()[..., :4],
                               np.asarray(ref["proposals"])[..., :4],
                               atol=1e-3)
    # mm; the soft-argmax at beta 100 spreads the float32 noise of the
    # features (0.022 mm measured)
    np.testing.assert_allclose(out["fused_poses"].detach().numpy()[mask],
                               np.asarray(ref["fused_poses"])[mask],
                               rtol=0, atol=5e-2)
    for k, v in ref_losses.items():
        np.testing.assert_allclose(float(losses[k].detach()), float(v),
                                   rtol=1e-5,
                                   err_msg=k)
    got_stats = convert_task_nets(_snapshot(model))["batch_stats"]
    for (path, r), (_, g) in zip(
            jtu.tree_flatten_with_path(mut["batch_stats"])[0],
            jtu.tree_flatten_with_path(got_stats)[0]):
        err = float(np.abs(g - np.asarray(r)).max())
        assert err <= 1e-5 * float(np.abs(np.asarray(r)).max()), \
            (jtu.keystr(path), err)


def test_forward_train_flag_must_match_mode():
    cfg = port_cfg(train_cfg())
    model = TModel(cfg)
    with pytest.raises(ValueError, match="eval mode"):
        model.eval()(None, None, train=True)
    with pytest.raises(ValueError, match="train mode"):
        model.train()(None, None, {}, train=False)


def test_lr_boundaries_match_reference():
    """Step decay at epochs 45 and 50 of 200 steps: the JLN's boundaries
    at 9000 and 10000 updates, the HDN's (k = 4) at 2250 and 2500; equal
    to the reference's optax schedule on each side of each boundary."""
    cfg = train_cfg(lr_decay_epochs=(45, 50), lr_decay_factor=0.1,
                    steps_per_epoch=200, accumulation_steps=4)
    tc = port_cfg(cfg)
    for per_k, bounds in ((1, (9000, 10000)), (4, (2250, 2500))):
        sched = _lr_schedule(cfg, per_k)
        for b in bounds:
            for c in (0, b - 1, b, b + 1, 20000):
                np.testing.assert_allclose(lr_at(tc, c, per_k),
                                           float(sched(c)), rtol=1e-6)
        assert lr_at(tc, bounds[0], per_k) == pytest.approx(1e-5)
        assert lr_at(tc, bounds[1], per_k) == pytest.approx(1e-6)
    assert lr_at(port_cfg(train_cfg()), 10 ** 6) == train_cfg().lr


def test_trainer_refuses_other_dtypes():
    """float32 and bfloat16 train (tests/test_torch_train_bf16.py); any
    other compute_dtype raises."""
    cfg = port_cfg(train_cfg()).replace(compute_dtype="float16")
    with pytest.raises(ValueError, match="float32"):
        Trainer(cfg, TModel(cfg), "cpu")


def _model_with(init, seed):
    model = TModel(port_cfg(train_cfg()))
    init(model, torch.Generator().manual_seed(seed))
    return model


@torch.no_grad()
def test_flax_init_distributions():
    """The reference package's default scheme: N(0, 0.001) convs with zero
    bias in CenterNet, C2CNet and P2PNet, lecun-normal WeightNet layers
    (truncated at two std) with zero bias, BatchNorm at 1 / 0 / 0 / 1;
    the same generator seed gives the same weights."""
    m = _model_with(tinit.flax_init, 0)
    w = m.pose_net.center_net.front_layers[0].block[0].weight
    assert 7e-4 < float(w.std()) < 1.3e-3
    assert not m.pose_net.center_net.output_hm[2].bias.any()
    wn = m.joint_net.weight_net
    conv, dense = wn.heatmap_feature_net[0].weight, wn.output[0].weight
    for t, fan in ((conv, 9), (dense, conv.shape[0])):
        std = (1.0 / fan) ** 0.5
        assert 0.8 * std < float(t.std()) < 1.2 * std
        assert float(t.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-7
    assert not wn.output[0].bias.any()
    bn = m.joint_net.conv_net.front_layers[0].block[1]
    assert bool((bn.weight == 1).all()) and not bn.running_mean.any()
    other = _model_with(tinit.flax_init, 0)
    for a, b in zip(m.state_dict().values(), other.state_dict().values()):
        assert torch.equal(a, b)


@torch.no_grad()
def test_reference_reinit_and_torch_like_distributions():
    """The original implementation's scheme: the three small nets
    N(0, 0.001) with zero bias; WeightNet torch's default
    U(+-sqrt(1/fan_in)) for weights and biases; a transposed conv's fan
    by torch's rule (output channels x kernel); BatchNorm untouched."""
    m = _model_with(tinit.flax_init, 0)
    bn_before = m.pose_net.c2c_net.front_layers[0].block[1].weight.clone()
    tinit.reference_reinit(m, torch.Generator().manual_seed(5))
    k = m.pose_net.center_net.front_layers[0].block[0].weight
    assert 5e-4 < float(k.std()) < 2e-3
    assert not m.pose_net.center_net.output_hm[2].bias.any()
    wn = m.joint_net.weight_net
    conv = wn.heatmap_feature_net[0]
    bound = (1.0 / 9) ** 0.5
    assert 0.8 * bound < float(conv.weight.abs().max()) <= bound
    assert wn.output[0].bias.any()
    assert float(wn.output[0].bias.abs().max()) <= (1.0 / 32) ** 0.5
    assert torch.equal(m.pose_net.c2c_net.front_layers[0].block[1].weight,
                       bn_before)
    up = m.pose_net.center_net.encoder_decoder.decoder_upsample2.block[0]
    tinit.torch_like_reinit(up, torch.Generator().manual_seed(1))
    fan = up.weight.shape[1] * 4                     # (in, out, 2, 2)
    assert float(up.weight.abs().max()) <= (1.0 / fan) ** 0.5
    assert float(up.weight.abs().max()) > 0.8 * (1.0 / fan) ** 0.5
