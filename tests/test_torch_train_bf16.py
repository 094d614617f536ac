"""bf16 training: the port's Trainer at compute_dtype='bfloat16' in
lockstep with the reference's make_train_step_fn at the same dtype, on the
CPU, from the same seeded weights and batches as
tests/test_torch_train_lockstep.py (its first two steps, the
ACCUMULATION_QUIRK off and on); each net alone in train mode against its
flax module built with dtype=bfloat16, gradients included; and the
data-parallel step on a (1, 1) mesh against the single Trainer at bf16,
bit for bit.

Both sides build the four nets in bf16 (convs on bf16 operands, the bias
added after the rounding, BatchNorms with float32 statistics rounding to
bf16, the 1x1 heads float32) with float32 parameters, gradients and
Adams. They round at the same points, but sums in another order round
to the neighbouring bf16 value now and then, and such a flip carries on
through a net. In train mode it also moves the BatchNorms' batch
statistics, and C2CNet's, over a batch of 8 columns of 2 cells at its
deepest level, amplify it: its z maps part by ~1% of their scale between
the two sides, and between two runs of the port on 1 and 4 threads by
up to 5%, enough to move a z pick and with it which proposal a person
matches. So the whole step is held where it is robust (losses, the
parameters in units of the learning rate, the running statistics,
CenterNet's gradients), and each net's gradients are held alone, on a
fixed input and a fixed linear loss. The tolerances are measured."""

import functools

import jax.tree_util as jtu
import numpy as np
import pytest
import torch
import torch.distributed as dist

from fvp_torch.engine.train import Trainer
from fvp_torch.geometry.grids import build_rig_constants as \
    port_rig_constants
from fvp_torch.models.blocks import Conv2d
from fvp_torch.models.convert import from_jax_variables
from fvp_torch.models.faster_voxelpose import FasterVoxelPose as TModel
from fvp_torch.parallel import make_mesh, make_sharded_train_step, \
    shard_batch, shard_data
from fvp_torch.parallel.mesh import free_port, init_distributed
from tests import test_torch_train_lockstep as lock
from tests import test_torch_train_sharded as shard

STEPS = 2
# Losses, relative. Measured 2.1e-2 (the 1d loss of the first step): the
# two sides' bf16 roundings flip apart now and then (a float32 sum in
# another order lands on the other side of a bf16 rounding boundary), and
# in train mode a flip moves the BatchNorms' batch statistics, so the
# nets' outputs part by ~1% of their scale (hm2d 2.8e-2, hm1d 1.0e-2 on
# the first batch) where the modules alone, on one input, agree to 1e-7
# (C2CNet) or 1.2e-2 (CenterNet).
LOSS_RTOL = 5e-2
# The whole step's first gradients, CenterNet's (its losses, 2d and bbox,
# do not go through the z pick): the relative Frobenius norm of the
# difference over the tensors whose exact gradient is not zero (a conv's
# bias that feeds a BatchNorm has gradient 0; the reference's XLA:CPU sums
# it in bf16, to up to 0.84 where the rest of WeightNet's gradient is
# 0.18, torch in float32). Measured 0.10-0.11 on 1 and 4 threads; the
# reference's own bf16 gradients differ from its float32 ones by 0.11.
# The other nets' are printed: 0.30-0.72 (C2CNet), 0.09-0.57 (P2PNet),
# 0.57-0.99 (WeightNet) on 4 and 1 threads, downstream of the z pick.
CENTERNET_GRAD_FRO = 0.2
# Each net alone (test_bf16_net_gradients): every tensor's gradient
# within this much of its net's largest gradient. Measured: C2CNet
# 1.2e-2, WeightNet 5.0e-5; CenterNet 0.13-0.15 and P2PNet 0.07-0.10,
# both on their first ResBlock's 1x1 projection kernel, whose gradient
# sums x * dz over every pixel of a bf16 cotangent dz that the BatchNorm
# after it has centred (a difference of large terms: 4.6e-3 apart already
# in float32 for CenterNet).
NET_GRAD_RTOL = {"c2c_net": 2e-2, "weight_net": 2e-2, "center_net": 0.2,
                 "p2p_net": 0.2}
# Parameters after two steps, in units of the learning rate: Adam moves
# an entry by ~lr a step whatever its gradient's size, so an entry whose
# gradient's sign differs between the two bf16 runs lands 2 lr an update
# apart: each tensor within 2 lr per update its optimizer applied, plus
# the float32 rounding of the two parameters (tests/test_torch_train_
# sharded.py).
PARAM_LR_PER_UPDATE = 2.0
PARAM_ROUNDING_LR = 1e-2
# BatchNorm running statistics after each step against each tensor's
# largest entry: bf16 activations' batch statistics, measured 6.2e-2 (on
# C2CNet's deepest level, 1 thread; printed).
STATS_RTOL = 0.1


def _zero_in_exact(path) -> bool:
    """A conv bias that feeds a BatchNorm (every conv of the hourglass
    blocks, WeightNet's conv): its exact gradient is 0."""
    keys = [getattr(k, "key", "") for k in path]
    return keys[-1] == "bias" and keys[-2].startswith("Conv") and (
        keys[0] == "weight_net" or any(k.startswith((
            "BasicBlock", "ResBlock", "UpsampleBlock")) for k in keys))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _runs(quirk: bool):
    cfg, rig, rc, variables, batches = lock._setup()
    cfg = cfg.replace(compute_dtype="bfloat16", accumulation_quirk=quirk)
    batches = batches[:STEPS]
    ref = lock.run_reference(cfg, rc, variables, batches)
    ref[0]["grads"] = lock.reference_gradients(cfg, rc, variables,
                                               batches[0])
    got, trainer = lock.run_port(cfg, rig, variables, batches)
    return cfg, variables, ref, got, trainer


def test_bf16_trainer_builds_bf16_nets():
    """Every conv and BatchNorm of the four nets computes in bf16 but the
    1x1 output heads; the parameters stay float32."""
    cfg = lock.port_cfg(lock.train_cfg()).replace(compute_dtype="bfloat16")
    model = Trainer(cfg, TModel(cfg), "cpu").model
    heads = {"pose_net.center_net.output_hm.2",
             "pose_net.center_net.output_size.2", "pose_net.c2c_net.output_hm",
             "joint_net.conv_net.output_layer"}
    typed = {name: m.compute_dtype for name, m in model.named_modules()
             if hasattr(m, "compute_dtype")}
    assert len(typed) > 100 and not heads & set(typed)
    assert all(d == torch.bfloat16 for d in typed.values())
    for name in heads:
        assert type(model.get_submodule(name)) in (torch.nn.Conv1d,
                                                   torch.nn.Conv2d), name
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert isinstance(model.pose_net.center_net.output_hm[0], Conv2d)


@pytest.mark.parametrize("quirk", [False, True])
def test_bf16_lockstep_losses(quirk):
    _, _, ref, got, _ = _runs(quirk)
    worst = 0.0
    for i, (r, g) in enumerate(zip(ref, got)):
        for k, v in r["losses"].items():
            err = abs(g["losses"][k] - v) / max(abs(v), 1e-12)
            worst = max(worst, err if v else 0.0)
            np.testing.assert_allclose(g["losses"][k], v, atol=1e-9,
                                       rtol=LOSS_RTOL,
                                       err_msg=f"step {i} {k}")
    print(f"bf16 quirk {quirk}: losses within {worst:.3g} (relative)")
    joint = [r["losses"]["joint"] for r in ref]
    assert joint[0] > 0 and joint[1] > 0


def test_bf16_lockstep_first_step_gradients():
    _, _, ref, got, _ = _runs(False)
    num, den = {}, {}
    for (path, r), g in lock._pairs(ref[0]["grads"], got[0]["grads"]):
        assert g.shape == r.shape, path
        assert np.isfinite(g).all(), path
        if _zero_in_exact(path):
            continue
        n = path[0].key
        num[n] = num.get(n, 0.0) + float(((g - r) ** 2).sum())
        den[n] = den.get(n, 0.0) + float((r ** 2).sum())
    fro = {n: (num[n] / den[n]) ** 0.5 for n in num}
    print("bf16: first-step gradients, relative Frobenius difference per "
          "net: " + ", ".join(f"{n} {v:.3g}" for n, v in fro.items()))
    assert min(den.values()) > 0
    assert fro["center_net"] <= CENTERNET_GRAD_FRO


def _flax_net(name, cfg):
    import jax.numpy as jnp
    from fvp_tpu.models.cnns import C2CNet, CenterNet, P2PNet, WeightNet
    bf = jnp.bfloat16
    return {"c2c_net": C2CNet(dtype=bf), "center_net": CenterNet(dtype=bf),
            "p2p_net": P2PNet(num_joints=cfg.num_joints, dtype=bf),
            "weight_net": WeightNet(
                feat_channels=cfg.num_channel_joint_feat,
                hidden_channels=cfg.num_channel_joint_hidden, dtype=bf,
                use_pallas=False)}[name]


@pytest.mark.parametrize("name", ["c2c_net", "center_net", "p2p_net",
                                  "weight_net"])
def test_bf16_net_gradients(name):
    """One net in bf16 train mode (batch statistics; P2PNet and WeightNet
    with a per-scene mask) on a seeded input, the loss sum(y * g) for a
    seeded g: the output within 2e-2 of its scale (bf16's; measured
    1.34e-2 for CenterNet) and every tensor's
    gradient within NET_GRAD_RTOL of the net's largest one."""
    import jax
    import jax.numpy as jnp
    from fvp_torch.models.convert import to_jax_variables
    cfg, _, _, variables, _ = lock._setup()
    tc = lock.port_cfg(cfg).replace(compute_dtype="bfloat16")
    model = TModel(tc)
    model.load_state_dict(from_jax_variables(variables))
    model.train()
    net = {"c2c_net": model.pose_net.c2c_net,
           "center_net": model.pose_net.center_net,
           "p2p_net": model.joint_net.conv_net,
           "weight_net": model.joint_net.weight_net}[name]
    rng = np.random.RandomState(1)
    J = cfg.num_joints
    mask = None
    if name == "c2c_net":
        x = rng.rand(8, 8, J)
    elif name == "center_net":
        x = rng.rand(2, 32, 32, 8, J)
    else:
        x = rng.rand(12, 16, 16, J)
        mask = np.ones((2, 6), bool)
        mask[0, 4:] = False
    x = x.astype(np.float32)
    kw = {} if mask is None else {"mask": jnp.asarray(mask)}
    v = {"params": variables["params"][name],
         "batch_stats": variables["batch_stats"][name]}
    flax = _flax_net(name, cfg)

    def first(y):
        return y[0] if isinstance(y, tuple) else y

    y_ref = first(flax.apply(v, jnp.asarray(x), train=True,
                             mutable=["batch_stats"], **kw)[0])
    g_out = np.random.RandomState(2).randn(*y_ref.shape).astype(np.float32)

    def loss(p):
        y = flax.apply({"params": p, "batch_stats": v["batch_stats"]},
                       jnp.asarray(x), train=True, mutable=["batch_stats"],
                       **kw)[0]
        return jnp.sum(first(y) * g_out)
    ref = jax.grad(loss)(v["params"])
    args = [torch.from_numpy(x)] + ([] if mask is None
                                    else [torch.from_numpy(mask)])
    y = first(net(*args))
    assert y.dtype == torch.float32
    (y * torch.from_numpy(g_out)).sum().backward()
    y_ref = np.asarray(y_ref)
    out_err = float(np.abs(y.detach().numpy() - y_ref).max()
                    / np.abs(y_ref).max())
    state = {k: t.detach().clone() for k, t in model.state_dict().items()}
    for n, p in model.named_parameters():
        state[n] = p.grad if p.grad is not None else torch.zeros_like(p)
    got = to_jax_variables(state)["params"][name]
    pairs = [(path, r, g) for (path, r), g in lock._pairs(ref, got)
             if not _zero_in_exact((jtu.DictKey(name),) + tuple(path))]
    scale = max(float(np.abs(r).max()) for _, r, _ in pairs)
    worst = max(float(np.abs(g - np.asarray(r)).max()) for _, r, g in pairs)
    print(f"bf16 {name} alone: output within {out_err:.3g} of its scale, "
          f"gradients within {worst / scale:.3g} of the largest")
    assert out_err < 2e-2
    assert worst <= NET_GRAD_RTOL[name] * scale


@pytest.mark.parametrize("quirk", [False, True])
def test_bf16_lockstep_parameters(quirk):
    cfg, variables, ref, got, _ = _runs(quirk)
    updates = {n: sum(lock._pattern(cfg, variables, ref, (n,)))
               for n in ref[-1]["params"]}
    assert updates == {n: sum(lock._pattern(cfg, variables, got, (n,)))
                       for n in ref[-1]["params"]}
    assert updates["p2p_net"] == STEPS
    worst = 0.0
    for (path, r), g in lock._pairs(ref[-1]["params"], got[-1]["params"]):
        d = float((np.abs(g - r) / cfg.lr).max())
        worst = max(worst, d)
        bound = PARAM_LR_PER_UPDATE * updates[path[0].key] \
            + PARAM_ROUNDING_LR
        assert d <= bound, (jtu.keystr(path), d)
    print(f"bf16 quirk {quirk}: parameters after {STEPS} steps within "
          f"{worst:.4g} lr; updates {updates}")


@pytest.mark.parametrize("quirk", [False, True])
def test_bf16_lockstep_batch_stats(quirk):
    _, _, ref, got, _ = _runs(quirk)
    worst = 0.0
    for i in range(STEPS):
        for (path, r), g in lock._pairs(ref[i]["batch_stats"],
                                        got[i]["batch_stats"]):
            err = float(np.abs(g - r).max()) / float(np.abs(r).max())
            worst = max(worst, err)
            assert err <= STATS_RTOL, (i, jtu.keystr(path), err)
    print(f"bf16 quirk {quirk}: running statistics within {worst:.3g}")


@pytest.fixture
def world1():
    init_distributed(f"127.0.0.1:{free_port()}", 1, 0, "cpu")
    yield
    dist.destroy_process_group()


def test_bf16_world1_is_the_trainer_bit_for_bit(world1):
    """A (1, 1) mesh at bf16: two sharded steps give Trainer.train_step's
    losses, parameters and running statistics bit for bit."""
    cfg, rig, _, variables, batches = shard._setup()
    tc = shard._port(cfg).replace(compute_dtype="bfloat16")
    rc = port_rig_constants(tc, shard._port_rig(rig)).to("cpu")
    trainers = []
    for _ in range(2):
        model = TModel(tc)
        model.load_state_dict(from_jax_variables(variables))
        trainers.append(Trainer(tc, model, "cpu"))
    mesh = make_mesh(1, 1)
    step = make_sharded_train_step(trainers[0], mesh)
    for hm, targets, meta in batches:
        a = step(shard_batch(mesh, torch.as_tensor(hm)), rc,
                 shard._torch(shard_data(mesh, targets)),
                 shard._torch(shard_data(mesh, meta)))
        b = trainers[1].train_step(torch.as_tensor(hm), rc,
                                   shard._torch(targets),
                                   shard._torch(meta))
        for k in a:
            assert torch.equal(a[k], b[k]), k
        assert float(b["joint"]) > 0 or float(b["total"]) > 0
    sa, sb = (t.model.state_dict() for t in trainers)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_train_cli_at_bf16(tmp_path):
    """run/train_torch.py --compute-dtype bfloat16 on the CPU: an epoch of
    the tiny config, its evaluation and checkpoint, the trainer at bf16."""
    from tests.test_torch_train_cli import _cli, _tiny_yaml

    cfg_path = _tiny_yaml(tmp_path)
    out = tmp_path / "out" / "tiny"
    assert _cli().main(["--cfg", cfg_path, "--epochs", "1", "--device",
                        "cpu", "--compute-dtype", "bfloat16"]) == 0
    ckpt = torch.load(out / "checkpoint.pth", weights_only=True)
    assert ckpt["epoch"] == 1 and ckpt["trainer"]["step"] == 3
    text = "".join(p.read_text() for p in out.iterdir()
                   if p.name.startswith("train_torch"))
    assert "compute_dtype='bfloat16'" in text
    assert "epoch 0 [0/3] loss" in text and "epoch 0 metrics" in text
