"""Checkpoints of training: the full train state in one file, and the best
model's weights in another.

`checkpoint.pth` holds the trainer's state (engine/train.py::
Trainer.state_dict: the model's state dict with its BatchNorm statistics,
both optimizers, the step and update counts and the HDN's accumulation
window), the epoch, the step within it (a mid-epoch save resumes there)
and the best metric. `model_best.pth` holds the model's state dict alone,
with the original implementation's keys, which run/validate_torch.py
--checkpoint reads. Both are written atomically (a temporary file, then
os.replace) and read with weights_only=True, so loading one runs no code.

`load_model_state` and `load_backbone_state` read the weights that the
CLIs and the service load, choosing by extension as the reference's
run/train.py does: a `.pth` or `.tar` is a torch state dict; anything
else is the reference package's flax msgpack (`model_best.msgpack` from
its save_best, a backbone from its tools/convert_backbone.py), decoded
by engine/flax_msgpack.py and mapped through models/convert.py. Neither
format runs code when it is read.

`load_reference_checkpoint` resumes the reference's own train state,
`checkpoint.msgpack` (fvp_tpu/engine/checkpoint.py::save_checkpoint: the
epoch, the step within it, the best metric and the flat leaf list of its
TrainState) into a Trainer: the parameters and BatchNorm statistics
through models/convert.py, each optax Adam's `count`, `mu` and `nu` as
torch Adam's `step`, `exp_avg` and `exp_avg_sq` for both optimizers, and
the HDN's accumulation window (optax.MultiSteps' running mean, or the
ACCUMULATION_QUIRK's `acc_grads`, `acc_loss` and `acc_count`).
`train_state_layout` is the port's own description of that leaf order:
no JAX is needed to read the file.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from fvp_torch.engine import flax_msgpack
from fvp_torch.models.convert import (from_jax_backbone_variables,
                                      from_jax_variables, to_jax_variables)

CHECKPOINT = "checkpoint.pth"
BEST = "model_best.pth"
REFERENCE_CHECKPOINT = "checkpoint.msgpack"
# the reference's optimizer split (fvp_tpu/engine/train.py HDN_MODULES,
# JLN_MODULES)
HDN_NETS = ("center_net", "c2c_net")


def _save_atomic(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(out_dir: str, trainer, epoch: int, best_metric: float,
                    is_best: bool = False, step_in_epoch: int = 0) -> str:
    """Write out_dir/checkpoint.pth (and model_best.pth when `is_best`).
    `step_in_epoch` > 0 marks a mid-epoch save: resuming skips that many
    batches of `epoch`."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, CHECKPOINT)
    _save_atomic({"trainer": trainer.state_dict(), "epoch": int(epoch),
                  "step_in_epoch": int(step_in_epoch),
                  "best_metric": float(best_metric)}, path)
    if is_best:
        save_best(out_dir, trainer.model)
    return path


def load_checkpoint(out_dir: str, trainer):
    """Restore out_dir/checkpoint.pth into `trainer`; returns (epoch,
    best_metric, step_in_epoch), or None when there is none."""
    path = os.path.join(out_dir, CHECKPOINT)
    if not os.path.exists(path):
        return None
    payload = torch.load(path, map_location=trainer.device, weights_only=True)
    trainer.load_state_dict(payload["trainer"])
    return (int(payload["epoch"]), float(payload["best_metric"]),
            int(payload["step_in_epoch"]))


def save_best(out_dir: str, model) -> str:
    """Write out_dir/model_best.pth: the model's state dict (weights and
    BatchNorm statistics)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, BEST)
    _save_atomic({k: v.detach().cpu() for k, v in model.state_dict().items()},
                 path)
    return path


def load_best(path: str, model) -> None:
    """Load a model_best.pth (a file, or the directory holding one) into
    `model`; missing or unexpected keys raise."""
    if os.path.isdir(path):
        path = os.path.join(path, BEST)
    model.load_state_dict(torch.load(path, map_location="cpu",
                                     weights_only=True))


def _is_torch_file(path: str) -> bool:
    return path.endswith((".pth", ".tar"))


def _read_state_dict(path: str) -> dict:
    """A reference-keyed state dict from a torch file: the dict itself or
    its 'state_dict' entry, a leading `module.` (DataParallel) dropped."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and isinstance(state.get("state_dict"), dict):
        state = state["state_dict"]
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in state.items()}


def _float32_leaves(tree):
    """bfloat16 leaves (torch tensors from flax_msgpack) widened to
    float32 numpy, which is exact; every other leaf as it is."""
    if isinstance(tree, dict):
        return {k: _float32_leaves(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return tree


def _flax_variables(path: str) -> dict:
    tree = _float32_leaves(flax_msgpack.load(path))
    if not {"params", "batch_stats"} <= set(tree):
        raise ValueError(f"{path}: expected a flax {{'params', "
                         f"'batch_stats'}} tree, got keys {sorted(tree)}")
    return tree


def load_model_state(path: str) -> dict:
    """FasterVoxelPose's state dict from a torch file or the reference's
    model_best.msgpack."""
    if _is_torch_file(path):
        return _read_state_dict(path)
    return from_jax_variables(_flax_variables(path))


def load_backbone_state(path: str) -> dict:
    """PoseResNet's state dict from a torch file or the reference's
    backbone msgpack."""
    if _is_torch_file(path):
        return _read_state_dict(path)
    return from_jax_backbone_variables(_flax_variables(path))


# -- the reference's checkpoint.msgpack -----------------------------------------

def _flatten(tree, prefix=()) -> list:
    """[(path, leaf)] of a nested dict in jax.tree_util's order: the keys
    of every dict sorted."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flatten(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def _unflatten(items) -> dict:
    tree: dict = {}
    for path, leaf in items:
        d = tree
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = leaf
    return tree


def train_state_layout(cfg, variables) -> list:
    """(part, path, shape) of every leaf of the reference's TrainState in
    the order of jax.tree_util.tree_leaves, for the flax variables'
    structure `variables` ({'params', 'batch_stats'}) and the config's
    optimizers (fvp_tpu/engine/train.py): the dataclass's fields in order
    (params, batch_stats, hdn_opt, jln_opt, step, then with the quirk
    acc_grads, acc_loss, acc_count); an optax Adam is (count, mu, nu) and,
    with a learning-rate schedule, its schedule's count; the HDN's without
    the quirk is optax.MultiSteps' (mini_step, gradient_step, the Adam,
    acc_grads)."""
    params = _flatten(variables["params"])
    hdn = [(p, a) for p, a in params if p[0] in HDN_NETS]
    jln = [(p, a) for p, a in params if p[0] not in HDN_NETS]

    def tree(part, prefix, items):
        return [(part, prefix + p, np.shape(a)) for p, a in items]

    def adam(part, items):
        out = [(part, ("count",), ())] + tree(part, ("mu",), items) \
            + tree(part, ("nu",), items)
        if cfg.lr_decay_epochs:
            out.append((part, ("schedule_count",), ()))
        return out

    out = tree("params", (), params) \
        + tree("batch_stats", (), _flatten(variables["batch_stats"]))
    if cfg.accumulation_quirk:
        out += adam("hdn_opt", hdn)
    else:
        out += [("hdn_opt", ("mini_step",), ()),
                ("hdn_opt", ("gradient_step",), ())] \
            + adam("hdn_opt", hdn) + tree("hdn_opt", ("acc_grads",), hdn)
    out += adam("jln_opt", jln) + [("step", (), ())]
    if cfg.accumulation_quirk:
        out += tree("acc_grads", (), hdn) + [("acc_loss", (), ()),
                                             ("acc_count", (), ())]
    return out


def _leaf(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def read_reference_checkpoint(path: str, cfg, variables) -> dict:
    """The reference's checkpoint.msgpack as {'epoch', 'step_in_epoch',
    'best_metric', 'state'}: the state's leaves as nested dicts per part
    of train_state_layout (its params, batch_stats, the two optimizers'
    states, ...), each leaf's shape checked against `variables`."""
    payload = flax_msgpack.load(path)
    stored = payload["state"]
    if isinstance(stored, dict):
        stored = [stored[k] for k in sorted(stored, key=int)]
    layout = train_state_layout(cfg, variables)
    if len(stored) != len(layout):
        raise ValueError(
            f"{path}: {len(stored)} train-state leaves, expected "
            f"{len(layout)} for this model (accumulation_quirk="
            f"{cfg.accumulation_quirk}, lr schedule "
            f"{bool(cfg.lr_decay_epochs)})")
    parts: dict = {}
    for (part, p, shape), leaf in zip(layout, stored):
        leaf = _leaf(leaf)
        if leaf.shape != shape:
            raise ValueError(f"{path}: leaf {part}/{'/'.join(p)} has shape "
                             f"{leaf.shape}, expected {shape}")
        parts.setdefault(part, []).append((p, leaf))
    state = {part: items[0][1] if items[0][0] == () else _unflatten(items)
             for part, items in parts.items()}
    return {"epoch": int(payload["epoch"]),
            "step_in_epoch": int(payload.get("step_in_epoch", 0)),
            "best_metric": float(payload["best_metric"]), "state": state}


def _per_param(trainer, subtrees: dict, batch_stats: dict) -> dict:
    """Tensors shaped like the params of the nets in `subtrees` (an Adam
    moment, gradients) -> {parameter name: tensor} of the port's model,
    through the model converter (the other nets' entries filled from the
    model's own parameters and dropped)."""
    full = dict(to_jax_variables(trainer.model.state_dict())["params"])
    full.update(subtrees)
    state = from_jax_variables({"params": full, "batch_stats": batch_stats})
    return {n: state[n] for n, _ in trainer.model.named_parameters()}


def _set_adam(trainer, opt, adam: dict, batch_stats: dict) -> int:
    """optax Adam state {'count', 'mu', 'nu'} -> torch Adam's per-parameter
    step, exp_avg and exp_avg_sq; returns the count."""
    count = int(adam["count"])
    mu = _per_param(trainer, adam["mu"], batch_stats)
    nu = _per_param(trainer, adam["nu"], batch_stats)
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    opt.state.clear()
    for p in opt.param_groups[0]["params"]:
        n = names[id(p)]
        opt.state[p] = {"step": torch.tensor(float(count)),
                        "exp_avg": mu[n].to(p.device).clone(),
                        "exp_avg_sq": nu[n].to(p.device).clone()}
    return count


def load_reference_checkpoint(path: str, trainer):
    """Restore the reference's checkpoint.msgpack (a file, or the
    directory holding one) into `trainer`; returns (epoch, best_metric,
    step_in_epoch) as load_checkpoint does."""
    if os.path.isdir(path):
        path = os.path.join(path, REFERENCE_CHECKPOINT)
    variables = to_jax_variables(trainer.model.state_dict())
    ck = read_reference_checkpoint(path, trainer.cfg, variables)
    st = ck["state"]
    stats = st["batch_stats"]
    trainer.model.load_state_dict(from_jax_variables(
        {"params": st["params"], "batch_stats": stats}))
    hdn = st["hdn_opt"]
    trainer.hdn_updates = _set_adam(trainer, trainer.hdn_opt, hdn, stats)
    trainer.jln_updates = _set_adam(trainer, trainer.jln_opt, st["jln_opt"],
                                    stats)
    trainer.step = int(st["step"])
    if trainer.cfg.accumulation_quirk:
        acc = st["acc_grads"]
        trainer.acc_count = int(st["acc_count"])
        trainer.acc_loss.fill_(float(st["acc_loss"]))
    else:
        acc = hdn["acc_grads"]
        trainer.acc_count = int(hdn["mini_step"])
    acc = _per_param(trainer, acc, stats)
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    for a, p in zip(trainer.acc_grads, trainer.hdn_params):
        a.copy_(acc[names[id(p)]])
    return ck["epoch"], ck["best_metric"], ck["step_in_epoch"]
