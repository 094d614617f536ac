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
format runs code when it is read. Resuming the reference's
`checkpoint.msgpack` train state is not done here.
"""

from __future__ import annotations

import os

import torch

from fvp_torch.engine import flax_msgpack
from fvp_torch.models.convert import (from_jax_backbone_variables,
                                      from_jax_variables)

CHECKPOINT = "checkpoint.pth"
BEST = "model_best.pth"


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
