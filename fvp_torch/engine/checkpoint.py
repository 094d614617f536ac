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
Reading the reference package's flax msgpack checkpoints is not done here.
"""

from __future__ import annotations

import os

import torch

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
