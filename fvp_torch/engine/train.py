"""Training: the reference package's dual-optimizer step
(fvp_tpu/engine/train.py) in PyTorch, on one device; the data-parallel
step over a mesh of ranks (parallel/sharding.py::make_sharded_train_step)
runs its own forward and then `Trainer.update` with the 'data' axis.

Two Adam optimizers (optax's defaults: b1 0.9, b2 0.999, eps 1e-8) over
disjoint parameter sets:
  * HDN (`pose_net`: CenterNet + C2CNet), on the detection losses (2d +
    1d + bbox), averaged over `accumulation_steps` batches: the k-batch
    running mean of optax.MultiSteps, one Adam step on every k-th call;
    with TRAIN.ACCUMULATION_QUIRK the original implementation's
    interleaving instead (below);
  * JLN (`joint_net`: P2PNet + WeightNet), on the joint loss every batch,
    skipped when the joint loss is 0 (no proposal matched): its Adam state
    does not advance then.
The proposals are cut from the graph before the JLN, so the joint loss
reaches no HDN parameter and the detection losses no JLN one: one backward
of their sum gives both optimizers' gradients.

ACCUMULATION_QUIRK: the HDN steps at every k-th call of an epoch on the
window of the k-1 calls before it (the stepping call's detection gradient
is dropped), each added as g / k, and only when the window's accumulated
detection loss is > 0; `reset_accumulation` opens a new window at each
epoch. The learning rate is the reference's `_lr_schedule`: constant, or
step decay at TRAIN.LR_DECAY_EPOCHS, its boundaries counted in applied
updates of each optimizer (epochs x steps_per_epoch / k for the HDN).

The step takes heatmaps (B, V, J, H, W), a render-parameter dict (the
device splat, ops/heatmap_render.py) or, with a backbone, normalised
images (B, V, H, W, 3) run through the frozen, eval-mode backbone without
gradient, as engine/serve.py::backbone_heatmaps serves them (its stem and
deconv kernels on the card). It trains at `compute_dtype` 'float32' or
'bfloat16', as the reference's make_train_step does: under 'bfloat16' the
four nets compute in bf16 as flax builds them (models/blocks.py: convs on
bf16 operands, BatchNorms with float32 statistics rounding to bf16, the
1x1 output heads float32), the backbone serves in bf16, and the
parameters, gradients, both Adams, the soft-argmax and the losses stay
float32. Whatever is float32 computes without TF32
(engine/serve.py::float32_math); any other `compute_dtype` raises.
"""

from __future__ import annotations

from typing import Mapping

import torch

from fvp_torch.config import FVPConfig
from fvp_torch.engine.packing import check_compute_dtype, pack_backbone
from fvp_torch.engine.serve import (backbone_heatmaps, float32_math,
                                    resolve_device)
from fvp_torch.engine.validate import RENDER_KEYS, batch_input
from fvp_torch.models.faster_voxelpose import FasterVoxelPose, compute_losses
from fvp_torch.models.resnet import PoseResNet
from fvp_torch.ops.heatmap_render import render_heatmaps_device

LOSS_KEYS = ("total", "2d_heatmaps", "1d_heatmaps", "bbox", "joint")


def lr_at(cfg: FVPConfig, count: int, per_k: int = 1) -> float:
    """The learning rate of an optimizer that has applied `count` updates:
    cfg.lr, times lr_decay_factor for each boundary reached, a boundary
    at epoch e being max(e * steps_per_epoch // per_k, 1) updates (optax's
    piecewise_constant_schedule, as the reference's `_lr_schedule` builds
    it; `per_k` is the HDN's accumulation window)."""
    if not cfg.lr_decay_epochs:
        return cfg.lr
    spe = max(cfg.steps_per_epoch, 1)
    bounds = {max(int(e) * spe // per_k, 1): cfg.lr_decay_factor
              for e in cfg.lr_decay_epochs}
    lr = cfg.lr
    for b, factor in bounds.items():
        if count >= b:
            lr *= factor
    return lr


def make_optimizers(cfg: FVPConfig, model: FasterVoxelPose):
    """(HDN Adam, JLN Adam) over pose_net's and joint_net's parameters."""
    def adam(params):
        return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999),
                                eps=1e-8)
    return (adam(list(model.pose_net.parameters())),
            adam(list(model.joint_net.parameters())))


def step_inputs(batch: Mapping, device) -> tuple:
    """(input, targets, meta) of a collated batch, copied to `device`: the
    step's input as engine/validate.py::batch_input picks it (render
    parameters, heatmaps or images), the targets and meta as tensors."""
    def tensors(d):
        return {k: torch.as_tensor(v).to(device) for k, v in d.items()}
    return (batch_input(batch, device), tensors(batch["targets"]),
            tensors(batch["meta"]))


def _host_flag(t: torch.Tensor):
    """A bool scalar's value, copied to the host without waiting for the
    rest of the stream: call the result to read it."""
    if not t.is_cuda:
        return lambda: bool(t)
    host = torch.empty((), dtype=torch.bool, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def read() -> bool:
        done.synchronize()
        return bool(host)
    return read


class Trainer:
    """The train state on one device: the model in train mode, the two
    optimizers, the step and update counts, the HDN's accumulation window,
    and a frozen backbone for image-source training. Runs on `cuda` unless
    the caller passes a device, and raises without a card."""

    def __init__(self, cfg: FVPConfig, model: FasterVoxelPose, device=None,
                 backbone: PoseResNet | None = None):
        check_compute_dtype(cfg.compute_dtype)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device).train()
        self.hdn_opt, self.jln_opt = make_optimizers(cfg, self.model)
        self.hdn_params = self.hdn_opt.param_groups[0]["params"]
        self.step = 0
        self.hdn_updates = 0
        self.jln_updates = 0
        # the HDN window: the running mean of its gradients (MultiSteps) or
        # their sum / k (the quirk), its call count and (quirk) its loss
        self.acc_grads = [torch.zeros_like(p) for p in self.hdn_params]
        self.acc_count = 0
        self.acc_loss = torch.zeros((), device=self.device)
        self.backbone = self.backbone_packed = None
        if backbone is not None:
            self.backbone = backbone.eval().to(self.device)
            self.backbone.requires_grad_(False)
            self.backbone_packed = pack_backbone(self.backbone,
                                                 cfg.compute_dtype)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def heatmaps(self, x) -> torch.Tensor:
        """The step's heatmaps (B, V, J, h, w) from its input: images
        through the frozen backbone, render parameters through the device
        splat, or the heatmaps themselves."""
        if self.backbone is not None:
            return backbone_heatmaps(self.cfg, self.backbone,
                                     self.backbone_packed, x)
        if isinstance(x, Mapping):
            return render_heatmaps_device(self.cfg,
                                          *(x[k] for k in RENDER_KEYS))
        return x

    def train_step(self, x, rc, targets: Mapping,
                   meta: Mapping) -> dict[str, torch.Tensor]:
        """One step on a batch on the trainer's device (`x`, `targets`,
        `meta` as `step_inputs` gives them); returns the losses
        (LOSS_KEYS) as device scalars."""
        with float32_math():
            out = self.model(self.heatmaps(x), rc, train=True, meta=meta)
            return self.update(out, targets, meta)

    def update(self, out: dict, targets: Mapping, meta: Mapping,
               data=None) -> dict[str, torch.Tensor]:
        """The step after the forward: the losses of the train-mode
        forward's output `out`, one backward, both optimizers. `data`
        (the data-parallel step, parallel/sharding.py): the 'data' axis
        (parallel/mesh.py::Axis) whose ranks hold the other blocks of the
        batch. The losses then take the global batch's denominators, the
        gradients are summed over the axis, and the returned losses, the
        JLN's gate and the HDN window read the global batch's losses, so
        every rank takes the same updates."""
        cfg = self.cfg
        losses = compute_losses(cfg, out, targets, meta, data)
        local = losses
        if data is not None:
            total = data.all_reduce_sum(torch.stack(
                [losses[k].detach() for k in LOSS_KEYS]))
            losses = dict(zip(LOSS_KEYS, total))
        hdn_loss = (losses["2d_heatmaps"] + losses["1d_heatmaps"]
                    + losses["bbox"])
        jln_steps = _host_flag(losses["joint"] > 0)
        self.model.zero_grad(set_to_none=True)
        (local["2d_heatmaps"] + local["1d_heatmaps"] + local["bbox"]
         + local["joint"]).backward()
        if data is not None:
            grads = [p.grad for p in self.model.parameters()
                     if p.grad is not None]
            total = data.all_reduce_sum(torch.cat([g.reshape(-1)
                                                   for g in grads]))
            for g, t in zip(grads, total.split([g.numel() for g in grads])):
                g.copy_(t.view_as(g))
        self._hdn_update(hdn_loss.detach())
        if jln_steps():
            for group in self.jln_opt.param_groups:
                group["lr"] = lr_at(cfg, self.jln_updates)
            self.jln_opt.step()
            self.jln_updates += 1
        self.step += 1
        return {k: v.detach() for k, v in losses.items()}

    def _hdn_update(self, hdn_loss: torch.Tensor) -> None:
        cfg = self.cfg
        k = cfg.accumulation_steps
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.hdn_params]
        acc = self.acc_grads
        if cfg.accumulation_quirk:
            if (self.acc_count + 1) % k == 0 and bool(self.acc_loss > 0):
                self._hdn_step(acc)
                self.acc_loss.zero_()
            else:
                torch._foreach_add_(acc, torch._foreach_div(grads, k))
                self.acc_loss += hdn_loss / k
            self.acc_count += 1
            return
        # optax.MultiSteps: acc += (g - acc) / (n + 1); Adam on the mean
        n = self.acc_count
        delta = torch._foreach_sub(grads, acc)
        torch._foreach_div_(delta, n + 1)
        torch._foreach_add_(acc, delta)
        if n == k - 1:
            self._hdn_step(acc)
            self.acc_count = 0
        else:
            self.acc_count = n + 1

    def _hdn_step(self, acc: list[torch.Tensor]) -> None:
        """Adam on the window's gradient, then the window emptied."""
        for p, a in zip(self.hdn_params, acc):
            p.grad = a.clone()
        for group in self.hdn_opt.param_groups:
            group["lr"] = lr_at(self.cfg, self.hdn_updates,
                                self.cfg.accumulation_steps)
        self.hdn_opt.step()
        self.hdn_updates += 1
        torch._foreach_zero_(acc)

    def reset_accumulation(self) -> None:
        """Open a new ACCUMULATION_QUIRK window (the original
        implementation's per-epoch reset); a no-op without the quirk."""
        if self.cfg.accumulation_quirk:
            torch._foreach_zero_(self.acc_grads)
            self.acc_loss.zero_()
            self.acc_count = 0

    # ------------------------------------------------------------------
    def state_dict(self) -> dict:
        """Everything a resumed run needs, as tensors and numbers."""
        return {"model": self.model.state_dict(),
                "hdn_opt": self.hdn_opt.state_dict(),
                "jln_opt": self.jln_opt.state_dict(),
                "step": self.step, "hdn_updates": self.hdn_updates,
                "jln_updates": self.jln_updates,
                "acc_grads": [a.detach().clone() for a in self.acc_grads],
                "acc_count": self.acc_count,
                "acc_loss": self.acc_loss.detach().clone()}

    def load_state_dict(self, state: Mapping) -> None:
        self.model.load_state_dict(state["model"])
        self.hdn_opt.load_state_dict(state["hdn_opt"])
        self.jln_opt.load_state_dict(state["jln_opt"])
        self.step = int(state["step"])
        self.hdn_updates = int(state["hdn_updates"])
        self.jln_updates = int(state["jln_updates"])
        if len(state["acc_grads"]) != len(self.acc_grads):
            raise ValueError("checkpoint's accumulation window has "
                             f"{len(state['acc_grads'])} tensors, the model "
                             f"{len(self.acc_grads)}")
        for a, b in zip(self.acc_grads, state["acc_grads"]):
            a.copy_(b)
        self.acc_count = int(state["acc_count"])
        self.acc_loss.copy_(state["acc_loss"])
