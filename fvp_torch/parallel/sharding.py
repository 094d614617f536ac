"""Sharded steps over a ('data', 'view') mesh (mesh.py): the view-sharded
eval step and the data-parallel train step.

The counterparts of the reference package's fvp_tpu/parallel/sharding.py
`make_sharded_eval_step` and `make_sharded_train_step`, which GSPMD
partitions: here each rank runs its part and the collectives are
explicit (mesh.py::Mesh). A rank of data row d and view column v takes
the batch block x[d-th B/n_data frames, v-th V/n_view views]
(`shard_batch`), and for its row the eval step:

1. runs the backbone on its views' images (or takes its heatmaps);
2. samples its views into the whole-space volume in K1's sum mode;
3. all-reduces the view sums over 'view' and takes the mean and clamp
   (ops/sampling.py::view_mean): the psum that replaces the view mean;
4. runs the HDN whole, as GSPMD leaves the tail replicated after the
   psum; the row's first rank broadcasts its proposals, so that every
   rank splits the same people;
5. all-gathers the heatmaps over 'view' to every view;
6. runs the JLN on its block of ceil(K / n_view) people, padded with
   unmatched ones (the reference's `jln_mesh` split of the person axis),
   and all-gathers the fused poses and JLN scores over 'view';
7. applies the forward's masking and scoring tail.

The numbers are the unsharded forward's, up to the order of the view sum
(a rank sums its views, the group sums the ranks) and the per-person nets
run on fewer people at a time; a view group of one is bit for bit the
unsharded forward.

The train step does 1-3 and 5 in train mode, runs the HDN and the JLN
whole on every view rank, and reduces over 'data' what the reference's
one global program computes over the global batch: CenterNet's and
C2CNet's BatchNorm statistics (models/blocks.py::data_parallel), the
masked BatchNorms' running update in global group order, the losses'
denominators (models/faster_voxelpose.py::compute_losses) and the
gradients (engine/train.py::Trainer.update). A data axis of one is the
single-device step, and a (1, 1) mesh bit for bit `Trainer.train_step`.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from fvp_torch.engine.serve import Engine, backbone_heatmaps, float32_math
from fvp_torch.engine.train import Trainer
from fvp_torch.geometry.grids import RigConstants
from fvp_torch.models.blocks import data_parallel
from fvp_torch.ops.kernels.sampler import whole_sample
from fvp_torch.ops.sampling import view_mean
from fvp_torch.parallel.mesh import Axis, Mesh


def shard_batch(mesh: Mesh, x):
    """This rank's block x[data block, view block] of a full batch x (B, V,
    ...), numpy or torch, or of each value of a mapping of such (render
    parameters). Every process holds the full value and takes its block:
    the reference's `make_global` contract, with one process a rank."""
    if isinstance(x, Mapping):
        return {k: shard_batch(mesh, v) for k, v in x.items()}
    n_data, n_view = mesh.shape
    B, V = x.shape[:2]
    if B % n_data or V % n_view:
        raise ValueError(f"batch (B, V) = {(B, V)} does not split over a "
                         f"{mesh.shape} mesh")
    d, v = mesh.coords
    b, w = B // n_data, V // n_view
    return x[d * b:(d + 1) * b, v * w:(v + 1) * w]


def shard_data(mesh: Mesh, x):
    """This rank's 'data' block x[d-th B/n_data] of a full batch x (B, ...)
    or of each value of a mapping of such (targets, meta, render
    parameters), whole along every other axis."""
    if isinstance(x, Mapping):
        return {k: shard_data(mesh, v) for k, v in x.items()}
    n_data = mesh.shape[0]
    B = x.shape[0]
    if B % n_data:
        raise ValueError(f"batch of {B} does not split over {n_data} "
                         "'data' ranks")
    b, d = B // n_data, mesh.coords[0]
    return x[d * b:(d + 1) * b]


def make_sharded_eval_step(engine: Engine, mesh: Mesh):
    """`step(block, rc)` on this rank of `mesh`: `block` is its
    `shard_batch` block of a frame batch, heatmaps (B, V, J, h, w) or,
    where `engine` holds a backbone, normalized images (B, V, H, W, 3);
    `rc` the engine's rig constants of all V views. Returns, as
    `Predictor` does, {'fused_poses' (B_local, K, J, 5), 'proposals'
    (B_local, K, 7), 'mask' (B_local, K)}, the same on every rank of the
    view group. Every rank of the mesh builds `engine` from the same
    weights."""
    if not mesh.active:
        raise ValueError(f"rank {mesh.rank} is idle on a {mesh.shape} mesh")
    cfg, model = engine.cfg, engine.model
    V, K = cfg.num_views, cfg.max_people
    n_view = mesh.shape[1]
    if V % n_view:
        raise ValueError(f"{V} views do not split over {n_view} ranks")
    v = mesh.coords[1]
    n_local = V // n_view
    v0 = v * n_local
    k_local = -(-K // n_view)                    # people a rank, padded
    k0 = v * k_local

    @torch.inference_mode()
    @float32_math()
    def step(block, rc: RigConstants) -> dict[str, torch.Tensor]:
        x = torch.as_tensor(block, dtype=torch.float32, device=engine.device)
        if x.shape[1] != n_local:
            raise ValueError(f"block of {x.shape[1]} views; rank {mesh.rank}"
                             f" holds {n_local} of {V}")
        if engine.backbone is not None:
            hm = backbone_heatmaps(cfg, engine.backbone,
                                   engine.backbone_packed, x)
        else:
            hm = x.contiguous()
        rc_views = dataclasses.replace(
            rc, whole_sample_px=rc.whole_sample_px[v0:v0 + n_local])
        part = whole_sample(hm, rc_views, cfg, view_sum=True)
        volumes = view_mean(mesh.all_reduce_sum(part, "view"), V)
        det = model.propose(volumes, rc, engine.packed)
        proposals = mesh.broadcast(det["proposals"], "view")
        heatmaps = mesh.all_gather(hm, 1, "view")

        mine = proposals[:, k0:k0 + k_local]
        pad = k_local - mine.shape[1]
        if pad:
            # unmatched people (match index -1): zero planes, masked out
            fill = mine.new_zeros((mine.shape[0], pad, mine.shape[2]))
            fill[..., 3] = -1.0
            mine = torch.cat([mine, fill], dim=1)
        fused, _, scores = model.localize(heatmaps, rc, mine.contiguous(),
                                          engine.packed)
        fused = mesh.all_gather(fused, 1, "view")[:, :K]
        scores = mesh.all_gather(scores, 1, "view")[:, :K]
        return model.finish(proposals, fused, scores)

    return step


def make_sharded_train_step(trainer: Trainer, mesh: Mesh):
    """`step(block, rc, targets, meta)` on this rank of a ('data', 'view')
    mesh: `block` is its `shard_batch` block of a train batch (heatmaps
    (B, V, J, h, w), render parameters or, where `trainer` holds a frozen
    backbone, normalized images (B, V, H, W, 3)); `targets` and `meta`
    its `shard_data` blocks, as tensors on the trainer's device; `rc` the
    rig constants of all V views. One train step of every rank's
    `trainer` on the global batch; returns the global batch's losses
    (LOSS_KEYS), the same on every rank. Every rank builds `trainer` from
    the same weights and takes the same updates."""
    if not mesh.active:
        raise ValueError(f"rank {mesh.rank} is idle on a {mesh.shape} mesh")
    if mesh.axis_names != ("data", "view"):
        raise ValueError(f"a {mesh.axis_names} mesh; the train step shards "
                         "('data', 'view')")
    cfg, model = trainer.cfg, trainer.model
    V = cfg.num_views
    n_data, n_view = mesh.shape
    if V % n_view:
        raise ValueError(f"{V} views do not split over {n_view} ranks")
    n_local = V // n_view
    v0 = mesh.coords[1] * n_local
    data = Axis(mesh, "data") if n_data > 1 else None

    def step(block, rc: RigConstants, targets, meta) -> dict:
        with float32_math(), data_parallel(model, data):
            hm = trainer.heatmaps(block).contiguous()
            if hm.shape[1] != n_local:
                raise ValueError(f"block of {hm.shape[1]} views; rank "
                                 f"{mesh.rank} holds {n_local} of {V}")
            rc_views = dataclasses.replace(
                rc, whole_sample_px=rc.whole_sample_px[v0:v0 + n_local])
            part = whole_sample(hm, rc_views, cfg, view_sum=True)
            volumes = view_mean(mesh.all_reduce_sum(part, "view"), V)
            det = model.propose(volumes, rc, None, True, meta)
            heatmaps = mesh.all_gather(hm, 1, "view")
            out = model.complete(det, heatmaps, rc, None, True)
            return trainer.update(out, targets, meta, data)

    return step
