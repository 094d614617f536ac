"""The view-sharded eval step over a ('data', 'view') mesh (mesh.py).

The counterpart of the reference package's fvp_tpu/parallel/sharding.py
`make_sharded_eval_step`, which GSPMD partitions: here each rank runs its
part and the collectives are explicit. A rank of data row d and view
column v takes the batch block x[d-th B/n_data frames, v-th V/n_view
views] (`shard_batch`), and for its row:

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

The collectives run on the group's backend. A gloo group of CUDA ranks
(ranks sharing one card) gets host copies of its tensors, made here
explicitly and counted in `Mesh.staged_bytes`; NCCL groups take the
card's tensors as they are.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from fvp_torch.engine.serve import Engine, backbone_heatmaps, float32_math
from fvp_torch.geometry.grids import RigConstants
from fvp_torch.ops.kernels.sampler import whole_sample
from fvp_torch.ops.sampling import view_mean
from fvp_torch.parallel.mesh import Mesh


def shard_batch(mesh: Mesh, x):
    """This rank's block x[data block, view block] of a full batch x (B, V,
    ...), numpy or torch. Every process holds the full value and takes its
    block: the reference's `make_global` contract, with one process a
    rank."""
    n_data, n_view = mesh.shape
    B, V = x.shape[:2]
    if B % n_data or V % n_view:
        raise ValueError(f"batch (B, V) = {(B, V)} does not split over a "
                         f"{mesh.shape} mesh")
    d, v = mesh.coords
    b, w = B // n_data, V // n_view
    return x[d * b:(d + 1) * b, v * w:(v + 1) * w]


def _staged(t: torch.Tensor, group) -> bool:
    """Whether a collective of `group` takes `t` through host memory: a
    CUDA tensor in a gloo group."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _all_reduce_sum(mesh: Mesh, t: torch.Tensor, axis: str) -> torch.Tensor:
    """The sum of `t` over the ranks of this rank's `axis` group."""
    group = mesh.groups[axis]
    if not _staged(t, group):
        t = t.contiguous()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t
    host = t.cpu()
    dist.all_reduce(host, op=dist.ReduceOp.SUM, group=group)
    mesh.staged_bytes += 2 * host.nbytes
    return host.to(t.device)


def _all_gather(mesh: Mesh, t: torch.Tensor, dim: int,
                axis: str) -> torch.Tensor:
    """The ranks' `t` of this rank's `axis` group, concatenated along
    `dim` in the group's rank order."""
    group = mesh.groups[axis]
    n = len(mesh.axis_ranks(axis))
    src = t.cpu() if _staged(t, group) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    if src.device == t.device:
        return out
    mesh.staged_bytes += src.nbytes + out.nbytes
    return out.to(t.device)


def _broadcast(mesh: Mesh, t: torch.Tensor, axis: str) -> torch.Tensor:
    """The first rank's `t` of this rank's `axis` group, on every rank."""
    group = mesh.groups[axis]
    src = mesh.axis_ranks(axis)[0]
    if not _staged(t, group):
        t = t.contiguous()
        dist.broadcast(t, src, group=group)
        return t
    host = t.cpu()
    dist.broadcast(host, src, group=group)
    mesh.staged_bytes += 2 * host.nbytes
    return host.to(t.device)


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
        volumes = view_mean(_all_reduce_sum(mesh, part, "view"), V)
        det = model.propose(volumes, rc, engine.packed)
        proposals = _broadcast(mesh, det["proposals"], "view")
        heatmaps = _all_gather(mesh, hm, 1, "view")

        mine = proposals[:, k0:k0 + k_local]
        pad = k_local - mine.shape[1]
        if pad:
            # unmatched people (match index -1): zero planes, masked out
            fill = mine.new_zeros((mine.shape[0], pad, mine.shape[2]))
            fill[..., 3] = -1.0
            mine = torch.cat([mine, fill], dim=1)
        fused, _, scores = model.localize(heatmaps, rc, mine.contiguous(),
                                          engine.packed)
        fused = _all_gather(mesh, fused, 1, "view")[:, :K]
        scores = _all_gather(mesh, scores, 1, "view")[:, :K]
        return model.finish(proposals, fused, scores)

    return step
