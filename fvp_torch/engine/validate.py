"""Validation: the eval forward over a dataset, pose collection, the
dataset's evaluator and the FPS protocol (first batch excluded).

A copy of the reference package's `engine/validate.py` in PyTorch's idiom
(after the original implementation's run/validate.py:94-154 and
lib/core/function.py:126-183). Rig constants are explicit step inputs, so
eval batches are grouped by sequence (never crossing a rig boundary) and
each batch is paired with its sequence's RigConstants on the device;
partial batches are padded to the full batch size with the last index, so
every batch has one shape, and poses are scattered back into record order
for the evaluator.

It runs through the serving setup (engine/serve.py::Engine): the model
packed once for `cfg.compute_dtype`, on `cuda` unless the caller passes a
device, raising without a card, and its eval step computes float32
without TF32 (engine/serve.py::float32_math).
"""

from __future__ import annotations

import time
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from fvp_torch.config import FVPConfig
from fvp_torch.data.loader import build_samples, collate, prefetch
from fvp_torch.engine.serve import Engine, backbone_heatmaps, float32_math
from fvp_torch.geometry.grids import build_rig_constants
from fvp_torch.models.faster_voxelpose import FasterVoxelPose
from fvp_torch.models.resnet import PoseResNet
from fvp_torch.ops.heatmap_render import render_heatmaps_device

RENDER_KEYS = ("mu", "vis", "sigma", "scale", "occ")


def make_eval_step(cfg: FVPConfig, model: FasterVoxelPose, packed: dict,
                   backbone: PoseResNet | None = None,
                   backbone_packed: dict | None = None, mesh=None):
    """Returns step(batch_input, rc) -> fused poses (B, K, J, 5) on the
    input's device, under inference mode.

    batch_input is images (B, V, H, W, 3) when the TEST heatmap source is
    'image' (the backbone runs in the step), a render-params dict (the
    device splat, ops/heatmap_render.py) when cfg.device_render, else
    heatmaps (B, V, J, h, w). A backbone is ignored for the gt and pred
    sources: dispatch follows cfg.test_heatmap_src, not whether a backbone
    is loaded (a config may name one for training while it evaluates from
    rendered heatmaps).

    With `mesh` (a ('data', 'space') pipeline mesh of ranks,
    parallel/mesh.py::make_pipeline_mesh) every rank takes the whole
    batch input, runs the backbone or the splat on its 'data' block,
    replicated over 'space', and the spatially sharded forward
    (parallel/spatial.py); the blocks' poses are gathered over 'data', so
    every rank returns the whole batch's, in its order."""
    if cfg.test_heatmap_src != "image":
        backbone = None
    spatial = None
    if mesh is not None:
        from fvp_torch.parallel.sharding import shard_data
        from fvp_torch.parallel.spatial import make_spatial_forward
        spatial = make_spatial_forward(model, packed, mesh)

    @torch.inference_mode()
    @float32_math()
    def eval_step(batch_input, rc):
        if spatial is not None:
            batch_input = shard_data(mesh, batch_input)
        if backbone is not None:
            heatmaps = backbone_heatmaps(cfg, backbone, backbone_packed,
                                         batch_input)
        elif isinstance(batch_input, Mapping):
            heatmaps = render_heatmaps_device(
                cfg, *(batch_input[k] for k in RENDER_KEYS))
        else:
            heatmaps = batch_input
        if spatial is None:
            return model(heatmaps, rc, packed)["fused_poses"]
        poses = spatial(heatmaps.contiguous(), rc)["fused_poses"]
        return mesh.all_gather(poses, 0, "data")

    return eval_step


def eval_batches(dataset, batch_size: int):
    """Yield (seq, record_indices, valid_count) batches in record order,
    never crossing a sequence boundary; partial batches are right-padded by
    repeating the last index so every batch has one shape."""
    by_seq: dict[str, list[int]] = {}
    for i, rec in enumerate(dataset.records):
        by_seq.setdefault(rec["seq"], []).append(i)
    for seq, idxs in by_seq.items():
        for s in range(0, len(idxs), batch_size):
            chunk = idxs[s:s + batch_size]
            valid = len(chunk)
            if valid < batch_size:
                chunk = chunk + [chunk[-1]] * (batch_size - valid)
            yield seq, np.asarray(chunk), valid


def batch_input(batch: dict, device: torch.device):
    """The step's input of a collated batch, copied to `device`: the render
    parameters, else the heatmaps, else the images."""
    if "render_params" in batch:
        return {k: torch.as_tensor(v).to(device)
                for k, v in batch["render_params"].items()}
    x = batch["input_heatmaps"] if "input_heatmaps" in batch \
        else batch["images"]
    return torch.as_tensor(x, dtype=torch.float32).to(device)


def eval_rng(cfg: FVPConfig) -> np.random.RandomState:
    """The fixed eval RNG, the reference package's: when the dataset renders
    augmented heatmaps (the synthetic held-out protocol), every run sees the
    same inputs. Its draws are taken batch by batch in eval_batches'
    order."""
    return np.random.RandomState((cfg.seed + 20260817) % (2 ** 31))


def run_validation(cfg: FVPConfig, model: FasterVoxelPose, dataset,
                   rcs=None, backbone: PoseResNet | None = None,
                   batch_size: Optional[int] = None, device=None,
                   log: Callable[[str], None] = print, mesh=None) -> dict:
    """Run the eval loop; returns {'fused_poses': (len(dataset), K, J, 5)
    numpy in record order, 'fps' and 'batch_ms' (with more than one batch,
    the first excluded), 'metrics' (where the dataset has an evaluator)}.

    `rcs` is a mapping {seq: RigConstants} (host constants from
    geometry/grids.py::build_rig_constants, one per calibration of
    dataset.rigs), a single RigConstants for every batch, or None to build
    them from dataset.rigs. The model (and the backbone, for the image
    source) is packed once and moved to the device with its rig constants;
    each batch is copied to the device before its timer starts, and the
    step is timed between two synchronisations of the card.

    `mesh`: this rank's ('data', 'space') pipeline mesh
    (parallel/mesh.py::make_pipeline_mesh; `validate_on_mesh` spawns the
    ranks). Every rank loads the same batches (eval_rng), runs its 'data'
    block through the spatially sharded step and gets the whole batch's
    poses back, so each returns the same result."""
    bs = batch_size or cfg.test_batch_size
    if mesh is not None and bs % mesh.shape[0]:
        raise ValueError(f"batch of {bs} does not split over "
                         f"{mesh.shape[0]} 'data' ranks")
    if cfg.test_heatmap_src != "image":
        backbone = None
    engine = Engine(cfg, model, device, backbone)
    dev = engine.device
    if rcs is None:
        rcs = {seq: build_rig_constants(cfg, rig)
               for seq, rig in dataset.rigs.items()}
    elif not isinstance(rcs, Mapping):
        rcs = {rec["seq"]: rcs for rec in dataset.records}
    rcs = {seq: rc.to(dev) for seq, rc in rcs.items()}
    eval_step = make_eval_step(cfg, engine.model, engine.packed,
                               engine.backbone, engine.backbone_packed, mesh)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    all_poses = None
    times = []

    rng = eval_rng(cfg)

    def load(spec):
        seq, idx, valid = spec
        batch = collate(build_samples(dataset, idx, rng=rng))
        return seq, idx, valid, batch

    it = prefetch(map(load, eval_batches(dataset, bs)))
    for i, (seq, idx, valid, batch) in enumerate(it):
        x = batch_input(batch, dev)
        sync()
        t0 = time.perf_counter()
        poses = eval_step(x, rcs[seq])
        sync()
        dt = time.perf_counter() - t0
        times.append((dt, valid))
        poses = poses.cpu().numpy()
        if all_poses is None:
            all_poses = np.zeros((len(dataset),) + poses.shape[1:],
                                 poses.dtype)
        all_poses[idx[:valid]] = poses[:valid]
        if i % cfg.print_freq == 0:
            log(f"eval [{i}] seq {seq} batch {dt * 1000:.1f} ms "
                f"({valid / dt:.1f} samples/s)")

    result: dict = {"fused_poses": all_poses}

    if len(times) > 1:   # exclude the first batch (warm-up)
        steady = [t for t, _ in times[1:]]
        result["fps"] = sum(n for _, n in times[1:]) / sum(steady)
        result["batch_ms"] = {"mean": 1000 * float(np.mean(steady)),
                              "min": 1000 * float(np.min(steady)),
                              "max": 1000 * float(np.max(steady))}

    if getattr(dataset, "has_evaluate_function", False):
        result["metrics"] = dataset.evaluate(all_poses)
    return result


def validate_on_mesh(cfg: FVPConfig, model_state: Mapping, dataset_name: str,
                     shape: tuple[int, int], device, backbone_state=None,
                     log: Callable[[str], None] = print) -> dict:
    """`run_validation` over an (n_data, n_space) pipeline mesh of ranks on
    this host: this process is rank 0 and spawns the others, each of which
    builds the dataset `dataset_name` (test split), the model from
    `model_state` (and the backbone from `backbone_state`, for the image
    source) and runs its block. CUDA ranks share the card over gloo (their
    tensors staged through host memory). Returns rank 0's result; only
    rank 0 logs."""
    import multiprocessing as mp

    from fvp_torch.parallel.mesh import free_port

    world = shape[0] * shape[1]
    coordinator = f"127.0.0.1:{free_port()}"
    args = (world, coordinator, cfg, model_state, dataset_name, shape,
            str(device), backbone_state)
    ctx = mp.get_context("spawn")
    ranks = [ctx.Process(target=_mesh_rank, args=(r, *args), daemon=True)
             for r in range(1, world)]
    for p in ranks:
        p.start()
    try:
        res = _mesh_rank(0, *args, log=log)
    finally:
        for p in ranks:
            p.join(timeout=60.0)
            if p.is_alive():
                p.kill()
    if any(p.exitcode for p in ranks):
        raise RuntimeError(f"validate ranks exited with "
                           f"{[p.exitcode for p in ranks]}")
    return res


def _mesh_rank(rank, world, coordinator, cfg, model_state, dataset_name,
               shape, device, backbone_state, log=lambda s: None) -> dict:
    """One rank of `validate_on_mesh`."""
    import torch.distributed as dist

    from fvp_torch.data.registry import build_dataset
    from fvp_torch.parallel.mesh import init_distributed, make_pipeline_mesh

    if device == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    backend = init_distributed(coordinator, world, rank, device, world)
    try:
        mesh = make_pipeline_mesh(*shape)
        log(f"pipeline mesh: {shape[0]} data x {shape[1]} space over "
            f"{world} ranks ({backend}, {device})")
        dataset = build_dataset(dataset_name, cfg, is_train=False)
        log(f"test: {len(dataset)} frames on {device}")
        model = FasterVoxelPose(cfg)
        model.load_state_dict(model_state)
        backbone = None
        if backbone_state is not None:
            backbone = PoseResNet(cfg.num_joints, cfg.resnet_layers)
            backbone.load_state_dict(backbone_state)
        return run_validation(cfg, model, dataset, backbone=backbone,
                              device=device, log=log, mesh=mesh)
    finally:
        dist.destroy_process_group()
