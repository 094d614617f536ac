"""Spawned torch.distributed ranks for the port's sharding tests, on the
CPU over gloo: `run_ranks` starts one process a rank, collects one result
from each, and fails the test rather than hang on a rank that died or
stalled. The targets are module-level functions, so that they pickle
across the spawn; each pins torch to one intra-op thread (parallel test
workers would oversubscribe the cores)."""

from __future__ import annotations

import multiprocessing as mp
import queue
import time
import traceback

from fvp_torch.parallel.mesh import free_port


def run_ranks(target, world: int, args: tuple = (),
              timeout: float = 120.0) -> dict:
    """`target(rank, world, coordinator, *args)` in `world` spawned
    processes; returns {rank: result}. Raises with a rank's traceback if
    one failed, and kills every rank still running at `timeout`."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    coordinator = f"127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_rank_main,
                         args=(target, r, world, coordinator, args, q),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + timeout
    try:
        while len(results) < world and time.monotonic() < deadline:
            try:
                rank, res = q.get(timeout=1.0)
            except queue.Empty:
                continue
            if isinstance(res, _Failed):
                raise AssertionError(f"rank {rank} failed:\n{res.text}")
            results[rank] = res
    finally:
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join()
    if len(results) < world:
        raise AssertionError(f"{world - len(results)} of {world} ranks "
                             f"gave no result within {timeout} s")
    return results


class _Failed:
    def __init__(self, text: str):
        self.text = text


def _rank_main(target, rank, world, coordinator, args, q) -> None:
    import torch

    torch.set_num_threads(1)
    try:
        q.put((rank, target(rank, world, coordinator, *args)))
    except BaseException:
        q.put((rank, _Failed(traceback.format_exc())))
        raise


def eval_rank(rank, world, coordinator, shape, cfg, variables, rig, hm):
    """One rank of an (n_data, n_view) mesh: the sharded eval step on its
    block of `hm` with a CPU Predictor of the reference package's flax
    `variables`. Returns its output as numpy and its mesh coordinates."""
    import torch.distributed as dist

    from fvp_torch.engine.serve import Predictor
    from fvp_torch.parallel import (make_mesh, make_sharded_eval_step,
                                    shard_batch)
    from fvp_torch.parallel.mesh import init_distributed

    init_distributed(coordinator, world, rank, "cpu")
    try:
        mesh = make_mesh(*shape)
        pred = Predictor(cfg, variables, rig, device="cpu")
        out = make_sharded_eval_step(pred, mesh)(shard_batch(mesh, hm),
                                                 pred.rc)
        return {"coords": mesh.coords, "view": mesh.axis_ranks("view"),
                "data": mesh.axis_ranks("data"),
                **{k: v.numpy() for k, v in out.items()}}
    finally:
        dist.destroy_process_group()


def service_host(host, hosts, coordinator, svc_kw, frames):
    """One host of a multi-host service (its inference process, run in
    this rank's process on queued `frames`): returns the results that its
    leader emitted."""
    from fvp_torch.service import pipeline
    from fvp_torch.service.sources import SPAWN, FrameQueue

    svc = pipeline.ServiceConfig(coordinator=coordinator, num_hosts=hosts,
                                 host_id=host, max_frames=len(frames),
                                 **svc_kw)
    frame_q = FrameQueue(maxsize=len(frames))
    result_q = FrameQueue(maxsize=len(frames))
    for q in (frame_q, result_q):
        q.q.cancel_join_thread()       # a failure must not hang the exit
    for i, views in enumerate(frames):
        frame_q.put((float(i), views))
    stop = SPAWN.Value("i", 0)
    pipeline.inference_process(svc, frame_q, result_q, stop)
    return [result_q.get(timeout=10.0) for _ in frames]


def share_frame_rank(rank, world, coordinator, frames):
    """One rank of a host's gloo group: the leader (rank 0) shares each of
    `frames` (lists of views), then an idle tick, then the stop; returns
    what this rank received."""
    import torch.distributed as dist

    from fvp_torch.config import FVPConfig
    from fvp_torch.parallel.mesh import init_distributed
    from fvp_torch.service import pipeline

    init_distributed(coordinator, world, rank, "cpu")
    try:
        cfg = FVPConfig(num_views=max(len(f) for f in frames))
        host = dist.new_group(list(range(world)))
        got = []
        sends = [(pipeline._FRAME, f) for f in frames] + [
            (pipeline._IDLE, None), (pipeline._STOP, None)]
        for code, views in sends:
            got.append(pipeline._share_frame(
                cfg, host, 0, world, rank, code if rank == 0 else None,
                views if rank == 0 else None))
        return got
    finally:
        dist.destroy_process_group()


def leader_of_one_rank(q) -> None:
    """A stand-in for a service's sharded leader: starts one daemon rank
    as the service does, then waits to be killed."""
    ctx = mp.get_context("spawn")
    ctx.Process(target=rank_of_a_leader, args=(q,), daemon=True).start()
    time.sleep(600.0)


def rank_of_a_leader(q) -> None:
    """A spawned rank that arms the service's end-with-the-leader, reports
    its pid, and waits."""
    import os

    from fvp_torch.service.pipeline import _die_with_leader

    _die_with_leader()
    q.put(os.getpid())
    time.sleep(600.0)


def spatial_rank(rank, world, coordinator, inp):
    """One rank of a job that builds two meshes: a (1, world) 'space' mesh,
    on which it runs sharded_nms_topk_2d on its row block of each of
    inp['nms']'s maps and spatial_centernet on its rows of inp['bev'];
    and a (2, world / 2) pipeline mesh, on which it runs the spatially
    sharded eval step of a CPU Predictor of inp['variables'] on its
    'data' block of inp['heatmaps']. Returns the results as numpy."""
    import torch
    import torch.distributed as dist

    from fvp_torch.engine.serve import Predictor
    from fvp_torch.models.cnns import CenterNet
    from fvp_torch.parallel import (make_pipeline_mesh, make_spatial_eval_step,
                                    make_spatial_mesh, shard_data,
                                    sharded_nms_topk_2d, spatial_centernet)
    from fvp_torch.parallel.mesh import init_distributed

    init_distributed(coordinator, world, rank, "cpu")
    try:
        mesh = make_spatial_mesh(world)
        pipe = make_pipeline_mesh(2, world // 2)
        i = mesh.coords[1]
        out = {"space": mesh.axis_ranks("space"), "pipe": pipe.coords}
        for name, (hm, k) in inp["nms"].items():
            xl = hm.shape[1] // world
            got = sharded_nms_topk_2d(
                mesh, torch.from_numpy(hm[:, i * xl:(i + 1) * xl]), k)
            out[name] = tuple(t.numpy() for t in got)
        net = CenterNet(inp["bev"].shape[-1]).eval()
        net.load_state_dict(inp["centernet"])
        xl = inp["bev"].shape[1] // world
        with torch.inference_mode():
            got = spatial_centernet(
                net, torch.from_numpy(inp["bev"][:, i * xl:(i + 1) * xl]),
                mesh)
            out["centernet"] = tuple(t.numpy() for t in got)
            try:                          # 10 rows a block: not by 4
                spatial_centernet(net, torch.zeros(1, 10, 80, 15), mesh)
                out["raised"] = None
            except ValueError as e:
                out["raised"] = str(e)
        pred = Predictor(inp["cfg"], inp["variables"], inp["rig"],
                         device="cpu")
        step = make_spatial_eval_step(pred, pipe)
        res = step(shard_data(pipe, inp["heatmaps"]), pred.rc)
        out["pipeline"] = {k: v.numpy() for k, v in res.items()}
        return out
    finally:
        dist.destroy_process_group()


def train_rank(rank, world, coordinator, inp):
    """One rank of an (n_data, n_view) mesh: the distributed BatchNorms on
    its 'data' block of inp['bn']'s inputs (outputs, gradients, running
    stats), then the sharded train step of a CPU Trainer of
    inp['variables'] over inp['batches'] (per step its losses and the
    model's state dict after). Returns them as numpy."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from fvp_torch.engine.train import Trainer
    from fvp_torch.geometry.grids import build_rig_constants
    from fvp_torch.models.blocks import BatchNorm2d, data_parallel
    from fvp_torch.models.convert import from_jax_variables
    from fvp_torch.models.faster_voxelpose import FasterVoxelPose
    from fvp_torch.parallel import (make_mesh, make_sharded_train_step,
                                    shard_batch, shard_data)
    from fvp_torch.parallel.mesh import Axis, init_distributed

    def tensors(d):
        return {k: torch.as_tensor(np.asarray(v)) for k, v in d.items()}

    init_distributed(coordinator, world, rank, "cpu")
    try:
        mesh = make_mesh(*inp["shape"])
        out = {}
        for name, (x, g, mask) in inp["bn"].items():
            bn = BatchNorm2d(x.shape[1]).train()
            bn.load_state_dict(inp["bn_state"])
            xb = torch.tensor(shard_data(mesh, x), requires_grad=True)
            mb = None if mask is None else torch.as_tensor(
                shard_data(mesh, mask))
            with data_parallel(bn, Axis(mesh, "data")):
                y = bn(xb, mb)
            (y * torch.as_tensor(shard_data(mesh, g))).sum().backward()
            out[name] = {"y": y.detach().numpy(), "dx": xb.grad.numpy(),
                         "dw": bn.weight.grad.numpy(),
                         "db": bn.bias.grad.numpy(),
                         "mean": bn.running_mean.numpy(),
                         "var": bn.running_var.numpy()}
        cfg = inp["cfg"]
        model = FasterVoxelPose(cfg)
        model.load_state_dict(from_jax_variables(inp["variables"]))
        trainer = Trainer(cfg, model, "cpu")
        step = make_sharded_train_step(trainer, mesh)
        rc = build_rig_constants(cfg, inp["rig"]).to("cpu")
        out["steps"] = []
        for hm, targets, meta in inp["batches"]:
            losses = step(shard_batch(mesh, torch.as_tensor(hm)), rc,
                          tensors(shard_data(mesh, targets)),
                          tensors(shard_data(mesh, meta)))
            out["steps"].append({
                "losses": {k: float(v) for k, v in losses.items()},
                "state": {k: v.detach().clone().numpy()
                          for k, v in model.state_dict().items()}})
        return out
    finally:
        dist.destroy_process_group()
