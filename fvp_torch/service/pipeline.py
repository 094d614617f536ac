"""Real-time streaming service: capture -> inference -> visualization as a
multi-process pipeline with bounded drop-oldest queues and a liveness
watchdog.

The reference package's `service/pipeline.py` with the port's predictor:
four OS processes (frame source, inference, visualization and the main
loop), queue sizes 1 (frames) and 5 (results) with drop-oldest
backpressure, a watchdog in the main loop over all children, and a
graceful shutdown through a shared stop flag. Every process is spawned
(sources.py), so the inference process initialises CUDA itself.

Inference: the cameras come from a calibration file, or else the
deterministic ring of geometry/cameras.py::default_ring_rig. With a
backbone (cfg.pretrained_backbone) the raw frames are normalised on the
host and go through the frozen Pose-ResNet and the 3D pipeline in one
`Predictor` call (engine/serve.py) in cfg.compute_dtype; without one,
frames are down-converted to heatmap stand-ins so the topology stays
drivable with no weights. The predictor runs on `svc.device`: 'cuda'
unless the caller says 'cpu', and without a card it raises.

Visualization: the viz process composes the views, reprojects the fused
poses onto every camera quadrant, and calls the callback, saves JPEGs, or
pipes the overlay into an ffmpeg RTSP restream (render.py).

Multi-device and multi-host serving (the reference's view sharding and
its `coordinator`, `num_hosts` and `host_id`): where `pick_view_shards`
gives a view axis of more than one rank, or a coordinator is given, the
inference process leads this host's ranks of a ('data', 'view') = (1,
n_view) mesh (fvp_torch/parallel/), one process a rank: it starts the
host's other ranks from the spawn context, reads the frames and
broadcasts the raw uint8 frames to them; each rank prepares only its own
views, and all run the view-sharded step (`make_sharded_eval_step`) on
the same weights (the checkpoint, or the same seeded init); only the
leader emits results. The local devices are the host's cards, or on the
CPU the count in FVP_CPU_DEVICES (the reference's switch for its virtual
CPU devices); one host runs n_view ranks, a job of `num_hosts` hosts
`num_hosts` x its local devices, of which ranks past n_view idle. Across
hosts, every host's ranks take their views from that host's own frames,
as in the reference. Every host takes `max_frames` steps, so all stop
after the same number of collectives; a host that dies fails the others'
next collective after parallel/mesh.py's TIMEOUT, and their watchdogs
then see the inference process die. A leader's ranks end with it,
however it ends. Unsharded, the inference process serves through the
same loop alone.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import tempfile
import time
from typing import Callable, Optional

import numpy as np

from fvp_torch.service.sources import (SPAWN, FrameQueue, RTSPSource,
                                       SyntheticSource)


@dataclasses.dataclass
class ServiceConfig:
    cfg_path: str = ""                   # experiment YAML
    rtsp_url: str = ""                   # empty -> synthetic source
    checkpoint: str = ""                 # .pth/.tar, else flax msgpack
    calibration: str = ""                # custom-format calibration.json
    num_views: int = 4
    result_queue_size: int = 5
    target_fps: float = 30.0
    max_frames: Optional[int] = None     # None = run until stopped
    view_mode: str = "callback"          # callback | save | rtsp | none
    output_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(),
                                             "fvp_service"))
    restream_url: str = ""               # rtsp:// target for view_mode=rtsp
    on_result: Optional[Callable] = None  # called in the viz process
    cfg_obj: Optional[object] = None     # FVPConfig override (tests/embedding)
    # multi-host: one service per host, the same coordinator (rank 0's
    # host:port) on each, the view axis sharded over all hosts' ranks
    coordinator: str = ""                # empty = this host alone
    num_hosts: int = 1
    host_id: int = 0
    device: str = "cuda"                 # 'cpu' for the plain path


def _load_cfg(svc: ServiceConfig):
    """Experiment config with the camera count reconciled: the frame
    source, model and visualization must all agree on one view count, so
    the service flag wins over the YAML's CAMERA_NUM (a silently
    zero-filled missing view would corrupt the fused poses)."""
    from fvp_torch.config import FVPConfig, load_config
    if svc.cfg_obj is not None:
        cfg = svc.cfg_obj
    elif not svc.cfg_path:
        return FVPConfig(num_views=svc.num_views)
    else:
        cfg = load_config(svc.cfg_path)
    if svc.num_views and svc.num_views != cfg.num_views:
        print(f"service: overriding CAMERA_NUM {cfg.num_views} -> "
              f"{svc.num_views} (frame source)", flush=True)
        cfg = cfg.replace(num_views=svc.num_views)
    return cfg


def _service_rig(svc: ServiceConfig, cfg):
    """Camera setup: the calibration file when one is given, else the
    deterministic demo ring."""
    if svc.calibration:
        from fvp_torch.data.custom import load_custom_calibration
        rig = load_custom_calibration(svc.calibration)
        if rig.num_cameras != cfg.num_views:
            raise ValueError(
                f"calibration has {rig.num_cameras} cameras, config "
                f"expects {cfg.num_views}")
        return rig
    from fvp_torch.geometry.cameras import default_ring_rig
    return default_ring_rig(cfg.num_views, cfg.space_center,
                            cfg.ori_image_size)


def pick_view_shards(n_devices: int, num_views: int) -> int:
    """Largest divisor of the camera count that fits the device count: a
    single frame (batch 1) scales over the view axis only, so serving
    shards cameras and leaves any leftover devices idle rather than
    splitting a view across devices."""
    return next(v for v in range(min(n_devices, num_views), 0, -1)
                if num_views % v == 0)


def inference_process(svc: ServiceConfig, frame_q: FrameQueue,
                      result_q: FrameQueue, stop_flag) -> None:
    """Model owner: consume frames, run the predictor, emit poses.

    The model comes from `svc.checkpoint` (engine/checkpoint.py::
    load_model_state: a torch file or the reference's model_best.msgpack),
    or from the reference package's default init seeded with 0 when there
    is none; the backbone from cfg.pretrained_backbone the same way. The
    port's backbone takes the images as they are whatever
    cfg.backbone_stem says, so there is no host space-to-depth branch
    (the reference's 'host_s2d' is a TPU input contract). Where the views
    shard over ranks or a coordinator is given, this process leads the
    host's ranks (`_serve_sharded`); else it serves alone through the same
    loop (`_serve_rank`)."""
    from fvp_torch.engine.serve import resolve_device

    device = resolve_device(None if svc.device == "cuda" else svc.device)
    cfg = _load_cfg(svc)
    n_dev = _local_devices(device)
    hosts = svc.num_hosts if svc.coordinator else 1
    n_view = pick_view_shards(hosts * n_dev, cfg.num_views)
    if svc.coordinator or n_view > 1:
        _serve_sharded(svc, cfg, device, n_dev, n_view, frame_q, result_q,
                       stop_flag)
    else:
        _serve_rank(svc, cfg, None, 1, 0, 1, 1, device, frame_q, result_q,
                    stop_flag)


def _local_devices(device) -> int:
    """The devices of this host a view shard can take: its cards, or on
    the CPU FVP_CPU_DEVICES (default 1)."""
    import torch

    if device.type == "cuda":
        return torch.cuda.device_count()
    return int(os.environ.get("FVP_CPU_DEVICES", "1"))


def _predictor(svc: ServiceConfig, cfg, device):
    """The service's Predictor on `device`: every rank builds it from the
    same weights."""
    import torch

    from fvp_torch.engine.checkpoint import (load_backbone_state,
                                             load_model_state)
    from fvp_torch.engine.init import flax_init
    from fvp_torch.engine.serve import Predictor
    from fvp_torch.models.faster_voxelpose import FasterVoxelPose

    if svc.checkpoint:
        state = load_model_state(svc.checkpoint)
    else:
        model = FasterVoxelPose(cfg)
        flax_init(model, torch.Generator().manual_seed(0))
        state = model.state_dict()
    backbone_state = load_backbone_state(cfg.pretrained_backbone) \
        if cfg.pretrained_backbone else None
    return Predictor.from_state_dict(
        cfg, state, _service_rig(svc, cfg), device=device,
        backbone_state_dict=backbone_state)


def _prepare(cfg, predictor, views, lo: int = 0, hi: Optional[int] = None):
    """Raw frames -> the predictor's input for views lo..hi: images with a
    backbone, heatmap stand-ins without."""
    if predictor.backbone is not None:
        return _frames_to_images(cfg, views, lo, hi)
    return _frames_to_heatmaps(cfg, views, lo, hi)


def _emit(svc, cfg, result_q, ts, views, poses, dt, fps_win) -> None:
    """Put one frame's result on the result queue."""
    fps_win[:] = (fps_win + [dt])[-30:]
    result = {
        "timestamp": ts,
        "poses": poses[0],
        "latency_ms": dt * 1000,
        "fps": len(fps_win) / sum(fps_win),
    }
    if svc.view_mode in ("save", "rtsp"):
        # the rendered composite needs the frames; callback/none
        # modes skip serializing ~MBs of pixels through the queue
        result["views"] = [v[::2, ::2] for v in views[:cfg.num_views]]
    result_q.put(result)


# what a leader broadcasts to its host's ranks before each step
_FRAME, _IDLE, _STOP = 0, 1, 2


def _serve_sharded(svc, cfg, device, n_dev, n_view, frame_q, result_q,
                   stop_flag) -> None:
    """Lead this host's ranks of the view-sharded service: start the other
    local ranks, then serve as the host's first rank."""
    from fvp_torch.parallel.mesh import free_port

    if svc.coordinator:
        coordinator, local = svc.coordinator, n_dev
        first = svc.host_id * local
        world = svc.num_hosts * local
    else:
        coordinator, local = f"127.0.0.1:{free_port()}", n_view
        first, world = 0, n_view
    print(f"service: sharding inference over {n_view} of {world} ranks "
          f"(view axis); host {svc.host_id} of {max(svc.num_hosts, 1)} runs "
          f"ranks {first}..{first + local - 1}", flush=True)
    ranks = [SPAWN.Process(target=_serve_rank,
                           args=(svc, cfg, coordinator, world, first + i,
                                 local, n_view, _rank_device(device, i)),
                           daemon=True)
             for i in range(1, local)]
    for p in ranks:
        p.start()
    try:
        _serve_rank(svc, cfg, coordinator, world, first, local, n_view,
                    _rank_device(device, 0), frame_q, result_q, stop_flag)
    finally:
        for p in ranks:
            p.join(timeout=10.0)
            if p.is_alive():
                p.kill()


def _rank_device(device, local_index: int):
    """A local rank's device: its own card, or the CPU."""
    import torch

    if device.type == "cuda":
        return torch.device("cuda", local_index)
    return device


def _die_with_leader() -> None:
    """End this spawned rank when its leader ends, however the leader
    ended: a SIGTERM or SIGKILL to the leader skips its `finally`, which
    would otherwise leave the rank holding its device (Linux's
    PR_SET_PDEATHSIG)."""
    import ctypes
    import multiprocessing
    import signal
    import sys

    if not sys.platform.startswith("linux"):
        return
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(1, int(signal.SIGKILL)) != 0:     # PR_SET_PDEATHSIG
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_PDEATHSIG)")
    if os.getppid() != multiprocessing.parent_process().pid:
        os._exit(1)                          # the leader ended already


def _serve_rank(svc, cfg, coordinator, world, rank, local, n_view, device,
                frame_q=None, result_q=None, stop_flag=None) -> None:
    """The serving loop, unsharded or as one rank of the sharded service.
    Without a coordinator the process serves alone: the predictor takes
    the whole frame. With one, it joins the job; the host's first rank
    (the leader, which holds the queues) reads each frame and broadcasts
    it to the host's ranks over a gloo group of the host, every active
    rank prepares its own views and takes the sharded step. The leader
    emits each result and, after max_frames or when the stop flag rises,
    stops (and broadcasts the stop)."""
    import torch.distributed as dist

    from fvp_torch.parallel.mesh import init_distributed, make_mesh
    from fvp_torch.parallel.sharding import make_sharded_eval_step

    if coordinator and rank % local:
        _die_with_leader()
    try:
        host, leader, lo, per = None, rank, 0, cfg.num_views
        if coordinator:
            backend = init_distributed(coordinator, world, rank, device,
                                       local)
            mesh = make_mesh(1, n_view)
            hosts = [dist.new_group(list(range(h, h + local)),
                                    backend="gloo")
                     for h in range(0, world, local)]
            host, leader = hosts[rank // local], rank // local * local
            if rank == leader:
                print(f"service: rank {rank} of {world} joined ({backend})",
                      flush=True)
            per = cfg.num_views // n_view
            lo = mesh.coords[1] * per if mesh.active else 0
        predictor = _predictor(svc, cfg, device)
        if not coordinator:
            step = lambda x, rc: predictor(x)  # noqa: E731
        elif mesh.active:
            step = make_sharded_eval_step(predictor, mesh)
        else:
            step = None
        n_done = 0
        fps_win: list[float] = []
        while True:
            code, item = _IDLE, None              # the leader's to decide
            if rank == leader and stop_flag.value:
                code = _STOP
            elif rank == leader:
                try:
                    item = frame_q.get(timeout=0.5)
                    code = _FRAME
                except queue.Empty:
                    pass
            t0 = time.perf_counter()
            code, views = _share_frame(cfg, host, leader, local, rank, code,
                                       item[1] if item else None)
            if code == _STOP:
                break
            if code == _IDLE:
                continue
            out = step(_prepare(cfg, predictor, views, lo, lo + per),
                       predictor.rc) if step is not None else None
            if rank == leader:
                if out is not None:
                    _emit(svc, cfg, result_q, item[0], views,
                          out["fused_poses"].cpu().numpy(),
                          time.perf_counter() - t0, fps_win)
                n_done += 1
                if svc.max_frames and n_done >= svc.max_frames:
                    stop_flag.value = 1
    finally:
        if coordinator and dist.is_initialized():
            dist.destroy_process_group()


def _share_frame(cfg, host, leader, local, rank, code, views):
    """The leader's (code, raw views) on every rank of the host: a header
    (code, view count, each view's shape) and the views' bytes, broadcast
    over the host's gloo group. A host of one rank shares nothing."""
    import torch
    import torch.distributed as dist

    if local == 1:
        return code, views
    V = cfg.num_views
    header = torch.zeros(2 + 3 * V, dtype=torch.int64)
    if rank == leader:
        views = [np.ascontiguousarray(v) for v in (views or [])[:V]]
        header[0], header[1] = code, len(views)
        for i, v in enumerate(views):
            header[2 + 3 * i:5 + 3 * i] = torch.tensor(
                [v.shape[0], v.shape[1], v.shape[2] if v.ndim == 3 else 0])
    dist.broadcast(header, leader, group=host)
    code, n = int(header[0]), int(header[1])
    if code != _FRAME:
        return code, None
    shapes = [tuple(int(s) for s in header[2 + 3 * i:5 + 3 * i] if s)
              for i in range(n)]
    sizes = [int(np.prod(s)) for s in shapes]
    if rank == leader:
        flat = torch.from_numpy(np.concatenate([v.ravel() for v in views]))
    else:
        flat = torch.empty(sum(sizes), dtype=torch.uint8)
    dist.broadcast(flat, leader, group=host)
    if rank == leader:
        return code, views
    parts = torch.split(flat, sizes)
    return code, [p.numpy().reshape(s) for p, s in zip(parts, shapes)]


def _frames_to_images(cfg, views, lo: int = 0,
                      hi: Optional[int] = None) -> np.ndarray:
    """Raw BGR frames -> (1, V, H, W, 3) normalized RGB batch at the
    working resolution; views lo..hi only (default all V) where a rank
    holds those."""
    import cv2

    from fvp_torch.data.images import IMAGENET_MEAN, IMAGENET_STD

    hi = cfg.num_views if hi is None else hi
    w, h = cfg.image_size
    out = np.zeros((1, hi - lo, h, w, 3), np.float32)
    for v, img in enumerate(views[lo:min(hi, cfg.num_views)]):
        if img.ndim == 2:
            img = img[..., None].repeat(3, axis=2)
        if img.shape[0] != h or img.shape[1] != w:
            img = cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
        rgb = cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
        out[0, v] = (rgb - IMAGENET_MEAN) / IMAGENET_STD
    return out


def _frames_to_heatmaps(cfg, views, lo: int = 0,
                        hi: Optional[int] = None) -> np.ndarray:
    """Demo fallback (no backbone weights): down-convert raw views into
    per-joint heatmap stand-ins so the full topology runs end to end;
    views lo..hi only (default all V)."""
    import cv2

    hi = cfg.num_views if hi is None else hi
    hm_w, hm_h = cfg.heatmap_size
    out = np.zeros((1, hi - lo, cfg.num_joints, hm_h, hm_w), np.float32)
    for v, img in enumerate(views[lo:min(hi, cfg.num_views)]):
        g = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) if img.ndim == 3 else img
        g = cv2.resize(g, (hm_w, hm_h)).astype(np.float32) / 255.0
        out[0, v, :] = g[None]
    return out


def visualization_process(svc: ServiceConfig, result_q: FrameQueue,
                          stop_flag) -> None:
    """Render loop at the target rate, reusing the last result when no new
    one arrived; overlays reprojected poses and dispatches per view_mode
    (callback / save / rtsp). Once the stop flag is up it still draws the
    results left in the queue, then returns: the reference's loop returns
    at once, so a max_frames run whose inference outpaced this process's
    start drew nothing."""
    from fvp_torch.geometry.transforms import get_resize_transform
    from fvp_torch.service.render import (
        FFmpegRestream, compose_views, render_result_on_image,
    )

    cfg = _load_cfg(svc)
    rig = _service_rig(svc, cfg)
    resize_t = get_resize_transform(cfg.ori_image_size, cfg.image_size)
    writer = None
    if svc.view_mode == "rtsp" and svc.restream_url:
        rows = max(2, (cfg.num_views + 1) // 2)
        writer = FFmpegRestream(
            svc.restream_url,
            (cfg.image_size[0], cfg.image_size[1] // 2 * rows),
            fps=svc.target_fps)
    if svc.view_mode == "save":
        os.makedirs(svc.output_dir, exist_ok=True)

    period = 1.0 / svc.target_fps
    last = None
    while True:
        stopping = bool(stop_flag.value)
        t0 = time.perf_counter()
        try:
            last = result_q.get(timeout=period)
            fresh = True
        except queue.Empty:
            if stopping:
                break
            fresh = False
        if last is not None:
            if svc.view_mode in ("save", "rtsp"):
                import cv2

                if fresh or svc.view_mode == "rtsp":
                    # rtsp re-pushes the last composite to hold the
                    # stream's frame rate; save mode writes each result
                    # once
                    img = compose_views(last["views"], cfg.image_size)
                    img = render_result_on_image(
                        cfg, rig, resize_t, img, last["poses"],
                        fps=last["fps"], latency_ms=last["latency_ms"])
                    if svc.view_mode == "save":
                        cv2.imwrite(os.path.join(
                            svc.output_dir,
                            f"pose_{int(last['timestamp'] * 1000)}.jpg"),
                            img)
                    elif writer is not None:
                        writer.write(img)
            if svc.on_result is not None and fresh:
                svc.on_result(last)
        dt = time.perf_counter() - t0
        if dt < period:
            time.sleep(period - dt)
    if writer is not None:
        writer.close()


def run_service(svc: ServiceConfig) -> Optional[str]:
    """Main: wire sources + processes, watchdog, graceful shutdown.
    Returns the name of the child whose death stopped the service, or
    None when it stopped on max_frames or an interrupt."""
    stop_flag = SPAWN.Value("i", 0)
    frame_q = FrameQueue(maxsize=1)
    result_q = FrameQueue(maxsize=svc.result_queue_size)

    if svc.rtsp_url:
        source = RTSPSource(svc.rtsp_url, frame_q, stop_flag, split=True)
    else:
        source = SyntheticSource(frame_q, stop_flag,
                                 num_views=svc.num_views)
    source.start()

    # not a daemon: a sharded service's inference process starts its
    # host's other ranks, which end with it in any case
    infer = SPAWN.Process(target=inference_process,
                          args=(svc, frame_q, result_q, stop_flag))
    infer.start()
    viz = SPAWN.Process(target=visualization_process,
                        args=(svc, result_q, stop_flag), daemon=True)
    viz.start()

    children = {"source": source.proc, "inference": infer, "viz": viz}
    died = None
    try:
        while not stop_flag.value:
            time.sleep(0.5)
            # watchdog over all children
            for name, proc in children.items():
                if (proc is not None and not proc.is_alive()
                        and not stop_flag.value):
                    print(f"service: {name} process died; stopping",
                          flush=True)
                    died = name
                    stop_flag.value = 1
                    break
    except KeyboardInterrupt:
        pass
    finally:
        stop_flag.value = 1
        # the inference process's time covers a sharded leader's stop
        # broadcast and the joins of its ranks
        for p, wait in ((infer, 15.0), (viz, 3.0)):
            p.join(timeout=wait)
            if p.is_alive():
                p.terminate()
        source.stop()
    return died
