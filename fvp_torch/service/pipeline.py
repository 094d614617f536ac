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

Not ported: multi-device and multi-host serving (the reference's
`coordinator`, `num_hosts` and `host_id`, and a view sharding over
several devices); `run_service` raises for a coordinator, and the
inference process serves on one device whatever `pick_view_shards` would
give.
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
    coordinator: str = ""                # multi-host: not ported, raises
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
    (the reference's 'host_s2d' is a TPU input contract)."""
    import torch

    from fvp_torch.engine.checkpoint import (load_backbone_state,
                                             load_model_state)
    from fvp_torch.engine.init import flax_init
    from fvp_torch.engine.serve import Predictor, resolve_device
    from fvp_torch.models.faster_voxelpose import FasterVoxelPose

    device = resolve_device(None if svc.device == "cuda" else svc.device)
    cfg = _load_cfg(svc)
    rig = _service_rig(svc, cfg)
    if svc.checkpoint:
        state = load_model_state(svc.checkpoint)
    else:
        model = FasterVoxelPose(cfg)
        flax_init(model, torch.Generator().manual_seed(0))
        state = model.state_dict()
    backbone_state = load_backbone_state(cfg.pretrained_backbone) \
        if cfg.pretrained_backbone else None
    predictor = Predictor.from_state_dict(
        cfg, state, rig, device=device, backbone_state_dict=backbone_state)

    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    n_view = pick_view_shards(n_dev, cfg.num_views)
    if n_view > 1:
        print(f"service: {n_dev} devices could shard the view axis "
              f"{n_view} ways; serving on {device} alone (multi-device "
              f"serving is not ported)", flush=True)

    if backbone_state is not None:
        prepare = lambda views: _frames_to_images(cfg, views)  # noqa: E731
    else:
        prepare = lambda views: _frames_to_heatmaps(cfg, views)  # noqa: E731

    n_done = 0
    fps_win: list[float] = []
    while not stop_flag.value:
        try:
            ts, views = frame_q.get(timeout=0.5)
        except queue.Empty:
            continue
        t0 = time.perf_counter()
        out = predictor(prepare(views))
        poses = out["fused_poses"].cpu().numpy()
        dt = time.perf_counter() - t0
        fps_win = (fps_win + [dt])[-30:]
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
        n_done += 1
        if svc.max_frames and n_done >= svc.max_frames:
            stop_flag.value = 1
            break


def _frames_to_images(cfg, views) -> np.ndarray:
    """Raw BGR frames -> (1, V, H, W, 3) normalized RGB batch at the
    working resolution."""
    import cv2

    from fvp_torch.data.images import IMAGENET_MEAN, IMAGENET_STD

    w, h = cfg.image_size
    out = np.zeros((1, cfg.num_views, h, w, 3), np.float32)
    for v, img in enumerate(views[:cfg.num_views]):
        if img.ndim == 2:
            img = img[..., None].repeat(3, axis=2)
        if img.shape[0] != h or img.shape[1] != w:
            img = cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
        rgb = cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
        out[0, v] = (rgb - IMAGENET_MEAN) / IMAGENET_STD
    return out


def _frames_to_heatmaps(cfg, views) -> np.ndarray:
    """Demo fallback (no backbone weights): down-convert raw views into
    per-joint heatmap stand-ins so the full topology runs end to end."""
    import cv2

    hm_w, hm_h = cfg.heatmap_size
    out = np.zeros((1, cfg.num_views, cfg.num_joints, hm_h, hm_w),
                   np.float32)
    for v, img in enumerate(views[:cfg.num_views]):
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
    if svc.coordinator:
        raise NotImplementedError(
            "multi-host serving (coordinator) is not ported to fvp_torch")
    stop_flag = SPAWN.Value("i", 0)
    frame_q = FrameQueue(maxsize=1)
    result_q = FrameQueue(maxsize=svc.result_queue_size)

    if svc.rtsp_url:
        source = RTSPSource(svc.rtsp_url, frame_q, stop_flag, split=True)
    else:
        source = SyntheticSource(frame_q, stop_flag,
                                 num_views=svc.num_views)
    source.start()

    infer = SPAWN.Process(target=inference_process,
                          args=(svc, frame_q, result_q, stop_flag),
                          daemon=True)
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
        for p in (infer, viz):
            p.join(timeout=3.0)
            if p.is_alive():
                p.terminate()
        source.stop()
    return died
