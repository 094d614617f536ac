#!/usr/bin/env python
"""Streaming service CLI of the PyTorch port.

`python run/service_torch.py --cfg configs/panoptic/jln64.yaml --rtsp_url
rtsp://...` (omit --rtsp_url for the synthetic test source). It serves on
`cuda` unless --device says otherwise; without a card the inference
process raises and the CLI exits 1, as it does whenever a child process
died. `python run/service_torch.py --device cpu --max_frames 5
--view_mode none` drives the whole topology on the host. The arguments
are the reference package's run/service.py's, with --device; multi-host
serving is not ported, so --coordinator raises (--num_hosts and
--host_id do nothing without it). See fvp_torch/service/pipeline.py.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fvp_torch.service.pipeline import ServiceConfig, run_service  # noqa: E402


def on_result(res):
    """Result sink for the spawned visualization process (must be a
    module-level function: ServiceConfig is pickled across the spawn)."""
    print(f"[{res['timestamp']:.2f}] "
          f"{int((res['poses'][:, 0, 3] >= 0).sum())} people, "
          f"latency {res['latency_ms']:.1f} ms, fps {res['fps']:.1f}",
          flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", default="")
    parser.add_argument("--rtsp_url", default="")
    parser.add_argument("--checkpoint", default="",
                        help="FasterVoxelPose weights: a torch state dict "
                             "(.pth/.tar) or the reference package's "
                             "model_best.msgpack")
    parser.add_argument("--calibration", default="",
                        help="custom-format calibration.json")
    parser.add_argument("--num_views", type=int, default=4)
    parser.add_argument("--max_frames", type=int, default=None)
    parser.add_argument("--fps", type=float, default=30.0)
    parser.add_argument("--view_mode", default="callback",
                        choices=("callback", "save", "rtsp", "none"))
    parser.add_argument("--output_dir", default=ServiceConfig().output_dir,
                        help="JPEGs of --view_mode save")
    parser.add_argument("--restream_url", default="",
                        help="rtsp:// publish target for --view_mode rtsp")
    parser.add_argument("--coordinator", default="",
                        help="multi-host serving: not ported (raises)")
    parser.add_argument("--num_hosts", type=int, default=1,
                        help="multi-host serving: not ported")
    parser.add_argument("--host_id", type=int, default=0,
                        help="multi-host serving: not ported")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default; raises without a card) or "
                             "'cpu' for the plain path")
    args = parser.parse_args(argv)

    died = run_service(ServiceConfig(
        cfg_path=args.cfg,
        rtsp_url=args.rtsp_url,
        checkpoint=args.checkpoint,
        calibration=args.calibration,
        num_views=args.num_views,
        target_fps=args.fps,
        max_frames=args.max_frames,
        view_mode=args.view_mode,
        output_dir=args.output_dir,
        restream_url=args.restream_url,
        on_result=on_result,
        coordinator=args.coordinator,
        device=args.device,
    ))
    return 0 if died is None else 1


if __name__ == "__main__":
    sys.exit(main())
