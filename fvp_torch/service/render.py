"""Overlay rendering + RTSP restream for the streaming service.

A copy of the reference package's `service/render.py`:
`render_result_on_image` reprojects fused 3D poses into every camera view
of a 2-column composite and draws joints, limbs and the person count;
`FFmpegRestream` pipes raw BGR frames into an ffmpeg process that
publishes RTSP, handles a broken pipe, and warns and does nothing where
ffmpeg is not installed. cv2 is imported where it draws.
"""

from __future__ import annotations

import subprocess
from typing import Optional

import numpy as np

from fvp_torch.config import FVPConfig
from fvp_torch.geometry.cameras import CameraRig, project_points_np
from fvp_torch.geometry.transforms import affine_apply
from fvp_torch.utils.vis import limbs_for

_GREEN = (0, 255, 0)
_POSE_COLOR = (255, 128, 0)


def _valid(pt, w, h) -> bool:
    return 0 <= pt[0] < w and 0 <= pt[1] < h


def compose_views(views, image_size) -> np.ndarray:
    """Tile V camera views into a 2-column composite at image_size
    (views drawn at half resolution)."""
    import cv2

    w, h = image_size
    w2, h2 = w // 2, h // 2
    rows = (len(views) + 1) // 2
    canvas = np.zeros((h2 * max(rows, 2), w), np.uint8)[..., None].repeat(
        3, axis=2)
    for c, view in enumerate(views):
        r, col = c // 2, c % 2
        resized = cv2.resize(view, (w2, h2),
                             interpolation=cv2.INTER_NEAREST)
        if resized.ndim == 2:
            resized = resized[..., None].repeat(3, axis=2)
        canvas[r * h2:(r + 1) * h2, col * w2:(col + 1) * w2] = resized
    return canvas


def render_result_on_image(cfg: FVPConfig, rig: CameraRig,
                           resize_transform: np.ndarray, image: np.ndarray,
                           fused_poses: np.ndarray,
                           fps: Optional[float] = None,
                           latency_ms: Optional[float] = None) -> np.ndarray:
    """Draw each detected person's reprojected skeleton into every view
    quadrant of the composite `image` (modified in place and returned).

    fused_poses: (max_people, num_joints, 5) — [..., 3] is the match index
    (-1 = no detection), [..., 4] the confidence; the detection gate is
    cfg.min_score on the confidence."""
    import cv2

    K, J = fused_poses.shape[:2]
    limbs = limbs_for(J)
    rows = max(2, (rig.num_cameras + 1) // 2)   # matches compose_views
    h2 = image.shape[0] // rows
    w2 = image.shape[1] // 2

    detected = 0
    for n in range(K):
        if fused_poses[n, 0, 4] < cfg.min_score:
            continue
        detected += 1
        for c in range(rig.num_cameras):
            y_off = (c // 2) * h2
            x_off = (c % 2) * w2
            pose2d = project_points_np(
                fused_poses[n, :, :3].astype(np.float64), rig.camera(c))
            pose2d = affine_apply(pose2d, resize_transform) / 2.0
            for j in range(J):
                if _valid(pose2d[j], w2, h2):
                    cv2.circle(image,
                               (int(pose2d[j, 0] + x_off),
                                int(pose2d[j, 1] + y_off)),
                               4, _POSE_COLOR, -1)
            for a, b in limbs:
                if _valid(pose2d[a], w2, h2) and _valid(pose2d[b], w2, h2):
                    cv2.line(image,
                             (int(pose2d[a, 0] + x_off),
                              int(pose2d[a, 1] + y_off)),
                             (int(pose2d[b, 0] + x_off),
                              int(pose2d[b, 1] + y_off)),
                             _POSE_COLOR, 2)

    if fps is not None:
        cv2.putText(image, f"FPS: {fps:.1f}", (10, 30),
                    cv2.FONT_HERSHEY_SIMPLEX, 1, _GREEN, 2)
    if latency_ms is not None:
        cv2.putText(image, f"Inference time: {latency_ms:.1f}ms", (10, 70),
                    cv2.FONT_HERSHEY_SIMPLEX, 1, _GREEN, 2)
    cv2.putText(image, f"Detect {detected} people", (10, 110),
                cv2.FONT_HERSHEY_SIMPLEX, 1, _GREEN, 2)
    return image


class FFmpegRestream:
    """Publish rendered frames to an RTSP endpoint through an ffmpeg pipe.
    Degrades to a no-op with a warning when
    ffmpeg is not installed; reopens after a broken pipe with a backoff so
    an unreachable target doesn't spawn one ffmpeg per frame."""

    REOPEN_BACKOFF_S = 5.0

    def __init__(self, url: str, size, fps: float = 30.0):
        self.url = url
        self.size = size          # (w, h)
        self.fps = fps
        self.proc: Optional[subprocess.Popen] = None
        self.dead = False
        self._last_open = 0.0
        self._open()

    def _open(self) -> None:
        import time

        self._last_open = time.monotonic()
        cmd = [
            "ffmpeg", "-y", "-f", "rawvideo", "-pix_fmt", "bgr24",
            "-s", f"{self.size[0]}x{self.size[1]}", "-r", str(self.fps),
            "-i", "-", "-c:v", "libx264", "-preset", "ultrafast",
            "-tune", "zerolatency", "-f", "rtsp", self.url,
        ]
        try:
            self.proc = subprocess.Popen(
                cmd, stdin=subprocess.PIPE,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        except FileNotFoundError:
            print("ffmpeg not found; RTSP restream disabled", flush=True)
            self.dead = True

    def write(self, frame: np.ndarray) -> None:
        import time

        if self.dead:
            return
        if self.proc is None or self.proc.stdin is None:
            if time.monotonic() - self._last_open >= self.REOPEN_BACKOFF_S:
                self._open()
            return
        try:
            self.proc.stdin.write(np.ascontiguousarray(frame).tobytes())
        except BrokenPipeError:
            print("RTSP restream pipe broke; will reopen after backoff",
                  flush=True)
            self.close()

    def close(self) -> None:
        if self.proc is not None:
            try:
                if self.proc.stdin is not None:
                    self.proc.stdin.close()
                self.proc.wait(timeout=1)
            except Exception:
                self.proc.terminate()
                try:
                    self.proc.wait(timeout=1)   # reap; no zombie
                except Exception:
                    self.proc.kill()
                    self.proc.wait()
            self.proc = None
