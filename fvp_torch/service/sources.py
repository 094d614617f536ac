"""Frame sources for the streaming service.

A copy of the reference package's `service/sources.py` (after the
original implementation's lib/utils/rtsp_utils.py): a separate OS process
reads the stream with low-latency settings, pushes frames into a bounded
drop-oldest queue, reconnects with a backoff on read failure, and
optionally splits a 2x2 composite frame into four camera views.

`SyntheticSource` generates moving-person composite frames so the full
service pipeline is testable without any camera hardware.

Every process and queue here comes from the `spawn` context, as the
reference's run_service forces spawn for all of them, but without
changing the caller's start method: the inference process initialises
CUDA, which a forked child of a process that did so cannot.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import time
from typing import Optional

import numpy as np

SPAWN = mp.get_context("spawn")


def split_quad(frame: np.ndarray) -> list[np.ndarray]:
    """Split a 2x2 composite frame into [tl, tr, bl, br] views."""
    h, w = frame.shape[:2]
    h2, w2 = h // 2, w // 2
    return [frame[:h2, :w2], frame[:h2, w2:],
            frame[h2:, :w2], frame[h2:, w2:]]


class FrameQueue:
    """Bounded drop-oldest queue."""

    def __init__(self, maxsize: int = 1):
        self.q = SPAWN.Queue(maxsize=maxsize)

    def put(self, item) -> None:
        while True:
            try:
                self.q.put_nowait(item)
                return
            except queue.Full:
                try:
                    self.q.get_nowait()
                except queue.Empty:
                    pass

    def get(self, timeout: Optional[float] = None):
        return self.q.get(timeout=timeout)


class RTSPSource:
    """RTSP capture in its own process with reconnect + drop-oldest."""

    def __init__(self, url: str, out_queue: FrameQueue,
                 stop_flag, split: bool = True,
                 reconnect_backoff: float = 2.0):
        self.url = url
        self.out = out_queue
        self.stop_flag = stop_flag
        self.split = split
        self.backoff = reconnect_backoff
        self.proc: Optional[mp.process.BaseProcess] = None

    def start(self) -> None:
        self.proc = SPAWN.Process(target=self._run, daemon=True)
        self.proc.start()

    def _open(self):
        import cv2
        cap = cv2.VideoCapture(self.url, cv2.CAP_FFMPEG)
        cap.set(cv2.CAP_PROP_BUFFERSIZE, 1)
        return cap

    def _run(self) -> None:
        cap = self._open()
        while not self.stop_flag.value:
            ok, frame = cap.read()
            if not ok:
                cap.release()
                time.sleep(self.backoff)
                cap = self._open()
                continue
            views = split_quad(frame) if self.split else [frame]
            self.out.put((time.time(), views))
        cap.release()

    def stop(self) -> None:
        if self.proc is not None:
            self.proc.join(timeout=2.0)
            if self.proc.is_alive():
                self.proc.terminate()


class SyntheticSource:
    """Camera-free source: renders dots for circling people into V views."""

    def __init__(self, out_queue: FrameQueue, stop_flag, num_views: int = 4,
                 size=(480, 640), fps: float = 30.0, num_people: int = 2):
        self.out = out_queue
        self.stop_flag = stop_flag
        self.num_views = num_views
        self.size = size
        self.fps = fps
        self.num_people = num_people
        self.proc: Optional[mp.process.BaseProcess] = None

    def start(self) -> None:
        self.proc = SPAWN.Process(target=self._run, daemon=True)
        self.proc.start()

    def _run(self) -> None:
        t0 = time.time()
        h, w = self.size
        while not self.stop_flag.value:
            t = time.time() - t0
            views = []
            for v in range(self.num_views):
                img = np.zeros((h, w, 3), np.uint8)
                for p in range(self.num_people):
                    ang = t * 0.5 + p * 2.1 + v * 0.3
                    cx = int(w / 2 + np.cos(ang) * w / 4)
                    cy = int(h / 2 + np.sin(ang) * h / 4)
                    img[max(cy - 5, 0):cy + 5, max(cx - 5, 0):cx + 5] = 255
                views.append(img)
            self.out.put((time.time(), views))
            time.sleep(1.0 / self.fps)

    def stop(self) -> None:
        if self.proc is not None:
            self.proc.join(timeout=2.0)
            if self.proc.is_alive():
                self.proc.terminate()
