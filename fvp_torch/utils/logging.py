"""Run-directory logging: a timestamped logfile and the console, a JSONL
stream of scalars and a running-average meter (a copy of the reference
package's `utils/logging.py`, after the original implementation's
lib/utils/utils.py:19-50 and lib/core/function.py:186-202)."""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any


def create_logger(output_dir: str, cfg_name: str, phase: str = "train"):
    """-> (logger, final_output_dir). Layout mirrors the reference:
    output/<cfg_name>/<phase>_<timestamp>.log"""
    final_dir = os.path.join(output_dir, cfg_name)
    os.makedirs(final_dir, exist_ok=True)
    stamp = time.strftime("%Y-%m-%d-%H-%M")
    log_file = os.path.join(final_dir, f"{phase}_{stamp}.log")

    logger = logging.getLogger(f"fvp_torch.{phase}")
    logger.setLevel(logging.INFO)
    for h in logger.handlers:           # a run before this one's log file
        h.close()
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)-15s %(message)s")
    fh = logging.FileHandler(log_file)
    fh.setFormatter(fmt)
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(sh)
    return logger, final_dir


class MetricWriter:
    """Append-only JSONL stream of scalars (`scalars.jsonl` in out_dir)."""

    def __init__(self, out_dir: str, name: str = "scalars.jsonl"):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, name)

    def add_scalars(self, step: int, **scalars: Any) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


class AverageMeter:
    """The last value and the running average of a series."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
