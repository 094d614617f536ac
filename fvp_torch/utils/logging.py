"""Run-directory logging: a timestamped logfile and the console, a JSONL
stream of scalars and a running-average meter (a copy of the reference
package's `utils/logging.py`, after the original implementation's
lib/utils/utils.py:19-50 and lib/core/function.py:186-202)."""

from __future__ import annotations

import json
import logging
import math
import os
import time
from typing import Any


def literal(x: Any) -> str:
    """`x` (nested dicts, lists, numpy scalars and arrays) written as a
    Python literal that `ast.literal_eval` reads back, as
    tools/summarize_run.py reads the train log's metric lines: numbers
    plain, an infinite float as 1e999 (read back as inf; `repr` writes
    `inf`, which is no literal)."""
    if isinstance(x, dict):
        return "{" + ", ".join(f"{literal(k)}: {literal(v)}"
                               for k, v in x.items()) + "}"
    if isinstance(x, (list, tuple)) or hasattr(x, "tolist"):
        x = x.tolist() if hasattr(x, "tolist") else x
        if not isinstance(x, (list, tuple)):
            return literal(x)
        return "[" + ", ".join(literal(v) for v in x) + "]"
    if isinstance(x, float) and math.isinf(x):
        return "1e999" if x > 0 else "-1e999"
    return repr(x)


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
