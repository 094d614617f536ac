"""Run-directory logging: a timestamped logfile and the console (a copy of
the reference package's `utils/logging.py::create_logger`, after the
original implementation's lib/utils/utils.py:19-50)."""

from __future__ import annotations

import logging
import os
import time


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
