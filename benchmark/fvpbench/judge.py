"""The comparison that decides `correct`: what every family shares.

Each judged ring slot is worked out by the plain reference (float32, TF32
off) from the same inputs and weights: the family's `slot_judge` holds
the program's output of its `JUDGED_STAGE` on the slot and each answer
of the slot against the reference, stage by stage, on the program's own
output of the stage before. Every number is the worst over all answers of the judged slots
in the window (`combine`), a share of the reference's own scale unless
its name says mm; the limits come from the cell's limits file
(`verdict`).
"""

from __future__ import annotations

import torch


def max_or_zero(t: torch.Tensor) -> float:
    return float(t.max()) if t.numel() else 0.0


def combine(readings: list) -> dict:
    """The worst of each number over a run's judged answers; a NaN stays
    the worst."""
    out = {}
    for r in readings:
        for k, v in r.items():
            if k == "parts":
                continue
            old = out.get(k, 0.0)
            out[k] = v if (v != v or v > old) and old == old else old
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}): correct iff every number
    has a limit and is within it."""
    checks, ok = {}, True
    for k in sorted(numbers):
        lim = limits.get(k)
        checks[k] = {"value": numbers[k], "limit": lim}
        if lim is None or not numbers[k] <= lim:
            ok = False
    return ok, checks
