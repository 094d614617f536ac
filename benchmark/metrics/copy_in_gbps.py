"""Serving engine: the rate of the frame's copy to the card, GB/s: the
program's `copy_in_bytes` in the traced window over the device time of
the window's host-to-device copies (from the device trace)."""

from fvpbench import spans


def read(run):
    inside = spans.window_spans(run)
    if not inside:
        return None
    moved = spans.counted(inside, "copy_in_bytes")
    sec = sum(d for _, d in spans.copies_in(run.trace))
    if not moved or sec <= 0:
        return None
    return 1e-9 * moved / sec
