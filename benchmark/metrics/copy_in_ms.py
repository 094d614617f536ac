"""Serving engine: device milliseconds of the host-to-device copies in
the traced window, per `copy_in` span of the program in it (the frame's
copy to the card, `fvp_torch.engine.serve.copy_in`, one a call). From
the device trace, so a copy that the host only enqueues still counts
for the time the card spends on it."""

from fvpbench import spans


def read(run):
    inside = spans.window_spans(run)
    if not inside:
        return None
    calls = sum(s.name == "copy_in" for s in inside)
    copies = spans.copies_in(run.trace)
    if not calls or not copies:
        return None
    return 1e3 * sum(d for _, d in copies) / calls
