"""JLN: device idle milliseconds a batch while the host is in the
program's `localize` span or a child of it (the breakdown's gaps, each
by its midpoint). Idle in the margins of the harness's `localize`
wrapper, outside the program's span, is the wrapper's and is left out,
as in `hdn_idle_ms`."""

from fvpbench import spans


def read(run):
    return spans.idle_in(run, "localize")
