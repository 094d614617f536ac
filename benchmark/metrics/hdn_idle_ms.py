"""HDN: device idle milliseconds a batch while the host is in the
program's `detect` span or a child of it (the breakdown's gaps, each by
its midpoint). The program's `detect` lies inside the harness's
`detect` wrapper, whose `record_function` opens and closes some 30-240
us outside it under the profiler: idle in those margins is the
wrapper's own cost, not the HDN's, and is left out by design, so this
times calls can read below the breakdown's `detect` entry."""

from fvpbench import spans


def read(run):
    return spans.idle_in(run, "detect")
