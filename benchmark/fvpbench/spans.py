"""The program's own spans and counters in a traced run's window.

`fvp_torch.utils.tracing` records spans (on the Unix clock, as the
profiler's events are) and counters while a profiler records, so a
`--trace 1` run has them with no switch. A program without the recorder
gives nothing here, and each reader of these then returns None.
"""

from __future__ import annotations

import bisect
import copy


def window_spans(run) -> list | None:
    """The program's closed spans that lie inside the run's traced window,
    or None (no trace, no recorder, no span)."""
    tr = run.trace
    if tr is None:
        return None
    try:
        from fvp_torch.utils import tracing
    except ImportError:
        return None
    w0, w1 = tr.window
    spans = [s for s in tracing.record().spans
             if w0 <= s.start_ns * 1e-9 and s.end_ns * 1e-9 <= w1]
    return spans or None


def counted(spans: list, name: str) -> int:
    """The counter `name` summed over the spans' own counts."""
    return sum(s.counts.get(name, 0) for s in spans)


def copies_in(tr) -> list:
    """(start, duration) of the host-to-device copies that start in the
    window, seconds."""
    w0, w1 = tr.window
    return [(s, d) for name, s, d, _, _ in tr.ops
            if name.startswith("Memcpy HtoD") and w0 <= s < w1]


def idle_by_leaf(run) -> dict:
    """Device idle seconds of the window by the program's innermost span
    at each gap's midpoint, as a path ('predict/detect/nms'); gaps outside
    every program span under the harness's innermost span ('call',
    'to_host', 'between calls'). The gaps are the breakdown's
    (`Trace.idle_by_span`), only the span each is put in differs."""
    tr = run.trace
    spans = window_spans(run) or []
    by_id = {s.id: s for s in spans}

    def path(s):
        names = []
        while s is not None:
            names.append(s.name)
            s = by_id.get(s.parent)
        return "/".join(reversed(names))

    # spans of one thread nest: the innermost span at t is the latest to
    # start before t, or the nearest of its ancestors still open at t
    order = sorted(spans, key=lambda s: (s.start_ns, -s.end_ns))
    starts = [s.start_ns * 1e-9 for s in order]

    def innermost(t):
        i = bisect.bisect_right(starts, t) - 1
        s = order[i] if i >= 0 else None
        while s is not None and t >= s.end_ns * 1e-9:
            s = by_id.get(s.parent)
        return path(s) if s is not None else tr.span_at(t)

    program = copy.copy(tr)
    program.span_at = innermost
    return program.idle_by_span()


def idle_in(run, name: str) -> float | None:
    """Device idle ms a batch whose gap's midpoint lies in one of the
    program's `name` spans or a child of one."""
    tr = run.trace
    if tr is None or not tr.ops or not tr.calls:
        return None
    inside = window_spans(run)
    if not inside or not any(s.name == name for s in inside):
        return None
    sec = sum(v for k, v in idle_by_leaf(run).items()
              if name in k.split("/"))
    return 1e3 * sec / tr.calls
