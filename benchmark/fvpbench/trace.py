"""The traced run's device timeline, from torch.profiler's events.

The harness records host spans with `record_function`: its own around
each call and copy back (`HARNESS`), and one around each of the family's
`STAGES`, wrapped on the program's instance and named by the path's last
name (`stage_spans`). Each device operation is tied to the host call that
launched it by its correlation id, and so to the innermost span the
launch fell in. Times are in the profiler's clock, seconds.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from dataclasses import dataclass, field

HARNESS = ("call", "to_host")


def stage_spans(family) -> tuple:
    """The span names of the family's `STAGES`: each path's last name."""
    return tuple(p.rsplit(".", 1)[-1] for p in family.STAGES)


@dataclass
class Trace:
    window: tuple                       # (start, end) of the traced window
    spans: dict                         # name -> [(start, end)]
    ops: list                           # (name, start, dur, span, kernel?)
    calls: int                          # batches in the window
    notes: list = field(default_factory=list)
    stages: tuple = ()                  # the family's stage spans

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy(self) -> list:
        """Merged intervals in which some device operation ran, clipped to
        the window."""
        w0, w1 = self.window
        merged = []
        for _, s, d, _, _ in sorted(self.ops, key=lambda o: o[1]):
            s, e = max(s, w0), min(s + d, w1)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy())

    def kernel_s(self, span: str) -> float:
        """Device seconds of the kernels launched inside `span`."""
        return sum(d for _, _, d, sp, k in self.ops if k and sp == span)

    def by_name(self) -> dict:
        """Device seconds of each operation's name."""
        out = defaultdict(float)
        for name, _, d, _, _ in self.ops:
            out[name] += d
        return dict(out)

    def span_at(self, t: float) -> str:
        """The innermost span the host was in at `t`: of the spans open at
        `t`, the latest to start (the first of `stages`, then `to_host`,
        then `call`, on a tie)."""
        if not hasattr(self, "_starts"):
            self._starts = {k: [s for s, _ in v]
                            for k, v in self.spans.items()}
        best, start = "between calls", None
        for name in self.stages + ("to_host", "call"):
            i = bisect.bisect_right(self._starts.get(name, []), t) - 1
            if i >= 0 and t < self.spans[name][i][1] \
                    and (start is None or self._starts[name][i] > start):
                best, start = name, self._starts[name][i]
        return best

    def idle_by_span(self) -> dict:
        """Idle device seconds inside the window by what the host was in
        at the middle of each gap."""
        out = defaultdict(float)
        t = self.window[0]
        for s, e in self.busy() + [[self.window[1], self.window[1]]]:
            if s > t:
                out[self.span_at((t + s) / 2)] += s - t
            t = max(t, e)
        return dict(out)


_SYMBOL = re.compile(r"[A-Za-z_][A-Za-z0-9_:]*")


def short_name(name: str) -> str:
    """A device operation's name without its return type, anonymous
    namespace, template arguments or argument list (`void (anonymous
    namespace)::stem_kernel<2>(float const*, ...)` -> stem_kernel)."""
    s = name.replace("(anonymous namespace)::", "").strip()
    if s.startswith("void "):
        s = s[5:]
    m = _SYMBOL.match(s)
    return m.group(0) if m else name[:80]


def _ns(e, what: str) -> float:
    for attr in (f"{what}_ns", f"{what}_us"):
        fn = getattr(e, attr, None)
        if fn is not None:
            return fn() * (1.0 if attr.endswith("ns") else 1e3)
    raise AttributeError(f"profiler event has no {what}_ns or {what}_us")


def parse(prof, stages: tuple) -> Trace:
    """A Trace from a stopped torch.profiler.profile whose host spans are
    `HARNESS` and the stage spans `stages`."""
    named = set(HARNESS) | set(stages)
    events = prof.profiler.kineto_results.events()
    spans = defaultdict(list)
    launch = {}
    device = []
    for e in events:
        name = e.name()
        start = _ns(e, "start") * 1e-9
        dur = _ns(e, "duration") * 1e-9
        if str(e.device_type()).endswith("CUDA"):
            if name not in named:      # not the spans' device-side copies
                device.append((name, start, dur, e.correlation_id()))
        elif name in named:
            spans[name].append((start, start + dur))
        elif name.startswith("cu") and e.correlation_id():
            launch[e.correlation_id()] = start
    for v in spans.values():
        v.sort()
    calls = spans.get("call", [])
    backs = spans.get("to_host", [])
    if not calls or not backs:
        raise RuntimeError("trace: no harness spans recorded")
    window = (calls[0][0], backs[-1][1])
    tr = Trace(window=window, spans=dict(spans), ops=[], calls=len(calls),
               stages=tuple(stages))
    missing = 0
    for name, start, dur, corr in device:
        kernel = not name.startswith(("Memcpy", "Memset"))
        host = launch.get(corr)
        if host is None:
            missing += 1
        span = tr.span_at(host) if host is not None else "unknown"
        tr.ops.append((short_name(name) if kernel else name, start, dur,
                       span, kernel))
    if missing:
        tr.notes.append(f"{missing} device operations without a launch "
                        "event")
    return tr
