"""Spans and counters at the layer boundaries of the eval step, recorded
only while a torch profiler records.

    from fvp_torch.utils import tracing

    @tracing.spanned("localize")                    # a whole method
    def localize(...):
        with tracing.span("p2pnet"):                # a part of one
            ...
            tracing.count("jln_planes", n)          # a host integer

`record()` returns the closed spans (name, start and end, parent, call
id, and the counts made while each was the innermost open span) and the
counters summed; `reset()` clears them. A count made outside every span
belongs to no call and is dropped. Spans nest by a stack kept per thread;
a span opened with no parent starts a call, and its descendants share
its call id, so the spans of one `Predictor` call share one.

Times are `time.time_ns()`, the Unix clock that torch.profiler converts
its events to, so a span lines up with the device trace's kernels and
gaps. While no profiler records, `span` returns one shared no-op context
and `count` returns at once: a site costs one check of the profiler's
state. The recorder emits no profiler event (no `record_function`, no
NVTX range), so a trace holds only the work. Everything stays in memory,
nothing is written out, and the record keeps the last `MAX_SPANS` spans
only, so a process profiled for hours holds a bounded record.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import threading
import time
from dataclasses import dataclass, field

import torch

recording = torch._C._autograd._profiler_enabled

# about 3800 calls of 17 spans, a benchmark window; some 21 MiB when full
MAX_SPANS = 1 << 16


@dataclass(slots=True)
class Span:
    name: str
    start_ns: int
    end_ns: int | None
    id: int
    parent: int | None          # the enclosing span's id
    call: int
    counts: dict = field(default_factory=dict)     # name -> int


@dataclass(frozen=True)
class Record:
    spans: list                 # closed Spans, in start order
    counters: dict              # name -> total over every count


class _Open:
    """The context of one span while the profiler records."""
    __slots__ = ("recorder", "name", "span")

    def __init__(self, recorder: "Recorder", name: str):
        self.recorder, self.name = recorder, name

    def __enter__(self) -> Span:
        rec = self.recorder
        stack = rec._stack()
        parent = stack[-1] if stack else None
        if parent is None:
            self.span = Span(self.name, 0, None, next(rec._ids), None,
                             next(rec._calls))
        else:
            self.span = Span(self.name, 0, None, next(rec._ids), parent.id,
                             parent.call)
        stack.append(self.span)
        self.span.start_ns = time.time_ns()
        return self.span

    def __exit__(self, *exc) -> None:
        self.span.end_ns = time.time_ns()
        self.recorder._stack().pop()
        with self.recorder._lock:
            self.recorder._closed.append(self.span)


_OFF = contextlib.nullcontext()


class Recorder:
    """The spans and counts of one process's program."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count()
        self._calls = itertools.count()
        self._closed = collections.deque(maxlen=MAX_SPANS)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str):
        return _Open(self, name) if recording() else _OFF

    def count(self, name: str, n: int) -> None:
        if recording():
            stack = self._stack()
            if stack:               # the span is this thread's alone
                counts = stack[-1].counts
                counts[name] = counts.get(name, 0) + int(n)

    def record(self) -> Record:
        with self._lock:
            closed = sorted(self._closed, key=lambda s: s.start_ns)
        totals = {}
        for s in closed:
            for k, v in s.counts.items():
                totals[k] = totals.get(k, 0) + v
        return Record(
            [Span(s.name, s.start_ns, s.end_ns, s.id, s.parent, s.call,
                  dict(s.counts)) for s in closed], totals)

    def reset(self) -> None:
        with self._lock:
            self._closed.clear()


RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
record = RECORDER.record
reset = RECORDER.reset


def spanned(name: str):
    """A decorator: each call of the function inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return traced
    return wrap
