"""The readers of the program's own spans and counters
(`fvpbench/spans.py`, `metrics/copy_in_ms.py`, `copy_in_gbps.py`,
`hdn_idle_ms.py`, `jln_idle_ms.py`, `jln_live_pct.py`): each on a
synthetic trace and record against the value worked out by hand, each
silent without a trace, without spans or without the recorder, and
`jln_live_pct` and `spans_report.py`'s report read from a tiny traced
CPU run, where no card gives the device-trace ones anything to read."""

import sys
import time
from types import SimpleNamespace

import pytest
import torch

import spans_report
import tiny
from fvp_torch.utils import tracing
from fvpbench import harness, spans
from fvpbench.spec import load_cell, metric_reader
from fvpbench.trace import Trace

NEW = ("copy_in_ms", "copy_in_gbps", "hdn_idle_ms", "jln_idle_ms",
       "jln_live_pct")
T = 1_760_000_000.0          # a Unix time, s: the clocks' own magnitude
MS = 1e-3
# the trace's times are float64 seconds: at T they resolve 2.4e-7 s, so
# each boundary may move by that much
SLACK_S = 1e-6


def ns(ms: float) -> int:
    return round(T * 1e9) + round(ms * 1e6)


def span(i, name, a, b, parent=None, counts=None):
    return tracing.Span(name, ns(a), ns(b), i, parent, 0, counts or {})


# one batch in a 10 ms window; times in ms from T
SPANS = [
    span(0, "predict", 0.5, 9.5),
    span(1, "copy_in", 0.5, 2.5, 0, {"copy_in_bytes": 4_000_000}),
    span(2, "detect", 3.0, 5.0, 0),
    span(3, "nms", 4.0, 4.5, 2),
    span(4, "localize", 5.0, 8.0, 0),
    span(5, "person_planes", 5.0, 6.0, 4),
    span(6, "p2pnet", 6.0, 7.0, 4, {"jln_planes": 30}),
    span(7, "finish", 8.0, 9.0, 0),
    # a call after the window: left out
    span(8, "predict", 20.0, 21.0),
    span(9, "copy_in", 20.0, 20.5, 8, {"copy_in_bytes": 10 ** 9}),
    span(10, "p2pnet", 20.5, 21.0, 8, {"jln_planes": 1000}),
]
# the device busy at [0, 1], [2, 3.2], [3.6, 3.8], [4.5, 5.5], [7, 9.6]:
# gaps 1-2 (copy_in), 3.2-3.6 (detect), 3.8-4.5 (nms), 5.5-7 (p2pnet),
# 9.6-10 (the harness's to_host); the host-to-device copies 0.5-0.9 (the
# frame's 4 MB) and 3.0-3.1 (a small one in the HDN): 0.5 ms in all
BUSY = [(0.0, 1.0), (2.0, 3.2), (3.6, 3.8), (4.5, 5.5), (7.0, 9.6)]
COPIES = [(0.5, 0.9), (3.0, 3.1)]
# a batch of 2 frames of K = 5: 2 people kept of the 30 planes' 10
MASK = torch.tensor([[1, 0, 0, 0, 0], [0, 0, 1, 0, 0]], dtype=torch.bool)
EXPECTED = {"copy_in_ms": 0.5, "copy_in_gbps": 8.0, "hdn_idle_ms": 1.1,
            "jln_idle_ms": 1.5, "jln_live_pct": 20.0}


def trace() -> Trace:
    def s(ms):
        return T + ms * MS
    ops = [("k", s(a), (b - a) * MS, "call", True) for a, b in BUSY]
    ops += [("Memcpy HtoD (Pageable -> Device)", s(a), (b - a) * MS, "call",
             False) for a, b in COPIES]
    # the copy back, not a copy in
    ops.append(("Memcpy DtoH (Device -> Pageable)", s(9.0), 0.5 * MS,
                "to_host", False))
    return Trace(window=(s(0), s(10)),
                 spans={"call": [(s(0), s(9.7))],
                        "to_host": [(s(9.7), s(10))]},
                 ops=ops, calls=1)


def run():
    return SimpleNamespace(trace=trace(), outputs=[(0, {"mask": MASK})])


@pytest.fixture
def recorded(monkeypatch):
    """The recorder's record() giving SPANS."""
    rec = tracing.Record(list(SPANS), {})
    monkeypatch.setattr(tracing, "record", lambda: rec)


@pytest.mark.parametrize("name", NEW)
def test_reader_by_hand(recorded, name):
    got = metric_reader(name)(run())
    assert got == pytest.approx(EXPECTED[name], rel=1e-6,
                                abs=SLACK_S / MS)


@pytest.mark.parametrize("name", NEW)
def test_reader_silent_without_trace_or_spans(monkeypatch, name):
    read = metric_reader(name)
    assert read(SimpleNamespace(trace=None, outputs=[])) is None
    monkeypatch.setattr(tracing, "record",
                        lambda: tracing.Record([], {}))
    assert read(run()) is None
    # spans, all outside the window
    monkeypatch.setattr(tracing, "record",
                        lambda: tracing.Record(SPANS[8:], {}))
    assert read(run()) is None


@pytest.mark.parametrize("name", NEW)
def test_reader_silent_without_the_recorder(monkeypatch, name):
    """A program without `fvp_torch.utils.tracing` (the commit before it):
    nothing to read, and no error."""
    monkeypatch.setitem(sys.modules, "fvp_torch.utils.tracing", None)
    assert metric_reader(name)(run()) is None


def test_idle_by_leaf_by_hand(recorded):
    got = spans.idle_by_leaf(run())
    want = {"predict/copy_in": 1.0, "predict/detect": 0.4,
            "predict/detect/nms": 0.7, "predict/localize/p2pnet": 1.5,
            "to_host": 0.4}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v * MS, abs=SLACK_S), k


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny.make_tree(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("name", ["tiny.hm", "tiny.img"])
def test_tiny_traced_run_reads_program_spans(tree, name):
    cell = load_cell(name, *tree)
    r, _, _ = harness.run_cell(cell, 2 ** 31 + 29, 0.6, True, "cpu",
                               time.perf_counter())
    layer = harness.per_layer(r)
    assert 0 <= layer["jln_live_pct"]["value"] <= 100
    # no card: no device trace to read a copy or an idle gap from
    for m in ("copy_in_ms", "copy_in_gbps", "hdn_idle_ms", "jln_idle_ms"):
        assert m not in layer, m
    inside = spans.window_spans(r)
    assert sum(s.name == "predict" for s in inside) == r.calls
    assert sum(s.name == "copy_in" for s in inside) == r.calls
    rep = spans_report.report(r)
    assert rep["calls"] == r.calls
    assert rep["host_ms"]["whole_sample"] > 0
    assert rep["host_ms"]["predict"] >= rep["host_ms"]["detect"] > 0
