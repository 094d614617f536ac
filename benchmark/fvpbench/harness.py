"""One run of a cell: set-up, the measured window, the comparison.

The run builds the program of the configuration's family (`cell.family`,
see `fvpbench/spec.py`) from weights drawn from the seed, makes the
traffic's ring of distinct input batches in host memory, warms up on
every ring slot, then drives a closed loop for the window: one client,
one batch in flight, `predictor(batch)` on the host batch (the program's
own host-to-device copy inside), then the family's `OUTPUTS` copied back
to the host. After the window it reads the memory peak, frees the program
and judges the answers of the judged slots against the plain reference.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import statistics
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from fvpbench import judge, trace as tracing, traffic
from fvpbench.spec import Cell, metric_reader


@dataclass
class Run:
    """What a run measured; the per-layer metrics' readers read it."""
    cell: Cell
    batch: int
    window_s: float
    latencies: list            # s, call start to outputs on the host
    submits: list              # s, call start to the call's return
    outputs: list              # (slot, {output: host tensor}) per batch
    launches: dict             # kernel name -> launches in the window
    setup_s: float
    setup_parts: dict = field(default_factory=dict)
    memory_peak_bytes: int = 0
    trace: tracing.Trace | None = None
    notes: list = field(default_factory=list)

    @property
    def calls(self) -> int:
        return len(self.latencies)

    @property
    def frames(self) -> int:
        return self.calls * self.batch

    @property
    def config(self) -> dict:
        return self.cell.config


class Spans:
    """Wrappers on the family's `STAGES` of the predictor instance: a
    `record_function` range each when the run is traced, and the output of
    its `JUDGED_STAGE` on the judged slots kept for the comparison (their
    last answer in the window)."""

    def __init__(self, predictor, family, judged: list, traced: bool):
        self.slot = None
        self.kept = {}
        self.judged = set(judged)
        self.traced = traced
        for path in family.STAGES:
            *owner, name = path.split(".")
            obj = functools.reduce(getattr, owner, predictor)
            setattr(obj, name, self._wrap(name, getattr(obj, name),
                                          keep=path == family.JUDGED_STAGE))

    def range(self, name: str):
        if self.traced:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def _wrap(self, name, fn, keep=False):
        def wrapped(*args, **kwargs):
            with self.range(name):
                out = fn(*args, **kwargs)
            if keep and self.slot in self.judged:
                self.kept[self.slot] = out
            return out
        return wrapped


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device, t_start: float, wrap=None) -> tuple:
    """(Run, numbers the comparison read, per-slot readings). `wrap`, if
    given, is called on the predictor after set-up (the fault tests)."""
    from fvp_torch.ops.kernels import all_kernels

    device = torch.device(device)
    config, mix, fam = cell.config, cell.traffic, cell.family
    parts = {}
    mark = [t_start]

    def lap(name):
        now = time.perf_counter()
        parts[name] = now - mark[0]
        mark[0] = now

    lap("start")
    rig = traffic.rig_of(config)
    weights = fam.weights(config, seed, device, cell.sends_images)
    lap("weights")
    ring = traffic.frame_ring(config, mix, rig, seed, device)
    lap("frames")
    fam.gate(config, weights, rig, ring[0], device)
    gc.collect()
    if device.type == "cuda":          # the peak is the program's alone
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    lap("gate")
    predictor = fam.predictor(config, weights, rig, device)
    lap("predictor")
    slots = traffic.judged_slots(mix, seed)
    spans = Spans(predictor, fam, slots, traced)
    if wrap is not None:
        wrap(predictor)

    def step(r):
        spans.slot = r
        t0 = time.perf_counter()
        with spans.range("call"):
            out = predictor(ring[r])
        t1 = time.perf_counter()
        with spans.range("to_host"):
            host = {k: out[k].cpu() for k in fam.OUTPUTS}
        return host, t0, t1, time.perf_counter()

    for r in list(range(len(ring))) + [0, 1 % len(ring)]:
        step(r)
    _sync(device)
    lap("warm-up")
    setup_s = time.perf_counter() - t_start

    kernels = all_kernels()
    before = {k: v.launches for k, v in kernels.items()}
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    outputs, lat, sub = [], [], []
    i = 0
    w0 = time.perf_counter()
    deadline = w0 + seconds
    while True:
        r = i % len(ring)
        host, t0, t1, t2 = step(r)
        outputs.append((r, host))
        lat.append(t2 - t0)
        sub.append(t1 - t0)
        i += 1
        if t2 >= deadline:
            break
    window_s = t2 - w0
    if prof is not None:
        _sync(device)
        prof.__exit__(None, None, None)
    launches = {k: v.launches - before[k] for k, v in kernels.items()
                if v.launches - before[k]}
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    run = Run(cell=cell, batch=mix["batch"], window_s=window_s,
              latencies=lat, submits=sub, outputs=outputs,
              launches=launches, setup_s=setup_s, setup_parts=parts,
              memory_peak_bytes=peak)
    if prof is not None:
        run.trace = tracing.parse(prof, tracing.stage_spans(fam))
        run.notes += run.trace.notes
        del prof

    kept = {r: spans.kept.get(r) for r in slots}
    del predictor, spans
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, readings = judge_run(cell, rig, weights, ring, slots, outputs,
                                  kept, device)
    return run, numbers, readings


def judge_run(cell, rig, weights, ring, slots, outputs, kept, device):
    """The comparison: every answer of the judged slots against the plain
    reference. Returns (numbers, per-slot readings)."""
    ref = cell.family.reference(cell.config, rig, weights, device)
    readings = []
    for r in slots:
        answers = [o for s, o in outputs if s == r]
        sj = cell.family.slot_judge(ref, ring[r].to(device), kept[r])
        for a in answers:
            readings.append({**sj.stage, **sj.judge(a), "slot": r})
        if not answers:
            readings.append({**sj.stage, "slot": r, "missing": 1.0})
        del sj
    del ref
    numbers = judge.combine([{k: v for k, v in x.items() if k != "slot"}
                             for x in readings])
    return numbers, readings


def control_run(cell: Cell, seed: int, fmt: str, device) -> tuple:
    """The control: the plain reference computed in `fmt` put in the
    program's place on the judged slots of the seed's traffic, its
    answers judged as a run judges the program's. (numbers, readings)."""
    device = torch.device(device)
    config, mix, fam = cell.config, cell.traffic, cell.family
    rig = traffic.rig_of(config)
    weights = fam.weights(config, seed, device, cell.sends_images)
    ring = traffic.frame_ring(config, mix, rig, seed, device)
    fam.gate(config, weights, rig, ring[0], device)
    slots = traffic.judged_slots(mix, seed)
    low = fam.reference(config, rig, weights, device, fmt)
    stage = fam.JUDGED_STAGE.rsplit(".", 1)[-1]
    outputs, kept = [], {}
    for r in slots:
        out = low.forward(ring[r].to(device))
        kept[r] = out.pop(stage)
        outputs.append((r, {k: v.cpu() for k, v in out.items()}))
    del low
    gc.collect()
    return judge_run(cell, rig, weights, ring, slots, outputs, kept, device)


def parts(readings: list) -> dict:
    """The worst of each part of the HDN number over the readings."""
    out = {}
    for r in readings:
        for k, v in r.get("parts", {}).items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def kept_per_frame(run: Run) -> float:
    return statistics.mean(float(o["mask"].float().sum(dim=1).mean())
                           for _, o in run.outputs)


def end_to_end(run: Run) -> dict:
    lat_ms = [t * 1e3 for t in run.latencies]
    return {
        "frames_per_s": {"value": run.frames / run.window_s,
                         "unit": "frames/s"},
        "batch_p95_ms": {"value": float(np.percentile(lat_ms, 95)),
                         "unit": "ms"},
        "setup_s": {"value": run.setup_s, "unit": "s"},
    }


def per_layer(run: Run) -> dict:
    out = {}
    for m in run.cell.per_layer:
        value = metric_reader(m["name"], run.cell.bench_dir)(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def breakdown(tr: tracing.Trace) -> dict:
    ops = sorted(tr.by_name().items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(tr.idle_by_span().items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}


def summary(run: Run) -> str:
    lat = sorted(t * 1e3 for t in run.latencies)
    return (f"{run.calls} batches of {run.batch} in {run.window_s:.3f} s; "
            f"latency median {statistics.median(lat):.3f} ms over "
            f"{len(lat)} samples, p95 from the "
            f"{len(lat) - int(0.95 * len(lat))} slowest; people kept a frame {kept_per_frame(run):.2f}; "
            f"set-up {run.setup_s:.3f} s: " + ", ".join(
                f"{k} {v:.3f}" for k, v in run.setup_parts.items()))
