"""The recorder (fvp_torch/utils/tracing.py) and the spans and counters of
the eval step, on the CPU at tiny sizes: nothing recorded without a
profiler; under torch.profiler the span tree of a heatmap-source and an
image-source `Predictor` call, the bytes of the copy to the device, the
JLN's planes, the spans on the profiler's clock, and the record's bound. The
file imports no JAX, so it also runs on a card (`--noconftest`)."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import fvp_torch.models.faster_voxelpose as fvp
from fvp_torch.config import FVPConfig
from fvp_torch.engine.serve import Predictor
from fvp_torch.geometry.cameras import default_ring_rig
from fvp_torch.models.resnet import PoseResNet, seeded_state_dict
from fvp_torch.utils import tracing

TINY = dict(num_views=2, ori_image_size=(256, 192), image_size=(128, 96),
            heatmap_size=(32, 24), space_size=(4000.0, 4000.0, 2000.0),
            voxels_per_axis=(16, 16, 8), max_people=3,
            ind_space_size=(2000.0, 2000.0, 2000.0),
            ind_voxels_per_axis=(16, 16, 16), test_batch_size=2,
            resnet_layers=18)
HDN = ("whole_sample", "centernet", "nms", "c2cnet", "proposals")
JLN = ("person_planes", "p2pnet", "soft_argmax", "weightnet", "fuse")
# each span's parent in a Predictor call
PARENT = {"predict": None, "copy_in": "predict", "backbone": "predict",
          "detect": "predict", "localize": "predict", "finish": "predict",
          **{n: "detect" for n in HDN}, **{n: "localize" for n in JLN}}


@pytest.fixture(scope="module")
def predictors():
    """(heatmap-source, image-source) predictors on the CPU."""
    torch.manual_seed(3)
    cfg = FVPConfig(**TINY)
    rig = default_ring_rig(cfg.num_views, cfg.space_center,
                           cfg.ori_image_size, focal=200.0)
    sd = fvp.FasterVoxelPose(cfg).state_dict()
    bb = seeded_state_dict(PoseResNet(cfg.num_joints, 18), 5)
    w, h = cfg.heatmap_size
    hm = torch.rand(2, cfg.num_views, cfg.num_joints, h, w)
    hm_pred = Predictor.from_state_dict(cfg, sd, rig, device="cpu")
    img_pred = Predictor.from_state_dict(cfg, sd, rig, device="cpu",
                                         backbone_state_dict=bb)
    W, H = cfg.image_size
    images = torch.randn(2, cfg.num_views, H, W, 3)
    return hm_pred, hm, img_pred, images


def traced(fn, *args):
    """fn(*args) under torch.profiler (CPU activity), the recorder reset
    before: (its result, the profiler, the record)."""
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*args)
    return out, prof, tracing.record()


def test_nothing_recorded_without_a_profiler(predictors):
    hm_pred, hm, img_pred, images = predictors
    tracing.reset()
    hm_pred(hm)
    img_pred(images)
    assert not tracing.recording()
    rec = tracing.record()
    assert rec.spans == [] and rec.counters == {}


@pytest.mark.parametrize("source", ["heatmaps", "images"])
def test_span_tree(predictors, source):
    hm_pred, hm, img_pred, images = predictors
    pred, frame = (hm_pred, hm) if source == "heatmaps" \
        else (img_pred, images)
    _, _, rec = traced(lambda: [pred(frame), pred(frame)])
    want = set(PARENT) - ({"backbone"} if source == "heatmaps" else set())
    by_id = {s.id: s for s in rec.spans}
    roots = [s for s in rec.spans if s.parent is None]
    assert [s.name for s in roots] == ["predict", "predict"]
    assert roots[0].call != roots[1].call
    for root in roots:
        mine = [s for s in rec.spans if s.call == root.call]
        assert sorted(s.name for s in mine) == sorted(want)
        for s in mine:
            assert s.start_ns <= s.end_ns
            if s is root:
                continue
            parent = by_id[s.parent]
            assert parent.name == PARENT[s.name], s.name
            assert parent.call == s.call
            assert parent.start_ns <= s.start_ns <= s.end_ns \
                <= parent.end_ns, s.name


@pytest.mark.parametrize("kind", ["tensor", "numpy"])
def test_copy_in_counts_the_frame(predictors, kind):
    hm_pred, hm, img_pred, images = predictors
    frames = {"tensor": (hm_pred, hm), "numpy": (img_pred, images.numpy())}
    pred, frame = frames[kind]
    _, _, rec = traced(pred, frame)
    assert rec.counters["copy_in_bytes"] == frame.nbytes
    copy = [s for s in rec.spans if s.name == "copy_in"]
    assert len(copy) == 1 and copy[0].counts == {
        "copy_in_bytes": frame.nbytes}


def test_jln_planes(predictors):
    """P2PNet's planes are counted on its span, a host int from the shape;
    the record holds no tensor."""
    hm_pred, hm, _, _ = predictors
    out, _, rec = traced(hm_pred, hm)
    B, K = out["mask"].shape
    assert rec.counters["jln_planes"] == 3 * B * K
    by_name = {s.name: s.counts for s in rec.spans}
    assert by_name["p2pnet"] == {"jln_planes": 3 * B * K}
    assert all(type(v) is int for s in rec.spans for v in s.counts.values())


def test_spans_on_the_profilers_clock(predictors, monkeypatch):
    """The ATen events the profiler recorded inside a `record_function`
    marker around `whole_sample` lie inside the program's `whole_sample`
    span, within 50 us: the two clocks agree."""
    hm_pred, hm, _, _ = predictors
    sample = fvp.whole_sample

    def marked(*args, **kwargs):
        with torch.profiler.record_function("marker"):
            return sample(*args, **kwargs)
    monkeypatch.setattr(fvp, "whole_sample", marked)
    _, prof, rec = traced(hm_pred, hm)
    span, = [s for s in rec.spans if s.name == "whole_sample"]
    events = prof.profiler.kineto_results.events()
    mark, = [e for e in events if e.name() == "marker"]
    m0, m1 = mark.start_ns(), mark.start_ns() + mark.duration_ns()
    inside = [e for e in events if e.name().startswith("aten::")
              and m0 <= e.start_ns() <= m1]
    assert inside
    slack = 50_000
    for e in inside + [mark]:
        assert span.start_ns - slack <= e.start_ns(), e.name()
        assert e.start_ns() + e.duration_ns() <= span.end_ns + slack, \
            e.name()


@pytest.mark.parametrize("source", ["heatmaps", "images"])
def test_profiler_events_hold_no_span_name(predictors, source):
    """The recorder adds no profiler event: a trace's reader, which takes
    every event it does not know for device work, sees only the work."""
    hm_pred, hm, img_pred, images = predictors
    pred, frame = (hm_pred, hm) if source == "heatmaps" \
        else (img_pred, images)
    _, prof, rec = traced(pred, frame)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {s.name for s in rec.spans} == set(PARENT) - (
        {"backbone"} if source == "heatmaps" else set())
    assert not names & set(PARENT)


def test_count_outside_a_span_is_dropped():
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("loose", 2)
        with tracing.span("outer"):
            tracing.count("planes", 30)
            tracing.count("planes", 3)
    tracing.count("planes", 7)                     # no profiler: dropped
    rec = tracing.record()
    assert rec.counters == {"planes": 33}
    assert [s.counts for s in rec.spans] == [{"planes": 33}]
    tracing.reset()
    assert tracing.record() == tracing.Record([], {})


def test_record_keeps_the_last_spans(monkeypatch):
    """The record is bounded: past `MAX_SPANS` the oldest spans go."""
    monkeypatch.setattr(tracing, "MAX_SPANS", 4)
    rec = tracing.Recorder()
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(6):
            with rec.span(f"s{i}"):
                rec.count("n", i)
    got = rec.record()
    assert [s.name for s in got.spans] == ["s2", "s3", "s4", "s5"]
    assert got.counters == {"n": 2 + 3 + 4 + 5}
    assert [s.call for s in got.spans] == [2, 3, 4, 5]


def test_reset_keeps_a_span_still_open():
    """A span open across `reset()` is recorded when it closes; the spans
    closed before it are gone."""
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("outer") as outer:
            with tracing.span("before"):
                pass
            tracing.reset()
            with tracing.span("after") as after:
                pass
    rec = tracing.record()
    assert [s.name for s in rec.spans] == ["outer", "after"]
    assert rec.spans[1].parent == outer.id and after.call == outer.call
    assert all(s.end_ns is not None for s in rec.spans)
    tracing.reset()
