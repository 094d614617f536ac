"""The harness end to end on the CPU at tiny sizes, through the program's
plain paths, judged against the plain reference; and the comparison
seeing faults planted under the timed path."""

import time

import pytest
import torch

import tiny
from fvpbench import harness
from fvpbench.spec import load_cell

SEED = 2 ** 31 + 17


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny.make_tree(tmp_path_factory.mktemp("bench"))


def run(tree, name, wrap=None, traced=False):
    root, bench = tree
    cell = load_cell(name, root, bench)
    r, numbers, readings = harness.run_cell(
        cell, SEED, 0.6, traced, "cpu", time.perf_counter(), wrap=wrap)
    return cell, r, numbers, readings


@pytest.mark.parametrize("name", ["tiny.hm", "tiny.img"])
def test_tiny_run_is_correct(tree, name):
    cell, r, numbers, readings = run(tree, name)
    correct, checks = harness.judge.verdict(numbers, cell.limits)
    assert correct, checks
    assert r.calls >= 1 and r.frames == r.calls * 2
    assert set(numbers) == set(cell.limits)
    assert harness.kept_per_frame(r) > 0
    e2e = harness.end_to_end(r)
    assert set(e2e) == {"frames_per_s", "batch_p95_ms", "setup_s"}
    assert all(v["value"] > 0 for v in e2e.values())


def test_traced_run_reads_host_metrics(tree):
    _, r, _, _ = run(tree, "tiny.hm", traced=True)
    assert r.trace is not None and r.trace.calls == r.calls
    layer = harness.per_layer(r)
    assert layer["submit_ms"]["value"] > 0
    # no card: no device number is read
    for name in ("hdn_ms", "jln_ms", "device_idle_pct",
                 "kernel_roofline_pct"):
        assert name not in layer


def _altered(pred):
    """A joint of the first kept person moved 30 mm where it is made."""
    finish = pred.model.finish

    def altered(proposals, fused, confs):
        out = finish(proposals, fused, confs)
        kept = torch.nonzero(out["mask"])
        if len(kept):
            b, k = kept[0].tolist()
            out["fused_poses"] = out["fused_poses"].clone()
            out["fused_poses"][b, k, 0, 0] += 30.0
        return out
    pred.model.finish = altered


def _half_batch(pred):
    """Half of the batch left out: the first half's answers for all."""
    forward = pred.model.forward

    def half(hm, rc, packed=None, *a, **kw):
        h = hm.shape[0] // 2
        out = forward(hm[:h].contiguous(), rc, packed, *a, **kw)
        return {k: torch.cat([v, v]) for k, v in out.items()}
    pred.model.forward = half


@pytest.mark.parametrize("name", ["tiny.hm", "tiny.img"])
@pytest.mark.parametrize("fault", [_altered, _half_batch])
def test_fault_is_not_correct(tree, name, fault):
    cell, _, numbers, _ = run(tree, name, wrap=fault)
    correct, checks = harness.judge.verdict(numbers, cell.limits)
    assert not correct, checks


def test_nan_reading_is_not_correct():
    numbers = harness.judge.combine([{"hdn": 0.1}, {"hdn": float("nan")},
                                     {"hdn": 0.2}])
    assert not harness.judge.verdict(numbers, {"hdn": 1.0})[0]


def test_missing_limit_is_not_correct():
    ok, checks = harness.judge.verdict({"hdn": 0.0}, {})
    assert not ok and checks["hdn"]["limit"] is None
    ok, _ = harness.judge.verdict({"hdn": float("nan")}, {"hdn": 1.0})
    assert not ok
