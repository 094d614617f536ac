"""Families: the harness reaches the model only through
`families/<family>.py`, named by the configuration's "family".

- The Faster-VoxelPose family draws, gates, judges and counts exactly as
  the harness did before the families: `pins.json` holds the values that
  harness gave (the same probes, run on its tree) for the tiny
  configurations at SEED and for the real configurations' counts.
- A second family joins as files and entries only, and a run of it is
  correct.
- The backbone follows the traffic: a configuration with a backbone under
  heatmap traffic draws, builds and counts none.
"""

import hashlib
import json
import shutil
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import tiny
from fvpbench import harness, traffic
from fvpbench.spec import BENCH_DIR, family_module, load_cell

PINS = json.loads((Path(__file__).parent / "pins.json").read_text())
SEED = PINS["seed"]
CONTROL = {"float32": "tf32", "bfloat16": "fp8"}
# the pins are float64 sums of float32 values: equal on one machine, and
# within rounding where another CPU's vector paths round an ulp apart
REL = 1e-6


def fingerprint(t: torch.Tensor) -> list:
    """[shape, dtype, sum, sum weighted by position mod 7 + 1]."""
    x = t.detach().reshape(-1).to(torch.float64)
    w = 1.0 + (torch.arange(x.numel(), dtype=torch.float64) % 7)
    return [list(t.shape), str(t.dtype).replace("torch.", ""),
            float(x.sum()), float((x * w).sum())]


def fingerprint_dict(d: dict) -> list:
    """[hash of the keys, shapes and dtypes, sums of the leaves laid end
    to end in key order]."""
    keys = ";".join(f"{k}:{tuple(v.shape)}:{v.dtype}" for k, v in d.items())
    flat = torch.cat([v.detach().reshape(-1).to(torch.float64)
                      for v in d.values()])
    return [hashlib.sha256(keys.encode()).hexdigest()] + fingerprint(flat)[2:]


def same(got: list, pin: list):
    exact = [v for v in pin if not isinstance(v, float)]
    assert [v for v in got if not isinstance(v, float)] == exact
    assert [v for v in got if isinstance(v, float)] == pytest.approx(
        [v for v in pin if isinstance(v, float)], rel=REL)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny.make_tree(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("name", ["tiny.img", "tiny.hm"])
def test_draws_match_the_pins(tree, name):
    pin = PINS["cells"][name]
    cell = load_cell(name, *tree)
    fam = cell.family
    rig = traffic.rig_of(cell.config)
    weights = fam.weights(cell.config, SEED, "cpu",
                          cell.sends_images)
    same(fingerprint_dict(weights[0]), pin["weights"])
    if pin["backbone"] is None:
        assert weights[1] is None
    else:
        same(fingerprint_dict(weights[1]), pin["backbone"])
    ring = traffic.frame_ring(cell.config, cell.traffic, rig, SEED, "cpu")
    assert len(ring) == len(pin["ring"])
    for x, p in zip(ring, pin["ring"]):
        same(fingerprint(x), p)
    assert traffic.judged_slots(cell.traffic, SEED) == pin["slots"]
    scale = fam.gate(cell.config, weights, rig, ring[0], "cpu")
    assert scale == pytest.approx(pin["gate"], rel=REL)
    same(fingerprint_dict(weights[0]), pin["gated"])


@pytest.mark.parametrize("name", ["tiny.img", "tiny.hm"])
def test_judge_matches_the_pins(tree, name):
    """The judge's numbers on fixed answers: the reference's own at
    float32 (all nought) and its control's one precision below."""
    pin = PINS["cells"][name]
    cell = load_cell(name, *tree)
    for fmt in ("fp32", CONTROL[cell.config["config"]["compute_dtype"]]):
        numbers, readings = harness.control_run(cell, SEED, fmt, "cpu")
        want = pin[f"judge_{fmt}"]
        assert numbers == pytest.approx(want["numbers"], rel=1e-4, abs=1e-12)
        assert harness.parts(readings) == pytest.approx(
            want["parts"], rel=1e-4, abs=1e-12)


@pytest.mark.parametrize("name", ["tiny.img", "tiny.hm"])
def test_counts_match_the_pins(tree, name):
    pin = PINS["cells"][name]
    cell = load_cell(name, *tree)
    images = cell.sends_images
    assert cell.family.model_flops(cell.config, images) == pin["model_flops"]
    got = cell.family.kernel_bounds(cell.config, 2, [(1500.0, 2), (0.0, 0)],
                                    images)
    assert {k: list(v) for k, v in got.items()} == pin["kernel_bounds"]


@pytest.mark.parametrize("real,gflop", [("panoptic-jln64-bf16", 583.0),
                                        ("shelf-jln64", 41.1)])
def test_real_counts_match_the_pins(real, gflop):
    """The real configurations as their cells run them (Panoptic's with
    its backbone, on images)."""
    pin = PINS["real"][real]
    c = json.loads((BENCH_DIR / "configs" / f"{real}.json").read_text())
    fam = family_module(c["family"])
    f = fam.model_flops(c, True)
    assert f == pin["model_flops"]
    assert round(f["frame"] / 1e9, 1) == gflop
    got = fam.kernel_bounds(c, 8, [(10 * 64 ** 3, 10), (3 * 64 ** 3, 4)],
                            True)
    assert {k: list(v) for k, v in got.items()} == pin["kernel_bounds"]


def _files(root: Path) -> dict:
    return {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


# appended to the copied family: the same program, its HDN and JLN
# reached under other names, as a family of other stages would name them
RENAMED = """

STAGES = ("heatmaps", "model.cpn", "model.prn")
_build = predictor


def predictor(config, weights, rig, device):
    p = _build(config, weights, rig, device)
    m = p.model
    m.cpn, m.prn = m.detect, m.localize
    m.detect = lambda *a, **k: m.cpn(*a, **k)
    m.localize = lambda *a, **k: m.prn(*a, **k)
    return p
"""


def plant(root: Path, bench: Path, extra: str = ""):
    """Add the family `planted_pose` (a copy of Faster-VoxelPose's, with
    `extra` appended), a configuration naming it, its entries in
    BENCHMARK.json and a limits file; returns the old BENCHMARK.json."""
    src = (bench / "families" / "faster_voxelpose.py").read_text()
    (bench / "families" / "planted_pose.py").write_text(src + extra)
    cfg = json.loads((bench / "configs" / "tiny-hm.json").read_text())
    cfg["name"], cfg["family"] = "tiny-planted", "planted_pose"
    (bench / "configs" / "tiny-planted.json").write_text(json.dumps(cfg))
    shutil.copy(bench / "limits" / "tiny.hm.json",
                bench / "limits" / "tiny.planted.json")
    doc = json.loads((root / "BENCHMARK.json").read_text())
    old = json.loads(json.dumps(doc))
    doc["configs"].append({"name": "tiny-planted", "source": "tiny",
                           "file": "benchmark/configs/tiny-planted.json",
                           "reduced": [], "why": "test"})
    doc["workloads"].append({"name": "tiny.planted", "config": "tiny-planted",
                             "traffic": "hm-b2", "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    return old


def test_second_family_joins_as_files(tmp_path):
    """A family module (here a copy of Faster-VoxelPose's under another
    name), a configuration naming it, its entries in BENCHMARK.json and a
    limits file: enough for a correct run, with no file of the tree
    edited."""
    root, bench = tiny.make_tree(tmp_path)
    before = _files(root)
    old = plant(root, bench)

    cell = load_cell("tiny.planted", root, bench)
    assert Path(cell.family.__file__).name == "planted_pose.py"
    run, numbers, _ = harness.run_cell(cell, 7, 0.6, False, "cpu",
                                       time.perf_counter())
    correct, checks = harness.judge.verdict(numbers, cell.limits)
    assert correct, checks
    assert run.calls >= 1
    after = _files(root)
    for path, data in before.items():
        if path.name != "BENCHMARK.json":
            assert after[path] == data, path
    new = json.loads((root / "BENCHMARK.json").read_text())
    for k, v in old.items():
        assert new[k][:len(v)] == v if isinstance(v, list) else new[k] == v


def test_second_family_stages_are_traced_by_their_names(tmp_path):
    """A family whose STAGES end in other names: a traced run records
    its spans under those names, and the timeline puts each moment of
    them in its stage."""
    root, bench = tiny.make_tree(tmp_path)
    plant(root, bench, RENAMED)
    cell = load_cell("tiny.planted", root, bench)
    run, numbers, _ = harness.run_cell(cell, 7, 0.6, True, "cpu",
                                       time.perf_counter())
    correct, checks = harness.judge.verdict(numbers, cell.limits)
    assert correct, checks
    tr = run.trace
    assert tr.stages == ("heatmaps", "cpn", "prn")
    assert {"cpn", "prn", "call", "to_host"} <= set(tr.spans)
    assert "detect" not in tr.spans and "localize" not in tr.spans
    for name in ("cpn", "prn"):
        assert len(tr.spans[name]) == tr.calls
        for a, b in tr.spans[name]:
            assert tr.span_at((a + b) / 2) == name


class _Event:
    """A kineto event of the fake profiler: times in ms."""

    def __init__(self, name, a, b, cuda=False, corr=0):
        self._v = (name, round(a * 1e6), round((b - a) * 1e6),
                   "DeviceType.CUDA" if cuda else "DeviceType.CPU", corr)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


def test_trace_takes_the_family_stage_names():
    """`trace.parse` on a timeline whose stage spans are a family's own
    (`cpn`, with `nms` inside it, then `prn`): the stage ranges' device
    side copies are no device operations, and each kernel and gap goes to
    the innermost stage the host was in."""
    from fvpbench import trace

    fam = SimpleNamespace(STAGES=("model.cpn", "model.cpn_nms.nms",
                                  "model.prn"))
    assert trace.stage_spans(fam) == ("cpn", "nms", "prn")
    E = _Event
    events = [
        E("call", 0, 10), E("to_host", 10, 11),
        E("cpn", 0.6, 4.5), E("nms", 3.0, 4.2), E("prn", 5.0, 8.0),
        # the ranges' device-side copies (gpu_user_annotation)
        E("call", 0.9, 7.0, cuda=True), E("cpn", 1.0, 4.5, cuda=True),
        E("nms", 3.5, 4.5, cuda=True), E("prn", 5.5, 7.0, cuda=True),
        # three launches and their kernels
        E("cudaLaunchKernel", 1.2, 1.3, corr=1),
        E("void k_a(float*)", 1.0, 1.5, cuda=True, corr=1),
        E("cudaLaunchKernel", 3.2, 3.3, corr=2),
        E("void k_b(float*)", 3.5, 4.5, cuda=True, corr=2),
        E("cudaLaunchKernel", 5.5, 5.6, corr=3),
        E("void k_c(float*)", 6.0, 7.0, cuda=True, corr=3),
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    tr = trace.parse(prof, trace.stage_spans(fam))
    assert [o[0] for o in tr.ops] == ["k_a", "k_b", "k_c"]
    assert [o[3] for o in tr.ops] == ["cpn", "nms", "prn"]
    assert tr.busy_s() == pytest.approx(2.5e-3, abs=1e-9)
    # gaps 0-1 (call), 1.5-3.5 (cpn), 4.5-6 (prn: mid 5.25), 7-11 (call)
    idle = tr.idle_by_span()
    assert idle == pytest.approx({"call": 5e-3, "cpn": 2e-3, "prn": 1.5e-3},
                                 abs=1e-9)


def test_heatmap_traffic_bypasses_the_backbone(tmp_path):
    """The image configuration under heatmap traffic draws no backbone
    weights (and the same task nets), builds a predictor without one,
    counts no backbone operations and bounds no backbone kernel."""
    root, bench = tiny.make_tree(tmp_path)
    shutil.copy(bench / "limits" / "tiny.img.json",
                bench / "limits" / "tiny.img-hm.json")
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["workloads"].append({"name": "tiny.img-hm", "config": "tiny-img",
                             "traffic": "hm-b2", "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    cell = load_cell("tiny.img-hm", root, bench)
    fam, config = cell.family, cell.config
    assert config["config"]["backbone"] and not cell.sends_images

    sd, bb = fam.weights(config, SEED, "cpu", cell.sends_images)
    assert bb is None
    same(fingerprint_dict(sd), PINS["cells"]["tiny.img"]["weights"])
    f = fam.model_flops(config, False)
    assert f["backbone"] == 0.0
    assert f["frame"] == f["hdn"] + f["jln"] > 0
    with_bb = fam.model_flops(config, True)
    assert with_bb["backbone"] > 0
    assert (f["hdn"], f["jln"]) == (with_bb["hdn"], with_bb["jln"])
    bounds = fam.kernel_bounds(config, 2, [(1500.0, 2)], False)
    assert not {"stem", "bottleneck_stage.wgmma", "deconv_stage"} & set(bounds)
    assert {"stem", "deconv_stage"} <= set(
        fam.kernel_bounds(config, 2, [(1500.0, 2)], True))

    built = []
    run, numbers, _ = harness.run_cell(
        cell, SEED, 0.6, False, "cpu", time.perf_counter(),
        wrap=lambda p: built.append(p.backbone))
    assert built == [None]
    correct, checks = harness.judge.verdict(numbers, cell.limits)
    assert correct, checks
    assert "heatmaps" not in numbers


@pytest.mark.parametrize("family,error,match", [
    (None, KeyError, "tiny-hm.json"),
    ("no_such_family", FileNotFoundError, "tiny-hm.json.*no_such_family")])
def test_bad_family_names_the_file(tmp_path, family, error, match):
    """A configuration without "family", or naming a family with no
    module: the error names the configuration's file."""
    root, bench = tiny.make_tree(tmp_path)
    path = bench / "configs" / "tiny-hm.json"
    cfg = json.loads(path.read_text())
    cfg.pop("family")
    if family is not None:
        cfg["family"] = family
    path.write_text(json.dumps(cfg))
    with pytest.raises(error, match=match):
        load_cell("tiny.hm", root, bench)
