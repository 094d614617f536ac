"""Every configuration, cell and metric of BENCHMARK.json loads by name,
the file keeps to the contract's shape, and a cell, a configuration, a
traffic mix and a per-layer metric added as new files are found."""

import json
import re
import shutil
import time

import pytest

import tiny
from fvpbench import harness
from fvpbench.spec import BENCH_DIR, load_cell, metric_reader

ROOT = BENCH_DIR.parent
DOC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in DOC["workloads"]])
def test_cell_loads(cell):
    c = load_cell(cell, ROOT)
    assert c.config["name"] == c.entry["config"]
    assert c.traffic["batch"] >= 1 and c.traffic["judged"] <= c.traffic["ring"]
    assert "exact" in c.limits and c.limits["exact"] == 0.0
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in DOC["per_layer"]])
def test_metric_reader_loads(metric):
    assert callable(metric_reader(metric))


def test_contract_shape():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert DOC["paths"] == ["benchmark"]
    assert 1 <= DOC["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in DOC[k]]
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in DOC["end_to_end"]}
    assert "setup_s" in e2e
    for m in DOC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for m in DOC["per_layer"]:
        assert m["moves"] in e2e and m["better"] in ("lower", "higher")
    for c in DOC["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("benchmark/")
    for w in DOC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


def test_added_files_are_found(tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric in a
    copy of the tree: files and entries only."""
    root, bench = tiny.make_tree(tmp_path)
    cfg = json.loads((bench / "configs" / "tiny-hm.json").read_text())
    cfg["name"] = "tiny-hm-k2"
    cfg["config"]["max_people"] = 2
    (bench / "configs" / "tiny-hm-k2.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "hm-b2.json").read_text())
    mix["people"] = [2, 2]
    (bench / "traffic" / "hm-b2-two.json").write_text(json.dumps(mix))
    shutil.copy(bench / "limits" / "tiny.hm.json",
                bench / "limits" / "tiny.hm2.json")
    (bench / "metrics" / "batches_n.py").write_text(
        "def read(run):\n    return float(run.calls)\n")
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "tiny-hm-k2", "source": "tiny",
                           "file": "benchmark/configs/tiny-hm-k2.json",
                           "reduced": [], "why": "test"})
    doc["workloads"].append({"name": "tiny.hm2", "config": "tiny-hm-k2",
                             "traffic": "hm-b2-two", "chips": 1,
                             "why": "test"})
    doc["per_layer"].append({"name": "batches_n", "unit": "batches",
                             "better": "higher", "source": "host_clock",
                             "layer": "serving engine",
                             "moves": "frames_per_s",
                             "workloads": ["tiny.hm2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))

    cell = load_cell("tiny.hm2", root, bench)
    assert cell.config["config"]["max_people"] == 2
    assert cell.traffic["people"] == [2, 2]
    assert "batches_n" in [m["name"] for m in cell.per_layer]
    assert "batches_n" not in [m["name"] for m in
                               load_cell("tiny.hm", root, bench).per_layer]
    run, numbers, _ = harness.run_cell(cell, 5, 0.6, False, "cpu",
                                       time.perf_counter())
    assert run.outputs[0][1]["proposals"].shape[1] == 2
    assert harness.per_layer(run)["batches_n"]["value"] == run.calls
    assert harness.judge.verdict(numbers, cell.limits)[0]


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        load_cell("no-such-cell", ROOT)
