"""What a run reads by name: the cell's entry in BENCHMARK.json, its
configuration file, its traffic mix (`traffic/<name>.json`), its limits
(`limits/<cell>.json`) and its per-layer metrics' readers
(`metrics/<name>.py`). Adding a cell, a configuration or a metric adds
files and entries; no file here changes."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]      # benchmark/


@dataclass
class Cell:
    name: str
    root: Path                 # the checkout: BENCHMARK.json's directory
    entry: dict                # the workload entry of BENCHMARK.json
    config: dict               # the configuration file
    traffic: dict              # traffic/<traffic>.json
    limits: dict               # limits/<cell>.json: {number: limit}
    end_to_end: list           # the end-to-end metrics the cell reports
    per_layer: list            # the per-layer metrics the cell reports
    bench_dir: Path = field(default=BENCH_DIR)

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell `name` of the BENCHMARK.json in `root`, with every file it
    names; raises if one is missing."""
    doc = json.loads((root / "BENCHMARK.json").read_text())
    entries = {w["name"]: w for w in doc["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}"
                       f"; there are {sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in doc["configs"]}
    config = json.loads((root / configs[entry["config"]]["file"])
                        .read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{entry['traffic']}.json")
                         .read_text())
    limits = json.loads((bench_dir / "limits" / f"{name}.json").read_text())
    return Cell(name=name, root=root, entry=entry, config=config,
                traffic=traffic, limits=limits,
                end_to_end=[m for m in doc["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in doc["per_layer"] if _applies(m, name)],
                bench_dir=bench_dir)


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The `read(run)` function of metrics/<name>.py."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "fvpbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
