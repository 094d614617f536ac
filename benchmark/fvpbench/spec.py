"""What a run reads by name: the cell's entry in BENCHMARK.json, its
configuration file, the configuration's family (`families/<family>.py`,
named by the file's "family" key), its traffic mix
(`traffic/<name>.json`), its limits (`limits/<cell>.json`) and its
per-layer metrics' readers (`metrics/<name>.py`). Adding a cell, a
configuration, a metric or a model of another architecture adds files and
entries; no file here changes.

A family module is all that knows the model. The harness, the
calibration and the metric readers call only these names of it:
- `weights(config, seed, device, backbone)`: the model's weights drawn
  from the seed (with `traffic.draw` on stream 0 of `traffic.stream_seed`),
  the backbone's only where `backbone` (the cell's `sends_images`);
  opaque to the harness, which hands them to the next three;
- `gate(config, weights, rig, first, device)`: set-up that fits the
  seeded weights to the traffic's first batch (a score head scaled to the
  configuration's gate); returns the scale;
- `predictor(config, weights, rig, device)`: the program, built on its
  normal entry point; `predictor(batch)` returns a dict of device tensors;
- `OUTPUTS`: the keys of that dict copied back to the host each call;
- `STAGES`: the methods the harness wraps in `record_function` spans, as
  attribute paths from the predictor (`"model.detect"`); the span takes
  the last name, and the traced run's timeline (`fvpbench/trace.py`)
  knows these spans by it. `JUDGED_STAGE`: the one whose output the
  harness keeps on the judged slots for `slot_judge`;
- `reference(config, rig, weights, device, fmt="fp32")`: the plain
  reference (`reference/`), computed in `fmt` (`reference.precision`);
  its `forward(frame)` returns the outputs and, under the last name of
  `JUDGED_STAGE`, that stage's output (the control puts it in the
  program's place);
- `slot_judge(ref, frame, kept)`: the reference's reading of one judged
  slot's frame (on the device) and of the program's kept `JUDGED_STAGE`
  output on it (None if it kept none); its `stage` is a dict of the
  numbers of that output, and its `judge(answer)` returns the numbers of
  one answer (and `parts`);
- `sampled_people(run)`: the data-dependent part of a batch's kernel work,
  read from the run's outputs, passed on to `kernel_bounds` as `people`;
- `model_flops(config, backbone)`: {part: operations of one frame}, with
  "frame" the whole; `kernel_bounds(config, batch, people, backbone)`:
  {kernel counter: (launches a batch, least ms)}; `SYMBOLS`: {CUDA
  symbol: the kernel counters whose launches run it}.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parents[1]      # benchmark/


@dataclass
class Cell:
    name: str
    root: Path                 # the checkout: BENCHMARK.json's directory
    entry: dict                # the workload entry of BENCHMARK.json
    config: dict               # the configuration file
    traffic: dict              # traffic/<traffic>.json
    limits: dict               # limits/<cell>.json: {number: limit}
    family: ModuleType         # families/<config's family>.py
    end_to_end: list           # the end-to-end metrics the cell reports
    per_layer: list            # the per-layer metrics the cell reports
    bench_dir: Path = field(default=BENCH_DIR)

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    @property
    def sends_images(self) -> bool:
        """Whether the traffic sends images, so that the configuration's
        backbone runs (heatmaps bypass it)."""
        return self.traffic["input"] == "images"


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
    path = root / configs[entry["config"]]["file"]
    config = json.loads(path.read_text())
    if "family" not in config:
        raise KeyError(f'{path}: no "family" key; it names the module '
                       f"{bench_dir / 'families'}/<family>.py")
    module = bench_dir / "families" / f"{config['family']}.py"
    if not module.is_file():
        raise FileNotFoundError(f"{path}: family {config['family']!r} has "
                                f"no module {module}")
    traffic = json.loads((bench_dir / "traffic" / f"{entry['traffic']}.json")
                         .read_text())
    limits = json.loads((bench_dir / "limits" / f"{name}.json").read_text())
    return Cell(name=name, root=root, entry=entry, config=config,
                traffic=traffic, limits=limits,
                family=family_module(config["family"], bench_dir),
                end_to_end=[m for m in doc["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in doc["per_layer"] if _applies(m, name)],
                bench_dir=bench_dir)


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The `read(run)` function of metrics/<name>.py."""
    return _load(bench_dir / "metrics" / f"{name}.py",
                 "fvpbench_metric_").read


def family_module(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """The module families/<name>.py."""
    return _load(bench_dir / "families" / f"{name}.py", "fvpbench_family_")


def _load(path: Path, prefix: str) -> ModuleType:
    """The module in the file `path`, loaded under a name of its own."""
    name = prefix + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
