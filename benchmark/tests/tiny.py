"""A benchmark tree at tiny sizes for the CPU tests: a copy of the real
one's BENCHMARK.json layout with two small configurations (with and
without the backbone), their mixes and limits, and the real families and
metric readers."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

TINY = {
    "num_views": 2, "ori_image_size": [256, 192], "image_size": [128, 96],
    "heatmap_size": [32, 24], "space_size": [4000.0, 4000.0, 2000.0],
    "voxels_per_axis": [16, 16, 8], "max_people": 3,
    "ind_space_size": [2000.0, 2000.0, 2000.0],
    "ind_voxels_per_axis": [16, 16, 16], "test_batch_size": 2,
}
# set as a cell's limits are, between the program's readings at these
# sizes (float32: 1e-7 of the scale and 6e-4 mm; bf16: 1.0e-2 on the
# heatmaps, 4e-3 on the HDN, 1.3 mm, 3e-3) and the control's (TF32: 2e-4
# and 0.07 mm; fp8: 0.10, 0.025, 8 mm, 0.01)
LIMITS = {
    "tiny.img": {"heatmaps": 0.03, "hdn": 0.012, "pose_mm": 4.0,
                 "jln_conf": 0.008, "exact": 0.0},
    "tiny.hm": {"hdn": 2e-5, "pose_mm": 0.01, "jln_conf": 2e-5,
                "exact": 0.0},
}


def config(name: str) -> dict:
    """A real configuration cut to TINY's sizes."""
    real = {"tiny-img": "panoptic-jln64-bf16", "tiny-hm": "shelf-jln64"}[name]
    c = json.loads((BENCH / "configs" / f"{real}.json").read_text())
    c = copy.deepcopy(c)
    c["name"] = name
    c["config"].update(TINY)
    c["assumed"]["rig"]["focal"] = 200.0
    c["assumed"]["people_spread_mm"] = 1000.0
    return c


def make_tree(tmp: Path) -> tuple[Path, Path]:
    """(root, bench_dir) of a tiny benchmark tree under `tmp`: cells
    'tiny.img' (bf16 images through the backbone) and 'tiny.hm' (float32
    heatmaps), at batch 2."""
    root = tmp / "checkout"
    bench = root / "benchmark"
    for d in ("configs", "traffic", "limits"):
        (bench / d).mkdir(parents=True)
    for d in ("metrics", "families"):
        shutil.copytree(BENCH / d, bench / d)
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    doc["configs"], doc["workloads"] = [], []
    for cname, tname, cell in (("tiny-img", "img-b2", "tiny.img"),
                               ("tiny-hm", "hm-b2", "tiny.hm")):
        path = bench / "configs" / f"{cname}.json"
        path.write_text(json.dumps(config(cname)))
        doc["configs"].append({"name": cname, "source": "tiny",
                               "file": f"benchmark/configs/{cname}.json",
                               "reduced": [], "why": "test"})
        doc["workloads"].append({"name": cell, "config": cname,
                                 "traffic": tname, "chips": 1,
                                 "why": "test"})
        (bench / "limits" / f"{cell}.json").write_text(
            json.dumps(LIMITS[cell]))
    for m in doc["per_layer"]:
        m.pop("workloads", None)
    for m in doc["end_to_end"]:
        m.pop("workloads", None)
    (bench / "traffic" / "img-b2.json").write_text(json.dumps(
        {"input": "images", "batch": 2, "ring": 2, "judged": 2}))
    (bench / "traffic" / "hm-b2.json").write_text(json.dumps(
        {"input": "heatmaps", "batch": 2, "people": [1, 3], "ring": 2,
         "judged": 2}))
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    return root, bench
