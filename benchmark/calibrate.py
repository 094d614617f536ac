#!/usr/bin/env python3
"""The readings that the limits of a cell's comparison are set from.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 --seconds 3 --out <file.jsonl>

For each of `--seeds`, one run of the cell as `run.py` makes it, with a
short window at the cell's own load, and the numbers its comparison read
(the lower readings). For each of `--control-seeds`, the control: the
plain reference put in the program's place, computed one precision below
the configuration's (TF32 for float32 with TF32 off, fp8 for bf16), on
the same weights and inputs, its answers judged by the same comparison
(the upper readings). One JSON line a seed; the benchmark's own runs never
run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(ROOT),
                    help="the checkout whose BENCHMARK.json names the cell")
    args = ap.parse_args(argv)
    for p in (str(BENCH), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from fvpbench import harness
    from fvpbench.spec import load_cell

    root = Path(args.root)
    cell = load_cell(args.workload, root, root / "benchmark")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    fmt = CONTROL[cell.config["config"]["compute_dtype"]]
    with open(args.out, "a") as out:
        for seed in seeds:
            t = time.perf_counter()
            run, numbers, readings = harness.run_cell(
                cell, seed, args.seconds, False, args.device, t)
            line = {"kind": "program", "workload": cell.name, "seed": seed,
                    "numbers": numbers, "parts": harness.parts(readings),
                    "kept_per_frame": harness.kept_per_frame(run),
                    "answers": len(readings),
                    "metrics": harness.end_to_end(run)}
            print(json.dumps(line), file=out, flush=True)
            print(json.dumps(line), flush=True)
        for seed in controls:
            numbers, readings = harness.control_run(cell, seed, fmt,
                                                    args.device)
            line = {"kind": "control", "format": fmt, "workload": cell.name,
                    "seed": seed, "numbers": numbers,
                    "parts": harness.parts(readings),
                    "answers": len(readings)}
            print(json.dumps(line), file=out, flush=True)
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
