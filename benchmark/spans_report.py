#!/usr/bin/env python3
"""Where the card waits, by the program's own spans: one traced run of a
cell.

    python3 benchmark/spans_report.py --workload <cell> --seed <n> \
        --seconds <s>

runs the cell as `run.py --trace 1` does, on the card, and prints one
JSON object: `correct`, the per-layer metrics, the breakdown, and
`report(run)`: the device's idle a batch by the program's innermost span
at each gap (`fvpbench/spans.py::idle_by_leaf`) and each span's host
time a batch.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def report(run) -> dict:
    """The program's spans in `run`'s traced window: idle ms a batch by
    innermost span and host ms a batch by span name."""
    from fvpbench import spans

    calls = max(run.trace.calls, 1)
    host = defaultdict(int)
    for s in spans.window_spans(run) or ():
        host[s.name] += s.end_ns - s.start_ns
    return {
        "calls": run.trace.calls,
        "idle_ms": {k: 1e3 * v / calls for k, v in sorted(
            spans.idle_by_leaf(run).items(), key=lambda kv: -kv[1])},
        "host_ms": {k: 1e-6 * v / calls for k, v in host.items()},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(BENCH))
    import run as bench_run
    bench_run.environment()

    import torch

    from fvpbench import harness
    from fvpbench.spec import load_cell
    if not torch.cuda.is_available():
        print("spans_report: no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload, ROOT)
    run, numbers, _ = harness.run_cell(cell, args.seed, args.seconds, True,
                                       "cuda", T_START)
    correct, _ = harness.judge.verdict(numbers, cell.limits)
    out = {"workload": cell.name, "seed": args.seed, "correct": correct,
           "device": torch.cuda.get_device_name(0),
           "metrics": {k: v["value"]
                       for k, v in harness.per_layer(run).items()},
           "breakdown": harness.breakdown(run.trace),
           "report": report(run)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
