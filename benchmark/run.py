#!/usr/bin/env python3
"""The benchmark of fvp_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`, `benchmark/`
and `fvp_torch/`, on a machine with as many CUDA cards as the cell asks
for. It makes its weights and inputs from `--seed`, warms up, measures a
closed loop of `Predictor` calls for `--seconds`, judges the answers
against the plain reference in `benchmark/reference/` and prints, as the
last line of its standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics), `device`, with `--trace 1` a
`breakdown`, and last `checks`, each compared number beside its limit
(also the last lines of its standard error). It exits non-zero, with no
result, without the cards, without the program, or when the JAX package
or JAX itself was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "fvp_tpu")


def err(*a):
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def environment() -> None:
    """Build, kernel and bytecode caches at fixed paths inside the
    checkout; no library is to load JAX on its own."""
    cache = ROOT / "build" / "bench_cache"
    # Python's bytecode too: where the environment forbids writing it
    # beside the sources (PYTHONDONTWRITEBYTECODE), every run would compile
    # torch's two thousand modules again, most of a run's set-up.
    sys.pycache_prefix = str(cache / "pycache")
    sys.dont_write_bytecode = False
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(BENCH), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()

    from fvpbench.spec import load_cell
    cell = load_cell(args.workload, ROOT)
    import torch
    if not torch.cuda.is_available():
        err("benchmark: no CUDA device")
        return 2
    if torch.cuda.device_count() < cell.chips:
        err(f"benchmark: {cell.name} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} here")
        return 2
    if not (ROOT / "fvp_torch").is_dir():
        err(f"benchmark: no fvp_torch/ beside {BENCH}")
        return 2
    from fvpbench import harness

    run, numbers, readings = harness.run_cell(
        cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    correct, checks = harness.judge.verdict(numbers, cell.limits)
    if args.trace:
        metrics = harness.per_layer(run)
    else:
        metrics = harness.end_to_end(run)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": 1, "memory_peak_bytes": int(run.memory_peak_bytes)}
    result = {"correct": correct, "attempted": run.frames, "failed": 0,
              "metrics": metrics, "device": device}
    if run.trace is not None:
        device["busy_s"] = run.trace.busy_s()
        device["window_s"] = run.trace.window_s
        result["breakdown"] = harness.breakdown(run.trace)
    result["checks"] = checks

    bad = forbidden_modules()
    if bad:
        err(f"benchmark: loaded {bad}; the benchmark loads neither JAX nor "
            "the JAX package")
        return 3
    err(harness.summary(run))
    for note in run.notes:
        err(f"note: {note}")
    err("worst HDN parts: " + json.dumps(harness.parts(readings)))
    for k, v in checks.items():
        err(f"check {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
