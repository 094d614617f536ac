"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference imports nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from fvpbench.spec import BENCH_DIR

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "fvp_tpu"}
PROGRAM = "fvp_torch"

SCRIPT = """
import json, sys, tempfile, time
from pathlib import Path
sys.path[:0] = [{tests!r}, {bench!r}, {root!r}]
import torch
torch.set_num_threads(2)
import tiny
from fvpbench import harness
from fvpbench.spec import load_cell
root, bench = tiny.make_tree(Path(tempfile.mkdtemp()))
for name in ("tiny.img", "tiny.hm"):
    cell = load_cell(name, root, bench)
    harness.run_cell(cell, 3, 0.3, True, "cpu", time.perf_counter())
import run as entry
print(json.dumps({{"loaded": sorted({{m.split(".")[0] for m in sys.modules}}),
                  "found": entry.forbidden_modules()}}))
"""


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_reference_imports_no_program():
    files = sorted((BENCH_DIR / "reference").glob("*.py"))
    assert files
    for f in files:
        bad = _imports(f) & (FORBIDDEN | {PROGRAM, "fvpbench"})
        assert not bad, f"{f.name} imports {bad}"


def test_no_file_of_the_benchmark_imports_jax():
    for f in BENCH_DIR.rglob("*.py"):
        assert not _imports(f) & FORBIDDEN, f


def test_tiny_runs_load_no_jax(tmp_path):
    code = SCRIPT.format(tests=str(Path(__file__).parent),
                         bench=str(BENCH_DIR), root=str(BENCH_DIR.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["found"] == []
    assert not set(got["loaded"]) & FORBIDDEN
    assert PROGRAM in got["loaded"]          # the program did run
