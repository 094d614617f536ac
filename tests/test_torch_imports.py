"""The port imports no JAX: a static scan of fvp_torch/, chip_smoke.py and
the port's CLIs, run/validate_torch.py and run/train_torch.py.

The test process already has jax imported (the interpreter's site setup
imports it), so `sys.modules` cannot show what the port imports; the AST
can. Triton, where used, is imported inside the launching function only:
the CPU test machine has no triton, and every module must import here.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "fvp_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "run" / "validate_torch.py",
    ROOT / "run" / "train_torch.py"]
BANNED = ("jax", "jaxlib", "flax", "optax", "fvp_tpu")


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node, a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node, node.module


def test_port_files_exist():
    assert (ROOT / "chip_smoke.py").exists()
    assert len(FILES) > 10


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text())
    top = set(id(n) for n in tree.body)
    for node, name in _imports(tree):
        root = name.split(".")[0]
        assert root not in BANNED, f"{path}: imports {name}"
        if root == "triton":
            assert id(node) not in top, f"{path}: top-level import triton"
