"""The control, the plain reference one precision below the
configuration's put in the program's place, comes out not correct: TF32
against a float32 cell, fp8 against a bf16 cell. On the CPU at tiny
sizes; on the card at the cells' own sizes."""

import json

import pytest

import tiny
from fvpbench import harness
from fvpbench.spec import BENCH_DIR, load_cell

CONTROL = {"float32": "tf32", "bfloat16": "fp8"}
CELLS = [w["name"] for w in json.loads(
    (BENCH_DIR.parent / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny.make_tree(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("name", ["tiny.hm", "tiny.img"])
@pytest.mark.parametrize("seed", [5, 2 ** 31 + 3])
def test_control_fails_tiny(tree, name, seed):
    cell = load_cell(name, *tree)
    fmt = CONTROL[cell.config["config"]["compute_dtype"]]
    numbers, _ = harness.control_run(cell, seed, fmt, "cpu")
    correct, checks = harness.judge.verdict(numbers, cell.limits)
    assert not correct, checks


def test_reference_in_float32_passes_tiny(tree):
    """The same path with the reference at float32 in the program's place
    passes: what fails the control is its precision."""
    cell = load_cell("tiny.hm", *tree)
    numbers, _ = harness.control_run(cell, 5, "fp32", "cpu")
    assert harness.judge.verdict(numbers, cell.limits)[0], numbers


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_card(card, name):
    cell = load_cell(name, BENCH_DIR.parent)
    fmt = CONTROL[cell.config["config"]["compute_dtype"]]
    numbers, _ = harness.control_run(cell, 11, fmt, card)
    correct, checks = harness.judge.verdict(numbers, cell.limits)
    assert not correct, checks
