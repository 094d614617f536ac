"""The benchmark's own tests: `python -m pytest benchmark/tests`. They run
the harness on the CPU at tiny sizes; tests marked `cuda` need a card."""

import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

# Few threads, as a run loads the host from one process with few: on a
# shared machine torch's one thread a core makes a tiny CPU call take
# seconds, and a short test window then reaches only part of the ring.
torch.set_num_threads(2)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skipped without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
