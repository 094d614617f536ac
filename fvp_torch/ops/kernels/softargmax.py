"""Wrapper of K4 `soft_argmax` (csrc/softargmax.cu); its plain version is
`fvp_torch/ops/softargmax.py::soft_argmax`.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.

The kernel is one launch: each (plane, person) map's N rows are split over
G = ceil(N / 512) blocks of 128 threads, a thread holding 4 consecutive
rows of all J joints in registers; each block writes its max and exp-sums
per joint, and the last of a person's blocks rescales each map's G
partials to the map's max, adds them in block order and takes the
person's confidence. `softargmax_plan` holds the tiling, in Python on
shapes alone, so that the CPU tests can check it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from fvp_torch.ops import softargmax as plain
from fvp_torch.ops.kernels import Kernel, check, last_block_counters, ptr

SOFT_ARGMAX = Kernel("soft_argmax", "fvp_soft_argmax")

soft_argmax_plain = plain.soft_argmax

ROWS = 4                 # consecutive rows a thread holds
THREADS = 128            # csrc/softargmax.cu's kThreads
JOINTS = (15, 17)        # the kernel's instantiations
MAX_SMEM = 232448


class SoftArgmaxPlan(NamedTuple):
    """One launch over (S, P, N, J) maps: each map's N rows in `ctas_per_map`
    chunks of `chunk` = `rows` x `threads` rows (the last may be ragged),
    one block of `threads` threads each, `ctas` blocks in all; a thread
    makes `loads` 16-byte loads (its rows x J floats). `smem` bytes of
    dynamic shared memory hold the last block's S x G partials and S x J
    peaks."""
    S: int
    P: int
    N: int
    J: int
    threads: int
    rows: int
    chunk: int
    ctas_per_map: int
    ctas: int
    loads: int
    smem: int


@functools.lru_cache(maxsize=None)
def softargmax_plan(S: int, P: int, N: int, J: int) -> SoftArgmaxPlan:
    """G = ceil(N / 512) blocks a map of the kernel's fixed 128 threads, 4
    rows a thread (240 blocks for the 132 SMs at the flagship (3, 10,
    4096, 15)). N must be a multiple of 4 and J 15 or 17: anything else
    raises."""
    if N < 4 or N % ROWS:
        raise ValueError(f"softargmax_plan: N = {N}, the kernel takes a "
                         f"positive multiple of {ROWS}")
    if J not in JOINTS:
        raise ValueError(f"softargmax_plan: {J} joints; the kernel is built "
                         f"for {JOINTS}")
    if S < 1 or P < 1:
        raise ValueError(f"softargmax_plan: S = {S}, P = {P} must be >= 1")
    chunk = ROWS * THREADS
    G = -(-N // chunk)
    smem = 4 * S * J * (4 * G + 1)
    if smem > MAX_SMEM:
        raise ValueError(f"softargmax_plan: {G} blocks a map of {N} rows "
                         "leave the last block's partials no room")
    return SoftArgmaxPlan(S, P, N, J, THREADS, ROWS, chunk, G, S * P * G, J,
                          smem)


def soft_argmax(planes: torch.Tensor, center_grid: torch.Tensor,
                beta: float):
    """planes (3, P, N, J), center_grid (3, N, 2) -> (coords (3, P, J, 2),
    confs (P,))."""
    if not planes.is_cuda:
        return soft_argmax_plain(planes, center_grid, beta)
    S, P, N, J = planes.shape
    check(planes, "planes")
    check(center_grid, "center_grid", (S, N, 2), device=planes.device)
    if not beta > 0:
        raise ValueError(f"soft_argmax: beta = {beta}, the kernel takes "
                         "beta > 0")
    for t, name in ((planes, "planes"), (center_grid, "center_grid")):
        if t.data_ptr() % 16:
            raise ValueError(f"soft_argmax: {name} is not 16-byte aligned")
    plan = softargmax_plan(S, max(P, 1), N, J)
    dev = planes.device
    coords = torch.empty((S, P, J, 2), dtype=torch.float32, device=dev)
    confs = torch.empty((P,), dtype=torch.float32, device=dev)
    if P > 0:
        launch(planes, center_grid, beta, coords, confs, plan)
    return coords, confs


def launch(planes: torch.Tensor, center_grid: torch.Tensor, beta: float,
           coords: torch.Tensor, confs: torch.Tensor,
           plan: SoftArgmaxPlan) -> None:
    """One launch of the kernel on checked tensors, with its scratch: the
    blocks' partials (S P G, 4, J)."""
    dev = planes.device
    partial = torch.empty((plan.ctas, 4, plan.J), dtype=torch.float32,
                          device=dev)
    SOFT_ARGMAX(ptr(planes), ptr(center_grid), ptr(partial),
                ptr(last_block_counters(dev, plan.P)), ptr(coords),
                ptr(confs), plan.S, plan.P, plan.N, plan.J, plan.ctas_per_map,
                plan.smem, float(beta))
