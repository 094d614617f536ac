"""Wrapper of K5 `weightnet_pool` (csrc/weightnet.cu), with its plain
version.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. `packed` comes from engine/packing.py::pack_weightnet.

The kernel runs one block per (map n, band of `rows` map rows): it reads
the band's rows of all joints (of a chunk of joints where that would not
fit) with coalesced loads, transposes them into
joint-major tiles in shared memory, and each thread convolves one joint's
pooled cells for a group of 4 channels held in registers. The band sums go
to a scratch tensor and the last block of each n adds them in band order,
so the mean is taken in a fixed order. `weightnet_plan` picks the band, in
Python on shapes alone, so that the CPU tests can check it.

`weightnet_pool_bf16` is the bf16 route that `compute_dtype='bfloat16'`
takes: the TPU kernel's own arithmetic (planes and conv weights rounded
to bf16, float32 sums, the float32 affine and ReLU rounded to bf16, the
2x2 max in bf16, the mean in float32), on mma.sync in
`fvp_weightnet_pool_bf16` (csrc/weightnet.cu): one block per (n, band of
rows), its band read with coalesced loads into joint-major bf16 tiles,
one warp per joint, the band sums combined in band order as in the
float32 kernel; `weightnet_bf16_plan` picks the band. Its `packed` comes
from engine/packing.py::pack_weightnet_bf16.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from fvp_torch.ops.kernels import Kernel, check, last_block_counters, ptr

WEIGHTNET_POOL = Kernel("weightnet_pool", "fvp_weightnet_pool")
WEIGHTNET_POOL_BF16 = Kernel("weightnet_pool_bf16", "fvp_weightnet_pool_bf16")

C = 32                   # WeightNet's conv channels
GROUP = 4                # channels a thread holds
MAX_REPS = 4             # threads that share a (joint, group)
MAX_THREADS = 512        # the kernel's launch bound
H100_SMS = 132
MAX_SMEM = 232448


class WeightNetPlan(NamedTuple):
    """One launch over (N, A, B, J) planes: `bands` bands of `rows` map
    rows per n (the last may be shorter), each in chunks of `joints` joints
    (J unless a band of all joints would not fit), N x bands x chunks
    blocks of `threads` = joints x (C / group) x `reps` threads, each
    joint's tile `plane` floats of (rows + 2) x (B + 2), `smem` bytes of
    shared memory."""
    N: int
    A: int
    B: int
    J: int
    rows: int
    bands: int
    joints: int
    group: int
    reps: int
    threads: int
    plane: int
    smem: int

    @property
    def chunks(self) -> int:
        return -(-self.J // self.joints)

    @property
    def blocks(self) -> int:
        return self.N * self.bands * self.chunks


def _smem(rows: int, B: int, joints: int, threads: int) -> int:
    return 4 * (joints * (rows + 2) * (B + 2) + threads * GROUP)


def _fits(rows: int, B: int, joints: int, threads: int) -> bool:
    return (_smem(rows, B, joints, threads) <= MAX_SMEM
            and (rows + 2) * (B * joints) ** 2 < 2 ** 32)


@functools.lru_cache(maxsize=None)
def weightnet_plan(N: int, A: int, B: int, J: int,
                   rows: int | None = None) -> WeightNetPlan:
    """The band height: the even `rows` (unless given) that minimises the
    busiest SM's rows, (rows + 2) per block (its halo) times the blocks it
    runs when the blocks spread over the 132 SMs; ties go to fewer rows.
    All J joints in a block where a band of 2 rows fits (and J <= 96),
    else the fewest chunks of joints that do. Any even A and B, any J."""
    if A < 2 or B < 2 or A % 2 or B % 2 or N < 1 or J < 1:
        raise ValueError(f"weightnet_plan: A = {A}, B = {B} must be even, "
                         f"N = {N} and J = {J} >= 1")
    groups = C // GROUP
    chunks = -(-J // (MAX_THREADS // groups))
    while True:
        joints = -(-J // chunks)
        reps = min(MAX_REPS, MAX_THREADS // (joints * groups))
        threads = joints * groups * reps
        if _fits(2, B, joints, threads) or joints == 1:
            break
        chunks += 1
    fits = [r for r in range(2, A + 1, 2) if _fits(r, B, joints, threads)]
    if rows is None:
        if not fits:
            raise ValueError(f"weightnet_plan: no band of a {A} x {B} map "
                             f"fits in shared memory")
        rows = min(fits, key=lambda r: (
            math.ceil(N * chunks * math.ceil(A / r) / H100_SMS) * (r + 2),
            r))
    elif rows not in fits:
        raise ValueError(f"weightnet_plan: rows = {rows} (even, its tile in "
                         f"shared memory)")
    return WeightNetPlan(N, A, B, J, rows, math.ceil(A / rows), joints,
                         GROUP, reps, threads, (rows + 2) * (B + 2),
                         _smem(rows, B, joints, threads))


def weightnet_pool_plain(planes: torch.Tensor, packed: dict) -> torch.Tensor:
    """(N, A, B, J) -> (N, J, C): mean over the pooled map of
    relu(maxpool2(a * conv3x3(x) + b)) per (n, j), on any device."""
    n, a, b, j = planes.shape
    w = packed["w"]                                  # (9, C)
    C = w.shape[1]
    x = planes.permute(0, 3, 1, 2).reshape(n * j, 1, a, b)
    h = F.conv2d(x, w.t().reshape(C, 1, 3, 3), padding=1)
    h = h * packed["scale"][:, None, None] + packed["shift"][:, None, None]
    h = torch.relu(F.max_pool2d(h, 2, 2))
    return h.mean(dim=(2, 3)).reshape(n, j, C)


def weightnet_pool(planes: torch.Tensor, packed: dict) -> torch.Tensor:
    """WeightNet's conv front end: (N, A, B, J) plane heatmaps -> (N, J, C)
    pooled features."""
    if not planes.is_cuda:
        return weightnet_pool_plain(planes, packed)
    N, A, B, J = planes.shape
    w = packed["w"]
    C = w.shape[1]
    if C != 32 or A % 2 or B % 2:
        raise ValueError(f"weightnet_pool: takes C == 32 and even maps, got "
                         f"C={C}, {A}x{B}")
    check(planes, "planes")
    check(w, "w", (9, C), device=planes.device)
    check(packed["scale"], "scale", (C,), device=planes.device)
    check(packed["shift"], "shift", (C,), device=planes.device)
    out = torch.empty((N, J, C), dtype=torch.float32, device=planes.device)
    if N == 0:
        return out
    launch(planes, packed, out, weightnet_plan(N, A, B, J))
    return out


def launch(planes: torch.Tensor, packed: dict, out: torch.Tensor,
           plan: WeightNetPlan) -> None:
    """One launch of the kernel on checked tensors, with its band scratch
    (N, bands, J, C)."""
    N, A, B, J = plan.N, plan.A, plan.B, plan.J
    partial = torch.empty((N, plan.bands, J, C), dtype=torch.float32,
                          device=planes.device)
    WEIGHTNET_POOL(ptr(planes), ptr(packed["w"]), ptr(packed["scale"]),
                   ptr(packed["shift"]), ptr(partial),
                   ptr(last_block_counters(planes.device, N)), ptr(out),
                   N, A, B, J, C, plan.rows, plan.bands, plan.joints,
                   plan.reps, plan.plane, plan.smem)


# -- the bf16 route ------------------------------------------------------------

MAX_WARPS_BF16 = 16      # the bf16 kernel's launch bound, 512 threads


class WeightNetBf16Plan(NamedTuple):
    """One launch of the bf16 kernel over (N, A, B, J) planes: `bands`
    bands of `rows` map rows per n (the last may be shorter), each in
    chunks of `joints` joints (J unless a band of all joints would not
    fit), N x bands x chunks blocks of `warps` warps (each warp takes the
    chunk's joints w, w + warps, ...), each joint's bf16 tile `plane`
    elements of (rows + 2) x (B + 2), `smem` bytes of shared memory."""
    N: int
    A: int
    B: int
    J: int
    rows: int
    bands: int
    joints: int
    warps: int
    plane: int
    smem: int

    @property
    def chunks(self) -> int:
        return -(-self.J // self.joints)

    @property
    def blocks(self) -> int:
        return self.N * self.bands * self.chunks


def _bf16_fits(rows: int, B: int, joints: int) -> bool:
    return (2 * joints * (rows + 2) * (B + 2) <= MAX_SMEM
            and (rows + 2) * (B * joints) ** 2 < 2 ** 32)


def _bf16_warps(joints: int) -> int:
    """As many warps as joints, at most 16, each with the same number of
    joints."""
    return -(-joints // -(-joints // MAX_WARPS_BF16))


@functools.lru_cache(maxsize=None)
def weightnet_bf16_plan(N: int, A: int, B: int, J: int,
                        rows: int | None = None,
                        joints: int | None = None) -> WeightNetBf16Plan:
    """The bf16 kernel's bands: all J joints in a block where a band of 2
    rows fits, else the fewest chunks of joints that do (unless `joints`
    is given); then the even `rows` (unless given) that minimises the
    busiest SM's rows, (rows + 2) per block (its halo) times the blocks it
    runs when the blocks spread over the 132 SMs, as weightnet_plan does;
    ties go to fewer rows (fewer, larger blocks timed faster on the H100:
    PERF.md §6). Any even A and B, any J."""
    if A < 2 or B < 2 or A % 2 or B % 2 or N < 1 or J < 1:
        raise ValueError(f"weightnet_bf16_plan: A = {A}, B = {B} must be "
                         f"even, N = {N} and J = {J} >= 1")
    if joints is None:
        chunks = 1
        while not _bf16_fits(2, B, -(-J // chunks)) and -(-J // chunks) > 1:
            chunks += 1
        joints = -(-J // chunks)
    elif not 1 <= joints <= J:
        raise ValueError(f"weightnet_bf16_plan: joints = {joints} of {J}")
    chunks = -(-J // joints)
    fits = [r for r in range(2, A + 1, 2) if _bf16_fits(r, B, joints)]
    if rows is None:
        if not fits:
            raise ValueError(f"weightnet_bf16_plan: no band of a {A} x {B} "
                             f"map fits in shared memory")

        rows = min(fits, key=lambda r: (
            math.ceil(N * chunks * math.ceil(A / r) / H100_SMS) * (r + 2),
            r))
    elif rows not in fits:
        raise ValueError(f"weightnet_bf16_plan: rows = {rows} (even, its "
                         f"tile in shared memory)")
    plane = (rows + 2) * (B + 2)
    return WeightNetBf16Plan(N, A, B, J, rows, math.ceil(A / rows), joints,
                             _bf16_warps(joints), plane, 2 * joints * plane)


def weightnet_pool_bf16_plain(planes: torch.Tensor,
                              packed: dict) -> torch.Tensor:
    """(N, A, B, J) -> (N, J, C) as the TPU kernel computes it
    (fvp_tpu/ops/pallas/weightnet.py::_weightnet_kernel): bf16 planes and
    taps, float32 sums, relu(scale * h + shift) rounded to bf16, the 2x2
    max (exact on the rounded values), the mean in float32; any device."""
    n, a, b, j = planes.shape
    w, aff = packed["w"], packed["aff"]              # (16, C) bf16, (2, C)
    C = w.shape[1]
    x = planes.to(torch.bfloat16).float().permute(0, 3, 1, 2) \
        .reshape(n * j, 1, a, b)
    h = F.conv2d(x, w[:9].float().t().reshape(C, 1, 3, 3), padding=1)
    h = torch.relu(h * aff[0][:, None, None] + aff[1][:, None, None])
    h = F.max_pool2d(h.to(torch.bfloat16).float(), 2, 2)
    return h.mean(dim=(2, 3)).reshape(n, j, C)


def weightnet_pool_bf16(planes: torch.Tensor, packed: dict) -> torch.Tensor:
    """The bf16 route of WeightNet's conv front end: (N, A, B, J) float32
    plane heatmaps -> (N, J, C) float32 pooled features; the kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    if not planes.is_cuda:
        return weightnet_pool_bf16_plain(planes, packed)
    N, A, B, J = planes.shape
    w, aff = packed["w"], packed["aff"]
    C = w.shape[1]
    if C != 32 or A % 2 or B % 2:
        raise ValueError(f"weightnet_pool_bf16: takes C == 32 and even "
                         f"maps, got C={C}, {A}x{B}")
    check(planes, "planes")
    check(w, "w", (16, C), dtype=torch.bfloat16, device=planes.device)
    check(aff, "aff", (2, C), device=planes.device)
    out = torch.empty((N, J, C), dtype=torch.float32, device=planes.device)
    if N == 0:
        return out
    launch_bf16(planes, packed, out, weightnet_bf16_plan(N, A, B, J))
    return out


def launch_bf16(planes: torch.Tensor, packed: dict, out: torch.Tensor,
                plan: WeightNetBf16Plan) -> None:
    """One launch of the bf16 kernel on checked tensors, with its band
    scratch (N, bands, J, C)."""
    N, A, B, J = plan.N, plan.A, plan.B, plan.J
    partial = torch.empty((N, plan.bands, J, C), dtype=torch.float32,
                          device=planes.device)
    WEIGHTNET_POOL_BF16(ptr(planes), ptr(packed["w"]), ptr(packed["aff"]),
                        ptr(partial),
                        ptr(last_block_counters(planes.device, N)), ptr(out),
                        N, A, B, J, C, plan.rows, plan.bands, plan.joints,
                        plan.warps, plan.plane, plan.smem)
