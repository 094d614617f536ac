"""The premises of the weightnet_pool kernel's design (csrc/weightnet.cu),
checked on the CPU with its Python plan (ops/kernels/weightnet.py::
weightnet_plan):

- the plan takes every even A x B and any J, fits a block's shared
  memory, and its bands cover each map row once and its chunks of joints
  each joint once;
- the threads of the blocks, split as the kernel splits them (joint,
  channel group, rep), cover every (joint, channel, pooled cell) of a band
  once;
- a PyTorch emulation of the kernel (the band's tile with its halo, each
  thread's cells in its order, the affine after the 2x2 max on taps and
  scale negated where the scale is negative, the reps and then the bands
  summed in a fixed order) reproduces weightnet_pool_plain at the card
  test's tolerance and the reference package's pallas_weightnet_pool in
  interpret mode at tests/test_torch_nets.py's, with an odd band count
  among the shapes;
- the affine after the max is exact: bit for bit the max of the affine
  outputs, negative scales included.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fvp_torch.engine.packing import pack_model
from fvp_torch.ops.kernels import _build
from fvp_torch.ops.kernels import weightnet as kw
from fvp_tpu.ops.pallas.weightnet import pallas_weightnet_pool
from tests.test_torch_nets import BF16, _close, nets  # noqa: F401

SHAPES = [(30, 64, 64, 15, None), (4, 64, 64, 17, None),
          (2, 40, 24, 15, 16), (6, 16, 16, 15, 6), (3, 10, 6, 2, None),
          (1, 6, 258, 100, None)]


def _packed(seed=0, negative=False):
    """Seeded weights; `negative`: every third channel's scale below 0."""
    rng = np.random.RandomState(seed)
    scale = 1 + 0.1 * rng.randn(32)
    if negative:
        scale[::3] *= -1
    return {"w": torch.from_numpy(rng.normal(0, 0.3, (9, 32))
                                  .astype(np.float32)),
            "scale": torch.from_numpy(scale.astype(np.float32)),
            "shift": torch.from_numpy((0.1 * rng.randn(32))
                                      .astype(np.float32))}


def _thread(plan, t):
    """(joint, channel group, rep) of thread t, as the kernel splits."""
    groups = kw.C // plan.group
    return (t // (groups * plan.reps), t % groups,
            (t // groups) % plan.reps)


def emulate(plan, planes, packed, kernel_order=True):
    """The kernel on the CPU: (N, A, B, J) -> (N, J, C). With
    `kernel_order`, the kernel's pooled cell: taps and scale negated where
    the scale is negative, the max of the four conv outputs, then
    fl(fl(m s) + b); else the plain version's max of the four affine
    outputs."""
    N, A, B, J = planes.shape
    w, sc, sh = packed["w"], packed["scale"], packed["shift"]
    if kernel_order:
        w, sc = w * torch.where(sc < 0, -1.0, 1.0), sc.abs()
    Bq = B // 2
    out = torch.zeros(N, J, kw.C)
    for n in range(N):
        parts = []
        for band in range(plan.bands):
            y0 = band * plan.rows
            bh = min(plan.rows, A - y0)
            # the tile: map rows y0 - 1 .. y0 + bh, zero outside, (J, r, x)
            tile = torch.zeros(J, bh + 2, B + 2)
            lo, hi = max(y0 - 1, 0), min(y0 + bh + 1, A)
            tile[:, lo - (y0 - 1):hi - (y0 - 1), 1:B + 1] = \
                planes[n, lo:hi].permute(2, 0, 1)
            # every pooled cell's four conv outputs, taps in order
            m = None
            for dy in range(2):
                for dx in range(2):
                    a = torch.zeros(J, bh // 2, Bq, kw.C)
                    for t in range(9):
                        ky, kx = divmod(t, 3)
                        p = tile[:, dy + ky:dy + ky + bh:2,
                                 dx + kx:dx + kx + B:2]
                        a = a + p[..., None] * w[t]
                    v = a if kernel_order else a * sc + sh
                    m = v if m is None else torch.maximum(m, v)
            if kernel_order:
                m = m * sc + sh
            val = torch.relu(m).reshape(J, -1, kw.C)   # cells in order
            cells = val.shape[1]
            # rep r sums cells r, r + reps, ... in order; then the reps
            pad = -cells % plan.reps
            val = torch.cat([val, torch.zeros(J, pad, kw.C)], 1)
            val = val.reshape(J, -1, plan.reps, kw.C)
            s = torch.zeros(J, plan.reps, kw.C)
            for i in range(val.shape[1]):
                s = s + val[:, i]
            part = s[:, 0]
            for r in range(1, plan.reps):
                part = part + s[:, r]
            parts.append(part)
        tot = parts[0]
        for p in parts[1:]:
            tot = tot + p
        out[n] = tot / float((A // 2) * Bq)
    return out


# -- the plan ------------------------------------------------------------------

@pytest.mark.parametrize("J", [1, 2, 15, 17, 33, 96, 100, 500])
@pytest.mark.parametrize("A,B", [(2, 2), (4, 10), (64, 64), (40, 24),
                                 (66, 130), (256, 256)])
def test_plan_takes_every_even_map(A, B, J):
    plan = kw.weightnet_plan(3, A, B, J)
    assert plan.rows % 2 == 0 and 2 <= plan.rows <= A
    assert (plan.bands - 1) * plan.rows < A <= plan.bands * plan.rows
    assert plan.smem <= kw.MAX_SMEM
    assert plan.threads == plan.joints * (kw.C // plan.group) * plan.reps
    assert plan.threads <= kw.MAX_THREADS and plan.reps >= 1
    assert plan.plane >= (plan.rows + 2) * (B + 2) and plan.plane % 2 == 0
    assert plan.smem >= 4 * (plan.joints * plan.plane
                             + plan.threads * plan.group)
    assert (plan.rows + 2) * (B * plan.joints) ** 2 < 2 ** 32
    # the chunks cover the joints, as few as fit (all of them at once where
    # a band of all joints fits)
    assert (plan.chunks - 1) * plan.joints < J <= plan.chunks * plan.joints
    groups = kw.C // kw.GROUP
    if J <= kw.MAX_THREADS // groups and kw._fits(
            2, B, J, J * groups * min(kw.MAX_REPS,
                                      kw.MAX_THREADS // (J * groups))):
        assert plan.joints == J


def test_plan_rejects_odd_maps_and_too_many_joints():
    for args in [(1, 63, 64, 15), (1, 64, 7, 15), (1, 64, 64, 0)]:
        with pytest.raises(ValueError):
            kw.weightnet_plan(*args)
    with pytest.raises(ValueError):
        kw.weightnet_plan(1, 64, 64, 15, 5)


@pytest.mark.parametrize("shape", SHAPES)
def test_threads_cover_every_cell_once(shape):
    N, A, B, J, rows = shape
    plan = kw.weightnet_plan(N, A, B, J, rows)
    for band in range(plan.bands):
        bh = min(plan.rows, A - band * plan.rows)
        cells = (bh // 2) * (B // 2)
        seen = np.zeros((J, kw.C, cells), np.int64)
        for jb in range(plan.chunks):
            j0 = jb * plan.joints
            for t in range(plan.threads):
                j, g, rep = _thread(plan, t)
                if j0 + j < min(J, j0 + plan.joints):
                    ch = slice(g * plan.group, (g + 1) * plan.group)
                    seen[j0 + j, ch, rep:cells:plan.reps] += 1
        assert (seen == 1).all()


def test_flagship_plan():
    """(30, 64, 64, 15): four bands of 16 rows, 120 blocks of 480 threads
    (about one per SM), 77 KB of tiles."""
    plan = kw.weightnet_plan(30, 64, 64, 15)
    assert (plan.rows, plan.bands, plan.blocks, plan.threads) == \
        (16, 4, 120, 480)
    assert 70_000 < plan.smem < 80_000


def test_launch_arguments_match_the_entry_point(monkeypatch):
    from fvp_torch.ops.kernels import Kernel

    calls = []
    monkeypatch.setattr(Kernel, "__call__",
                        lambda self, *a: calls.append((self.fn, a)))
    monkeypatch.setattr(kw, "last_block_counters",
                        lambda device, n: torch.zeros(n))
    plan = kw.weightnet_plan(2, 40, 24, 15, 16)
    kw.launch(torch.zeros(2, 40, 24, 15), _packed(), torch.empty(2, 15, 32),
              plan)
    (fn, args), = calls
    assert fn == "fvp_weightnet_pool"
    assert len(args) + 1 == len(_build.SIGNATURES[fn])
    assert args[7:] == (2, 40, 24, 15, 32, 16, 3, 15, plan.reps, plan.plane,
                        plan.smem)


# -- the arithmetic ------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
def test_emulation_matches_plain(shape):
    """At the card test's tolerance (rtol = atol = 1e-5)."""
    N, A, B, J, rows = shape
    planes = torch.from_numpy(np.random.RandomState(A).randn(N, A, B, J)
                              .astype(np.float32))
    packed = _packed(J)
    plan = kw.weightnet_plan(N, A, B, J, rows)
    ref = kw.weightnet_pool_plain(planes, packed)
    got = emulate(plan, planes, packed)
    assert got.shape == ref.shape and float(ref.abs().max()) > 0
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_affine_after_the_max_is_exact(shape):
    """The kernel's order (negated taps and scale where the scale is
    negative, the max, then the affine) gives the plain order's bits, on
    the emulation's conv outputs and on conv outputs with many equal and
    near-equal values."""
    N, A, B, J, rows = shape
    planes = torch.from_numpy(np.random.RandomState(A + 1).randn(N, A, B, J)
                              .astype(np.float32))
    packed = _packed(J, negative=True)
    assert (packed["scale"] < 0).any() and (packed["scale"] > 0).any()
    plan = kw.weightnet_plan(N, A, B, J, rows)
    assert torch.equal(emulate(plan, planes, packed),
                       emulate(plan, planes, packed, kernel_order=False))
    rng = np.random.RandomState(J)
    a = torch.from_numpy((rng.randn(4, 4096, 32) * 10.0 ** rng.randint(
        -6, 4, (4, 4096, 32))).astype(np.float32))
    a[1, ::7] = a[0, ::7]                      # ties
    a[2, ::5] = torch.nextafter(a[0, ::5], torch.tensor(np.inf))
    sc, sh = packed["scale"], packed["shift"]
    plain = (a * sc + sh).amax(0)
    neg = torch.where(sc < 0, -1.0, 1.0)
    assert torch.equal((a * neg).amax(0) * sc.abs() + sh, plain)


def test_emulation_matches_pallas(rng, nets):  # noqa: F811
    """tests/test_torch_nets.py's harness: pallas_weightnet_pool in
    interpret mode (bf16 matmuls inside) on the reference's variables, the
    emulation on the port's packed weights, three bands of 6 rows."""
    cfg, variables, model = nets
    planes = rng.randn(4, 16, 16, 15).astype(np.float32)
    p, s = variables["params"]["weight_net"], \
        variables["batch_stats"]["weight_net"]
    a = p["BatchNorm_0"]["scale"] / np.sqrt(s["BatchNorm_0"]["var"] + 1e-5)
    aff = np.stack([a, p["BatchNorm_0"]["bias"]
                    - s["BatchNorm_0"]["mean"] * a]).astype(np.float32)
    ref = pallas_weightnet_pool(planes, np.asarray(p["Conv_0"]["kernel"]),
                                np.asarray(p["Conv_0"]["bias"]), aff,
                                interpret=True)
    plan = kw.weightnet_plan(4, 16, 16, 15, 6)
    assert plan.bands == 3
    got = emulate(plan, torch.from_numpy(planes),
                  pack_model(model)["weight_net"])
    assert got.shape == ref.shape
    _close(got, ref, BF16)


def test_plain_matches_conv2d_reference():
    """The plain version is the kernel's function: conv, affine, 2x2 max,
    ReLU, mean, here through unfold as a second derivation."""
    planes = torch.from_numpy(np.random.RandomState(3).randn(2, 8, 6, 3)
                              .astype(np.float32))
    packed = _packed(1)
    x = planes.permute(0, 3, 1, 2).reshape(6, 1, 8, 6)
    cols = F.unfold(x, 3, padding=1)                     # (6, 9, 48)
    h = torch.einsum("btp,tc->bcp", cols, packed["w"]).reshape(6, 32, 8, 6)
    h = h * packed["scale"][:, None, None] + packed["shift"][:, None, None]
    ref = torch.relu(F.max_pool2d(h, 2)).mean((2, 3)).reshape(2, 3, 32)
    torch.testing.assert_close(kw.weightnet_pool_plain(planes, packed), ref,
                               rtol=1e-5, atol=1e-6)
