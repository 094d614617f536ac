"""The soft_argmax kernel's tiling on the CPU: `softargmax_plan` (blocks a
map, rows a thread, the fixed joint of every loaded float), its refusals,
and a PyTorch emulation of the kernel's split of each map over G blocks,
the rescale of the blocks' exp-sums to the map's max and their
fixed-order sum, against the plain version (csrc/softargmax.cu runs only
on the card)."""

import numpy as np
import pytest
import torch

from fvp_torch.ops.kernels import _build
from fvp_torch.ops.kernels import softargmax as ksa

FLAGSHIP = (3, 10, 4096, 15)


def emulate(planes: torch.Tensor, grid: torch.Tensor, beta: float,
            plan: ksa.SoftArgmaxPlan):
    """The kernel's arithmetic in float32: each block's max of its chunk
    times beta, e = exp(beta x - beta m_block) summed per thread over its 4
    rows and then over the block's threads; the last of a person's blocks
    takes each map's max of its blocks' beta m and adds the G partials
    rescaled by exp(beta m_g - M) in block order; the confidence is the
    mean of 1/Z in (plane, joint) order. Rows past N (the last chunk's
    ragged end) hold -inf, as a thread past N does."""
    S, P, N, J = planes.shape
    G, chunk = plan.ctas_per_map, plan.chunk
    pad = G * chunk - N
    x = torch.cat([planes.float(),
                   torch.full((S, P, pad, J), -np.inf)], dim=2)
    g = torch.cat([grid.float(), torch.zeros(S, pad, 2)], dim=1)
    x = x.reshape(S, P, G, chunk // 4, 4, J)
    g = g.reshape(S, 1, G, chunk // 4, 4, 2)
    mb = x.amax(dim=(3, 4)) * beta                     # (S, P, G, J)
    e = torch.exp(x * beta - mb[:, :, :, None, None])
    # a thread's 4 rows in order, then the block's threads
    z = e.sum(dim=4).sum(dim=3)
    ex = (e * g[..., 0:1]).sum(dim=4).sum(dim=3)
    ey = (e * g[..., 1:2]).sum(dim=4).sum(dim=3)
    M = mb.amax(dim=2)                                 # (S, P, J)
    Z = torch.zeros(S, P, J)
    EX, EY = torch.zeros(S, P, J), torch.zeros(S, P, J)
    for b in range(G):                                 # block order
        f = torch.exp(mb[:, :, b] - M)
        Z = Z + z[:, :, b] * f
        EX = EX + ex[:, :, b] * f
        EY = EY + ey[:, :, b] * f
    coords = torch.stack([EX / Z, EY / Z], dim=-1)
    peak = 1.0 / Z
    confs = torch.zeros(P)
    for s in range(S):
        for j in range(J):
            confs = confs + peak[s, :, j]
    return coords, confs / (S * J)


def _inputs(S, P, N, J, seed, peak_row=None):
    """P2PNet-like maps: small values plus one peak per (map, joint) at a
    random row (or at `peak_row`), and a mm grid."""
    rng = np.random.RandomState(seed)
    planes = rng.randn(S, P, N, J).astype(np.float32) * 0.05
    rows = rng.randint(0, N, size=(S, P, J)) if peak_row is None \
        else np.full((S, P, J), peak_row)
    for s in range(S):
        for p in range(P):
            planes[s, p, rows[s, p], np.arange(J)] += 1.0
    grid = rng.uniform(-1000, 1000, (S, N, 2)).astype(np.float32)
    return torch.from_numpy(planes), torch.from_numpy(grid)


# -- the plan ----------------------------------------------------------------

@pytest.mark.parametrize("J", [15, 17])
def test_joint_order_is_static_and_covers_each_value_once(J):
    """A thread's 4 rows are 4 J contiguous floats, J 16-byte loads: float
    c of load i is (row, joint) = divmod(4 i + c, J), fixed by (i, c), so
    the kernel's unrolled loops index its registers with constants. Every
    (row, joint) of the 4 rows comes once, and each thread's first float
    is joint 0 of a row (its rows start at a multiple of 4, 4 J floats
    into the map)."""
    plan = ksa.softargmax_plan(3, 10, 4096, J)
    assert (plan.rows, plan.loads) == (4, J)
    order = [divmod(4 * i + c, J) for i in range(plan.loads)
             for c in range(4)]
    assert sorted(order) == [(r, j) for r in range(4) for j in range(J)]
    # lcm(4, J) = 4 J: no shorter period, so the pattern of joints over
    # the loads is one and the same for every thread
    assert np.lcm(4, J) == 4 * J
    assert all((4 * t * J) % 4 == 0 and (4 * t * J) % J == 0
               for t in range(plan.threads))


def test_flagship_plan():
    plan = ksa.softargmax_plan(*FLAGSHIP)
    assert (plan.threads, plan.rows, plan.chunk, plan.ctas_per_map,
            plan.ctas, plan.loads, plan.smem) == (128, 4, 512, 8, 240, 15,
                                                  5940)
    assert plan.ctas >= 132                   # the H100's SMs


@pytest.mark.parametrize("S,P,N,J", [(3, 1, 4096, 15), (3, 10, 4096, 17),
                                     (3, 30, 4096, 15), (3, 4, 256, 15),
                                     (3, 2, 1000, 17), (1, 1, 4, 15)])
def test_plan_blocks_cover_each_row_once(S, P, N, J):
    """The G chunks of a map partition its N rows and each block has at
    least one live row: blocks of the kernel's 128 threads, 512 rows."""
    plan = ksa.softargmax_plan(S, P, N, J)
    G, chunk, T = plan.ctas_per_map, plan.chunk, plan.threads
    assert (T, chunk, G) == (128, 512, -(-N // 512))
    assert plan.ctas == S * P * G
    rows = [4 * (g * T + t) + r for g in range(G) for t in range(T)
            for r in range(4)]
    live = [n for n in rows if n < N]
    assert live == list(range(N))
    assert all(4 * g * T < N for g in range(G))


def test_plan_rejects_what_the_kernel_does_not_take():
    for N in (4095, 4094, 2, 0):
        with pytest.raises(ValueError, match="multiple of 4"):
            ksa.softargmax_plan(3, 10, N, 15)
    for J in (14, 16, 1):
        with pytest.raises(ValueError, match="joints"):
            ksa.softargmax_plan(3, 10, 4096, J)
    with pytest.raises(ValueError, match="no room"):
        ksa.softargmax_plan(3, 1, 512 * 300, 17)


def test_launch_arguments_match_the_entry_point(monkeypatch):
    from fvp_torch.ops.kernels import Kernel

    calls = []
    monkeypatch.setattr(Kernel, "__call__",
                        lambda self, *a: calls.append((self.fn, a)))
    monkeypatch.setattr(ksa, "last_block_counters",
                        lambda device, n: torch.zeros(n))
    plan = ksa.softargmax_plan(3, 10, 4096, 15)
    ksa.launch(torch.zeros(3, 10, 4096, 15), torch.zeros(3, 4096, 2), 100.0,
               torch.empty(3, 10, 15, 2), torch.empty(10), plan)
    (fn, args), = calls
    assert fn == "fvp_soft_argmax"
    assert len(args) + 1 == len(_build.SIGNATURES[fn])
    assert args[6:] == (3, 10, 4096, 15, 8, plan.smem, 100.0)
    assert plan.smem == 4 * 3 * 15 * (4 * 8 + 1)


# -- the arithmetic ------------------------------------------------------------

def _assert_matches_plain(planes, grid, plan):
    """Within 1e-5 relative of the plain version: coordinates against the
    grid's scale (mm), confidences against their own."""
    c_ref, p_ref = ksa.soft_argmax_plain(planes, grid, 100.0)
    c, p = emulate(planes, grid, 100.0, plan)
    assert c.shape == c_ref.shape and p.shape == p_ref.shape
    torch.testing.assert_close(c, c_ref, rtol=1e-5,
                               atol=1e-5 * float(grid.abs().max()))
    torch.testing.assert_close(p, p_ref, rtol=1e-5, atol=0)
    assert float(p_ref.min()) > 0.01          # peaked maps, not uniform


@pytest.mark.parametrize("N", [2048, 4096, 8192, 16384])
@pytest.mark.parametrize("P", [1, 10])
def test_emulation_matches_plain(P, N):
    """At G = 4 .. 32 blocks a map of 512 rows (4 rows of 128 threads)."""
    planes, grid = _inputs(3, P, N, 15, seed=P)
    plan = ksa.softargmax_plan(3, P, N, 15)
    assert plan.ctas_per_map == N // 512
    _assert_matches_plain(planes, grid, plan)


@pytest.mark.parametrize("peak_row", [0, 999])
def test_emulation_on_a_ragged_last_chunk(peak_row):
    """N = 1000 rows in chunks of 512: the last block holds 488 live rows
    and the peak sits in the first or the last block's chunk."""
    planes, grid = _inputs(3, 2, 1000, 17, seed=3, peak_row=peak_row)
    plan = ksa.softargmax_plan(3, 2, 1000, 17)
    assert plan.ctas_per_map == 2 and 1000 - plan.chunk == 488
    _assert_matches_plain(planes, grid, plan)
