"""The premises of the C2CNet kernel's design (csrc/c2cnet.cu), checked on
the CPU with its Python plan (ops/kernels/c2cnet.py::c2cnet_plan):

- the plan fits a block's shared memory, its ring slots and bulk copies
  are 16-byte aligned, its buffers do not overlap, no phase writes a
  buffer it reads, and tall columns take a ring of one slot;
- each phase's items, walked as the kernel walks them, cover every (row
  tile, column tile) exactly once, and the CTAs cover every column once;
- the kernel's phase table has the fields of the kernel's enum, in order;
- the fragment-ordered weights of pack_c2cnet unpack to the flat buffers;
- the kernel's CPU emulation (ops/kernels/c2cnet.py::emulate, which sums
  in the kernel's order) reproduces c2cnet_plain and the reference
  package's pallas_c2cnet in interpret mode, at the tolerance of
  tests/test_torch_fuse_p2p.py, up to the eval batch's widths (B = 8:
  Shelf's 80 columns and Campus's 40 at J = 17).

The emulation is part of the port (it imports nothing of JAX), so that the
card test (tests/test_torch_kernels_cuda.py) and chip_smoke.py can hold
the kernel against it.
"""

import functools
import re

import numpy as np
import pytest
import torch

from fvp_torch.engine.packing import pack_c2cnet
from fvp_torch.models.cnns import C2CNet
from fvp_torch.ops.kernels import _build
from fvp_torch.ops.kernels import c2cnet as kc

SHAPES = [(10, 20, 15), (13, 8, 15), (7, 12, 17), (40, 20, 15), (1, 4, 1)]
DEPTHS = [None, 1, 2]
_BF = torch.bfloat16


def _net(J, seed=0):
    """A port C2CNet with numpy-seeded weights: convs N(0, 0.1), BN
    affines and running stats shifted by up to 0.05 (var from 1)."""
    net = C2CNet(J).eval()
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for k, v in net.state_dict().items():
            if k.endswith("num_batches_tracked"):
                continue
            if v.dim() >= 2:
                a = rng.normal(0.0, 0.1, v.shape)
            else:
                one = k.endswith("running_var") or k.endswith(".weight")
                a = float(one) + 0.05 * rng.rand(*v.shape)
            v.copy_(torch.from_numpy(np.asarray(a, np.float32)))
    return net


# -- the kernel's walk ---------------------------------------------------------

def _items(ph, M):
    """(m tile, column tile group) of a CTA, as the kernel walks them
    (gemm_phase): groups of ITEM_TILES n8 tiles."""
    per_mt = -(-(ph["ncols"] // 8) // kc.ITEM_TILES)
    return [(mt, p) for mt in range((M + 15) // 16) for p in range(per_mt)]


# -- the plan ------------------------------------------------------------------

@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plan_fits_and_is_aligned(shape, depth):
    plan = kc.c2cnet_plan(*shape, depth)
    assert plan.depth == (depth or 2)
    assert plan.smem + kc.STATIC_SMEM <= kc.MAX_SMEM
    assert plan.slot_bytes % 128 == 0 and plan.bar_off % 8 == 0
    assert plan.bar_off == plan.depth * plan.slot_bytes
    regions = sorted(plan.buffers, key=lambda b: b[1][0])
    end = plan.bar_off + 8 * plan.depth
    for _, (off, size) in regions:      # disjoint, in order, 16-aligned
        assert off % 16 == 0 and off >= end and size % 16 == 0
        end = off + size
    assert end == plan.smem
    assert plan.x_off == dict(plan.buffers)["X"][0]
    for ph in kc.phase_dicts(plan)[:-1]:
        assert ph["fo"] & (ph["fo"] - 1) == 0     # the kernel shifts by F
        w, pw = kc.phase_weight_bytes(ph)
        assert w > 0 and w % 16 == 0 and pw % 16 == 0
        assert w + pw < kc.phase_slot_bytes(ph) <= plan.slot_bytes
        for key in ("aff_off", "paff_off"):        # the affines' copies
            assert (4 * ph[key]) % 16 == 0 and (8 * ph["fo"]) % 16 == 0
        assert ph["w_off"] % 16 == 0 and ph["pw_off"] % 16 == 0
        assert w + pw < 2 ** 20                    # an mbarrier's tx count
    # the CTAs cover the columns once; a CTA would not fit more
    assert (plan.ctas - 1) * plan.cols < shape[0] <= plan.ctas * plan.cols


def test_tall_columns_take_one_slot():
    """A ring of two ~99 KB slots leaves room for columns up to Z = 52 at
    J = 15; taller ones take one slot, up to the limit of one column."""
    assert kc.c2cnet_plan(2, 52, 15).depth == 2
    for shape in [(2, 56, 15), (3, 96, 15), (1, 220, 15)]:
        plan = kc.c2cnet_plan(*shape)
        assert plan.depth == 1 and plan.smem + kc.STATIC_SMEM <= kc.MAX_SMEM
    with pytest.raises(ValueError):
        kc.c2cnet_plan(2, 56, 15, 2)
    with pytest.raises(ValueError):
        kc.c2cnet_plan(1, 400, 15)
    for bad in [(1, 10, 15), (0, 8, 15), (1, 8, 0)]:
        with pytest.raises(ValueError):
            kc.c2cnet_plan(*bad)


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("shape", SHAPES)
def test_items_cover_every_tile_once(shape, depth):
    plan = kc.c2cnet_plan(*shape, depth)
    for nh in {plan.cols, shape[0] - (plan.ctas - 1) * plan.cols}:
        for ph in kc.phase_dicts(plan)[:-1]:
            M = nh * ph["zl"]
            nt = ph["ncols"] // 8
            seen = {}
            for mt, p in _items(ph, M):
                for j in range(kc.ITEM_TILES * p, kc.ITEM_TILES * (p + 1)):
                    if j < nt:
                        seen[(mt, j)] = seen.get((mt, j), 0) + 1
            want = {(mt, j) for mt in range((M + 15) // 16)
                    for j in range(nt)}
            assert set(seen) == want and set(seen.values()) == {1}
            # the rows the items compute and the P rows a CTA holds
            assert 16 * ((M + 15) // 16) >= M
            assert dict(plan.buffers)["P"][1] >= 4 * M * kc._C0


def test_phases_read_and_write_apart():
    """No phase writes a buffer it reads, the projection's P is read only
    by the phase after the one that writes it, and the kernel's barriers
    are 19 GEMM phases plus the one after the input."""
    plan = kc.c2cnet_plan(10, 20, 15)
    phases = kc.phase_dicts(plan)
    assert [p["kind"] for p in phases].count(kc.FINAL) == 1
    assert plan.barriers == 20 and len(phases) - 1 == 19
    for i, ph in enumerate(phases[:-1]):
        reads = {ph["in_off"]} | ({ph["res_off"]} if ph["res"] ==
                                  kc.RES_BF16 else set())
        writes = {ph["out_off"]} | ({ph["pool_off"]} if ph["pool_off"] >= 0
                                    else set())
        assert not reads & writes, i
        if ph["res"] == kc.RES_PROJ:
            assert phases[i - 1]["proj"] == 1


def test_phase_table_matches_the_kernel_enum():
    src = (_build.CSRC / "c2cnet.cu").read_text()
    body = re.search(r"enum Field \{(.*?)\};", src, re.S).group(1)
    names = [f.strip() for f in body.split(",") if f.strip()]
    short = {"in_off": "In", "res": "Res", "res_off": "ResOff",
             "pool_off": "Pool", "w_off": "W", "pw_off": "PW",
             "aff_off": "Aff", "paff_off": "PAff", "p_off": "P",
             "out_off": "Out", "ncols": "Ncols", "zl": "Zl"}
    want = ["k" + short.get(f, "".join(w.capitalize() for w in f.split("_")))
            for f in kc.FIELDS] + ["kFieldCount"]
    assert names == want
    assert re.search(r"kNF = (\d+)", src).group(1) == str(kc.NF)
    assert re.search(r"kItemTiles = (\d+)", src).group(1) == \
        str(kc.ITEM_TILES)
    assert re.search(r"kThreads = (\d+)", src).group(1) == str(kc.THREADS)
    assert re.search(r"kMaxPhases = (\d+)", src).group(1) == \
        str(kc.STATIC_SMEM // (4 * kc.NF))
    assert re.search(r"kMaxDepth = (\d+)", src).group(1) == "2"
    plan = kc.c2cnet_plan(10, 20, 15)
    assert all(len(row) == kc.NF for row in plan.phases)


@pytest.mark.parametrize("J", [15, 17])
def test_fragments_unpack_to_the_flat_buffers(J):
    packed = pack_c2cnet(_net(J))
    offs = kc.frag_offsets(J)
    wf = packed["w_frag"].view(torch.uint8)
    assert wf.numel() == offs[-1]
    w_off = 0
    for i, (name, t, ci, f) in enumerate(kc.layer_shapes(J)[:-1]):
        taps, cinp, nc = kc.gemm_shape(name, t, ci, f, J)
        got = kc.unfragment(wf[offs[i]:offs[i + 1]].view(_BF), taps, cinp,
                         nc)
        flat = packed["w_flat"][w_off:w_off + t * ci * f].view(t, ci, f)
        w_off += t * ci * f
        assert torch.equal(got[:, :ci], kc.gemm_weights(name, flat))
        assert not got[:, ci:].any()


def test_launch_arguments_match_the_entry_point(monkeypatch):
    from fvp_torch.ops.kernels import Kernel

    calls = []
    monkeypatch.setattr(Kernel, "__call__",
                        lambda self, *a: calls.append((self.fn, a)))
    packed = pack_c2cnet(_net(15))
    plan = kc.c2cnet_plan(10, 20, 15, 1)
    kc.launch(packed, torch.zeros(10, 20, 15), torch.empty(10, 20), plan)
    (fn, args), = calls
    assert fn == "fvp_c2cnet"
    assert len(args) + 1 == len(_build.SIGNATURES[fn])
    assert args[6:] == (10, 20, 15, plan.cols, 20, 1, plan.slot_bytes,
                        plan.bar_off, plan.x_off, 24, plan.smem)


# -- the arithmetic ------------------------------------------------------------

@pytest.mark.parametrize("shape,depth", [
    ((10, 20, 15), None), ((13, 8, 15), None), ((7, 12, 17), None),
    ((10, 20, 15), 1), ((13, 8, 15), 1), ((7, 12, 17), 1),
    ((40, 20, 15), None), ((2, 56, 15), None), ((1, 4, 1), None)])
def test_emulation_matches_plain(shape, depth):
    from tests.test_torch_fuse_p2p import C2C_RTOL, _rel_err

    packed = pack_c2cnet(_net(shape[-1], seed=shape[0]))
    cols = torch.from_numpy(np.random.RandomState(shape[1])
                            .rand(*shape).astype(np.float32))
    with torch.no_grad():
        ref = kc.c2cnet_plain(packed, cols)
        got = kc.emulate(kc.c2cnet_plan(*shape, depth), packed, cols)
    assert got.shape == ref.shape and torch.isfinite(got).all()
    assert _rel_err(got.numpy(), ref.numpy()) < C2C_RTOL


# The eval batch's widths (B = 8: Shelf's K = 10 and Campus's K = 5 at
# J = 17), on conv kernels of std 0.1: over 40-80 columns an activation
# rounded to the other bf16 neighbour somewhere carries on through the 19
# phases, so the largest distance between two orders of sums grows with
# the columns. Measured against the plain version, 2.9e-3 .. 9.9e-3 of the
# scale over four seeds of _net at each width (the card's seeded nets in
# chip_smoke.py's phase 13: 1.3e-2 and 1.6e-2); at 80 columns the
# reference (pallas_c2cnet) lies 5.7e-3 .. 8.0e-3 from the emulation and
# 5.7e-3 .. 1.0e-2 from the plain version over three seeds. Held at
# chip_smoke.py's bound for the kernel at B = 8, 3 x its NET_RTOL.
C2C_BATCH_RTOL = 3e-2


@pytest.mark.parametrize("shape", [(80, 20, 17), (40, 20, 17)])
def test_emulation_matches_plain_at_eval_batch_widths(shape):
    from tests.test_torch_fuse_p2p import _rel_err

    packed = pack_c2cnet(_net(shape[-1], seed=shape[0]))
    cols = torch.from_numpy(np.random.RandomState(shape[1])
                            .rand(*shape).astype(np.float32))
    with torch.no_grad():
        ref = kc.c2cnet_plain(packed, cols)
        got = kc.emulate(kc.c2cnet_plan(*shape), packed, cols)
    assert got.shape == ref.shape and torch.isfinite(got).all()
    assert _rel_err(got.numpy(), ref.numpy()) < C2C_BATCH_RTOL


def _against_pallas(sub, net, cols):
    """pallas_c2cnet in interpret mode on the reference's variables `sub`,
    the emulation on the port's C2CNet `net` converted from them: the
    error relative to the reference's scale."""
    import jax.numpy as jnp

    from fvp_tpu.ops.pallas import hourglass as jhg
    from tests.test_torch_fuse_p2p import _rel_err

    ref = jhg.pallas_c2cnet(sub, jnp.asarray(cols), interpret=True)
    with torch.no_grad():
        got = kc.emulate(kc.c2cnet_plan(*cols.shape), pack_c2cnet(net),
                         torch.from_numpy(cols))
    assert got.shape == ref.shape
    return _rel_err(got.numpy(), ref)


def test_emulation_matches_pallas():
    """The harness of tests/test_torch_fuse_p2p.py: the reference package's
    perturbed variables, the port model converted from them."""
    from tests.test_torch_fuse_p2p import C2C_RTOL, _sub
    from tests.test_torch_nets import perturbed_variables, port_model
    from tests.test_torch_nets import small_cfg

    cfg = small_cfg(fuse_p2p=True)
    variables = perturbed_variables(cfg, 5)
    model = port_model(cfg, variables)
    cols = np.random.RandomState(2).rand(10, 20, 15).astype(np.float32)
    assert _against_pallas(_sub(variables, "c2c_net"),
                           model.pose_net.c2c_net, cols) < C2C_RTOL


def _c2c_pair(J, seed, gain):
    """The reference's C2CNet variables alone (one jitted init; the conv
    kernels, std 0.001, scaled x`gain`, and the 1-D tensors shifted by up
    to 0.05, as tests/test_torch_nets.py::perturbed_variables perturbs
    them) and the port's C2CNet converted from them."""
    import jax
    import jax.tree_util as jtu

    from fvp_torch.models.convert import _Writer
    from fvp_tpu.models.cnns import C2CNet as RefC2CNet

    rng = np.random.RandomState(seed)
    init = jax.jit(functools.partial(RefC2CNet().init, train=False))
    v = init(jax.random.PRNGKey(seed), np.zeros((1, 8, J), np.float32))

    def tweak(path, a):
        a = np.asarray(a)
        if a.ndim >= 2 and getattr(path[-1], "key", "") == "kernel":
            return a * np.float32(gain)
        if a.ndim == 1:
            return a + np.float32(0.05) * rng.rand(*a.shape).astype(
                np.float32)
        return a

    v = jtu.tree_map_with_path(tweak, {c: v[c] for c in
                                       ("params", "batch_stats")})
    w = _Writer()
    w.hourglass("net", v["params"], v["batch_stats"])
    w.conv("net.output_hm", v["params"]["Conv_0"])
    net = C2CNet(J).eval()
    net.load_state_dict({k[len("net."):]: a for k, a in w.out.items()})
    return v, net


def test_emulation_matches_pallas_at_eval_batch_width():
    """Shelf's eval batch, 80 columns at J = 17: the reference, which
    knows nothing of the kernel's plan, against the emulation. The conv
    kernels at std 0.1, as _net's (x30 leaves the outputs bias-dominated
    at this depth, their spread 9% of their scale, and the two sides equal
    bit for bit)."""
    sub, net = _c2c_pair(17, 5, 100.0)
    cols = np.random.RandomState(80).rand(80, 20, 17).astype(np.float32)
    assert _against_pallas(sub, net, cols) < C2C_BATCH_RTOL
