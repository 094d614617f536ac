"""The premises of the C2CNet kernel's design (csrc/c2cnet.cu), checked on
the CPU with its Python plan (ops/kernels/c2cnet.py::c2cnet_plan):

- the plan fits a block's shared memory, its ring slots and bulk copies
  are 16-byte aligned, its buffers do not overlap, no phase writes a
  buffer it reads, and tall columns take a ring of one slot;
- each phase's items, walked as the kernel walks them, cover every (row
  tile, column tile) exactly once, and the CTAs cover every column once;
- the kernel's phase table has the fields of the kernel's enum, in order;
- the fragment-ordered weights of pack_c2cnet unpack to the flat buffers;
- a PyTorch emulation of the kernel, walking the plan's table on a byte
  buffer that stands for each CTA's shared memory (the GEMM in k16 steps,
  each step's 16 products summed exactly and rounded toward zero to
  float32 as the tensor core does, then added in float32 in K order; the projection's own
  accumulators on the centre tap; the pool and the halo rows in the
  epilogue; the output conv's fused multiply-adds in channel order),
  reproduces c2cnet_plain and the reference package's pallas_c2cnet in
  interpret mode, at the tolerance of tests/test_torch_fuse_p2p.py.

The emulation imports nothing of JAX, so that the card test
(tests/test_torch_kernels_cuda.py) can hold the kernel against it.
"""

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


def unfragment(frag, taps, cin_pad, ncols):
    """The inverse of c2cnet.fragments: (taps, cin_pad, ncols)."""
    S, NT = taps * cin_pad // 16, ncols // 8
    v = frag.reshape(NT, S, 8, 4, 2, 2)        # (n, s, g, t, h, e)
    return v.permute(1, 4, 3, 5, 0, 2).reshape(taps, cin_pad, ncols)


# -- the emulation -------------------------------------------------------------

def _items(ph, M):
    """(m tile, column tile group) of a CTA, as the kernel walks them
    (gemm_phase): groups of ITEM_TILES n8 tiles."""
    per_mt = -(-(ph["ncols"] // 8) // kc.ITEM_TILES)
    return [(mt, p) for mt in range((M + 15) // 16) for p in range(per_mt)]


def k16_sum(a, w):
    """One k16 step of the mma into zero accumulators: (M, 16) @ (16, F)
    of bf16 values, the exact sum (float64 holds every product, and the
    sum of 16) rounded toward zero to float32, as the H100's mma.sync
    rounds it (rounded to nearest, the emulation parts from the card's
    kernel on some inputs)."""
    s = a.double() @ w.double()
    f = s.float()
    return torch.where(f.double().abs() > s.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def _fma_f32(acc, x, w):
    """fmaf(x, w, acc) on float32 tensors: one rounding of the exact
    value (x w is exact in float64, and so is its sum with acc here)."""
    return (acc.double() + x.double() * w.double()).float()


def emulate(plan, packed, cols, k16=k16_sum):
    """The kernel on the CPU: (N, Z, J) float32 -> (N, Z) float32. `k16`
    sums one k16 step."""
    N, Z, J = cols.shape
    wfrag = packed["w_frag"].view(torch.uint8)
    wflat, aff = packed["w_flat"], packed["aff_flat"]
    phases = kc.phase_dicts(plan)
    out = torch.zeros((N, Z))
    for cta in range(plan.ctas):
        n0 = cta * plan.cols
        nh = min(plan.cols, N - n0)
        sm = torch.zeros(plan.smem, dtype=torch.uint8)
        xs = plan.x_stride
        X = sm[plan.x_off:plan.x_off + 2 * nh * (Z + 6) * xs].view(_BF)
        X.view(nh, Z + 6, xs)[:, 3:Z + 3, :J] = cols[n0:n0 + nh].to(_BF)
        for ph in phases[:-1]:
            for idx, vals in _gemm(ph, sm, nh, wfrag, aff, k16):
                sm.view(vals.dtype)[idx] = vals   # after the phase's reads
        fin = phases[-1]
        m = torch.arange(nh * Z)
        n, z = m // Z, m % Z
        row = n * fin["in_rpc"] + fin["in_base"] + z
        idx = (fin["in_off"] // 2 + row[:, None] * fin["in_stride"]
               + torch.arange(32))
        x = sm.view(_BF)[idx].float()
        w = wflat[fin["w_off"]:fin["w_off"] + 32].float()
        acc = torch.zeros(len(m))
        for c in range(32):                  # fmaf in channel order
            acc = _fma_f32(acc, x[:, c], w[c])
        a0, a1 = aff[fin["aff_off"]], aff[fin["aff_off"] + 1]
        out[n0 + n, z] = acc * a0 + a1
    return out


def _gemm(ph, sm, nh, wfrag, aff, k16):
    """A CTA's GEMM phase: its writes (element indices into the shared
    memory viewed as the values' type, values)."""
    zl, taps, csteps = ph["zl"], ph["taps"], ph["csteps"]
    ks, M = taps * csteps, nh * zl
    nt, cinp = ph["ncols"] // 8, 16 * csteps
    m_all = torch.arange(M)
    # the ring slot: the phase's bulk copies
    b1 = nt * ks * kc.FRAG_BYTES
    W = unfragment(wfrag[ph["w_off"]:][:b1].view(_BF), taps, cinp,
                   8 * nt).float()
    if ph["proj"]:
        b2 = nt * csteps * kc.FRAG_BYTES
        PW = unfragment(wfrag[ph["pw_off"]:][:b2].view(_BF), 1, cinp,
                        8 * nt).float()[0]
    n, z = m_all // zl, m_all % zl
    bfm, fm = sm.view(_BF), sm.view(torch.float32)
    v = torch.zeros(M, 8 * nt)
    pacc = torch.zeros(M, 8 * nt)
    for st in range(ks):                 # k16 steps added in K order
        t, kcs = divmod(st, csteps)
        rows = n * ph["in_rpc"] + ph["in_base"] + z + t
        idx = (ph["in_off"] // 2 + rows[:, None] * ph["in_stride"]
               + 16 * kcs + torch.arange(16))
        a = bfm[idx].float()
        v = v + k16(a, W[t, 16 * kcs:16 * kcs + 16])
        if ph["proj"] and t == taps // 2:
            pacc = pacc + k16(a, PW[16 * kcs:16 * kcs + 16])
    cols_ = torch.arange(8 * nt)
    fo, ostr, orpc = ph["fo"], ph["out_stride"], ph["out_rpc"]
    writes = []

    def store(base, row, col, y, zo, top):
        """bf16 y at (row, col) of the buffer at `base`, zero halo rows
        below zo == 0 and above zo == top."""
        idx = base // 2 + row * ostr + col
        zo = zo.expand_as(idx)
        writes.append((idx.reshape(-1), y.to(_BF).reshape(-1)))
        for edge, d in ((zo == 0, -1), (zo == top, 1)):
            e = idx[edge] + d * ostr
            writes.append((e, torch.zeros(len(e), dtype=_BF)))

    if ph["kind"] == kc.UPCONV:
        r_, f_ = cols_ // fo, cols_ % fo
        y = v * aff[ph["aff_off"] + f_] + aff[ph["aff_off"] + fo + f_]
        y = torch.relu(y).to(_BF).float()
        zo = 2 * z[:, None] + r_[None, :]
        row = n[:, None] * orpc + 1 + zo
        skip = bfm[ph["res_off"] // 2 + row * ostr + f_[None, :]].float()
        store(ph["out_off"], row, f_[None, :], (y + skip).to(_BF), zo,
              2 * zl - 1)
        return writes
    y = v * aff[ph["aff_off"] + cols_] + aff[ph["aff_off"] + fo + cols_]
    row = n[:, None] * orpc + 1 + z[:, None]
    if ph["res"] == kc.RES_BF16:
        y = y + bfm[ph["res_off"] // 2 + row * ostr + cols_].float()
    elif ph["res"] == kc.RES_PROJ:
        y = y + fm[ph["p_off"] // 4 + m_all[:, None] * 8 * nt + cols_]
    if ph["relu"]:
        y = torch.relu(y)
    y = y.to(_BF)
    store(ph["out_off"], row, cols_, y, z[:, None], zl - 1)
    if ph["pool_off"] >= 0:              # rows m, m + 1 of an even m
        even = z % 2 == 0
        pooled = torch.maximum(y[even].float(), y[m_all[even] + 1].float())
        zp = (z[even] // 2)[:, None]
        prow = n[even][:, None] * ph["pool_rpc"] + 1 + zp
        store(ph["pool_off"], prow, cols_, pooled, zp, zl // 2 - 1)
    if ph["proj"]:                       # float32, into P
        p = pacc * aff[ph["paff_off"] + cols_] + \
            aff[ph["paff_off"] + fo + cols_]
        pidx = ph["p_off"] // 4 + m_all[:, None] * 8 * nt + cols_
        writes.append((pidx.reshape(-1), p.reshape(-1)))
    return writes


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
        got = unfragment(wf[offs[i]:offs[i + 1]].view(_BF), taps, cinp,
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
        got = emulate(kc.c2cnet_plan(*shape, depth), packed, cols)
    assert got.shape == ref.shape and torch.isfinite(got).all()
    assert _rel_err(got.numpy(), ref.numpy()) < C2C_RTOL


def test_emulation_matches_pallas():
    """The harness of tests/test_torch_fuse_p2p.py: pallas_c2cnet in
    interpret mode on the reference package's perturbed variables, the
    emulation on the port model converted from them."""
    import jax.numpy as jnp

    from fvp_tpu.ops.pallas import hourglass as jhg
    from tests.test_torch_fuse_p2p import C2C_RTOL, _rel_err, _sub
    from tests.test_torch_nets import perturbed_variables, port_model
    from tests.test_torch_nets import small_cfg

    cfg = small_cfg(fuse_p2p=True)
    variables = perturbed_variables(cfg, 5)
    model = port_model(cfg, variables)
    cols = np.random.RandomState(2).rand(10, 20, 15).astype(np.float32)
    ref = jhg.pallas_c2cnet(_sub(variables, "c2c_net"), jnp.asarray(cols),
                            interpret=True)
    with torch.no_grad():
        got = emulate(kc.c2cnet_plan(10, 20, 15),
                      pack_c2cnet(model.pose_net.c2c_net),
                      torch.from_numpy(cols))
    assert got.shape == ref.shape
    assert _rel_err(got.numpy(), ref) < C2C_RTOL
