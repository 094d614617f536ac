"""The premises of the two bf16 kernels' designs, checked on the CPU with
their Python plans, on shapes alone and through emulations:

- CenterNet's persistent bf16 kernel (csrc/centernet_bf16.cu,
  ops/kernels/centernet.py::centernet_bf16_plan): every stage's tiles,
  split over the warps, M fragments and lanes as the kernel splits them,
  cover each output once; no stage reads what it writes, and buffers that
  live at once never share the arena; every op's shared memory fits a
  block; the op table has the kernel's enum's fields; and an emulation
  that walks the op table on the packed flat buffers (the kernel's weight
  layout, the bf16 arena, its rounding points) reproduces
  centernet_bf16_plain and the reference's pallas_centernet in interpret
  mode;
- WeightNet's banded bf16 pool (csrc/weightnet.cu::
  weightnet_pool_bf16_kernel, ops/kernels/weightnet.py::
  weightnet_bf16_plan): its bands cover every row and its halo, its chunks
  every joint, its warps every (joint, patch) once, its tiles fit, and an
  emulation of its band sums and fixed-order combine reproduces
  weightnet_pool_bf16_plain.

torch is pinned to one thread, so that the driver's parallel workers do
not oversubscribe the cores.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fvp_torch.engine.packing import pack_centernet_bf16, pack_weightnet_bf16
from fvp_torch.ops.kernels import _build
from fvp_torch.ops.kernels import centernet as kcn
from fvp_torch.ops.kernels import weightnet as kw
from fvp_tpu.ops.pallas.hourglass import pallas_centernet
from tests.test_torch_bf16 import BF16, _rel_err
from tests.test_torch_centernet_plan import _net
from tests.test_torch_nets import perturbed_variables, port_model, small_cfg

_BF = torch.bfloat16
SHAPES = [(1, 80, 80, 15), (8, 80, 80, 15), (1, 40, 24, 17),
          (2, 16, 16, 15), (1, 16, 16, 64)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- CenterNet: the emulation ---------------------------------------------------

def emulate_centernet(plan, packed, bev):
    """The bf16 plan's ops in stage order, read from packed["wflat"] and
    packed["affflat"] at the plan's offsets in the kernel's layout, on a
    NaN-filled bf16 arena; each op rounds where the kernel rounds and
    writes once every op of its stage has read. Returns (hm, size)."""
    B, H, W = plan.B, plan.H, plan.W
    wflat, affflat = packed["wflat"], packed["affflat"]
    arena = torch.full((plan.arena_elems,), float("nan"), dtype=_BF)
    out = torch.full((3 * B * H * W,), float("nan"))

    def weights(off, taps, cout, cinp, cin):
        n = taps * cout * cinp
        return wflat[off:off + n].view(taps, cout, cinp)[..., :cin].float()

    def affine(off, cout):
        return affflat[off:off + 2 * cout].view(2, cout)

    def read(off, h, w, c, pool):
        shape = (B, 2 * h, 2 * w, c) if pool else (B, h, w, c)
        x = arena[off:off + int(np.prod(shape))].view(shape).float()
        if pool:
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        return x

    def conv(x, wt, k):
        cout, cin = wt.shape[1:]
        wk = wt.reshape(k, k, cout, cin).permute(2, 3, 0, 1)
        y = F.conv2d(x.permute(0, 3, 1, 2), wk, padding=k // 2)
        return y.permute(0, 2, 3, 1)

    for a, b in plan.stages:
        writes = []
        for op in plan.ops[a:b]:
            h, w, k = op["h"], op["w"], op["k"]
            cin, cinp, cout = op["cin"], op["cinp"], op["cout"]
            taps = 4 if op["kind"] == kcn.UPCONV else k * k
            wt = weights(op["w_off"], taps, cout, cinp, cin)
            sc, sh = affine(op["aff_off"], cout)
            if op["kind"] == kcn.UPCONV:
                x = read(op["in_off"], h // 2, w // 2, cin, False)
                wk = wt.reshape(2, 2, cout, cin).permute(3, 2, 0, 1)
                y = F.conv_transpose2d(x.permute(0, 3, 1, 2), wk, stride=2)
                y = torch.relu(y.permute(0, 2, 3, 1) * sc + sh).to(_BF)
                skip = read(op["res_off"], h, w, cout, False)
                writes.append(("arena", op["out_off"],
                               (y.float() + skip).to(_BF)))
                continue
            x = bev.to(_BF).float() if op["in_src"] == kcn.SRC_BEV else \
                read(op["in_off"], h, w, cin, op["in_pool"])
            y = conv(x, wt, k) * sc + sh
            if op["kind"] == kcn.HEADS:
                hid = torch.relu(y).to(_BF).float()
                wo = weights(op["o_w_off"], 1, 3, 64, 64)[0]       # (3, 64)
                so, ho = affine(op["o_aff_off"], 3)
                hm = hid[..., :32] @ wo[0, :32] * so[0] + ho[0]
                size = hid[..., 32:] @ wo[1:, 32:].t() * so[1:] + ho[1:]
                writes += [("out", op["out_off"], hm),
                           ("out", op["out2_off"], size)]
                continue
            if op["res_kind"] == kcn.RES_ADD:
                y = y + read(op["res_off"], h, w, cout, False)
            elif op["res_kind"] == kcn.RES_PROJ:
                p = read(op["p_in_off"], h, w, op["p_cin"], op["p_pool"])
                pw = weights(op["p_w_off"], 1, cout, op["p_cin"],
                             op["p_cin"])
                psc, psh = affine(op["p_aff_off"], cout)
                y = y + (conv(p, pw, 1) * psc + psh)
            if op["relu"]:
                y = torch.relu(y)
            writes.append(("arena", op["out_off"], y.to(_BF)))
        for buf, off, y in writes:
            dst = arena if buf == "arena" else out
            dst[off:off + y.numel()] = y.reshape(-1)
    return kcn.bf16_outputs(plan, out)


def _packed_bf16(J, seed=0):
    return pack_centernet_bf16(_net(J, seed))


def _bev(shape, seed=1):
    return torch.from_numpy(
        np.random.RandomState(seed).rand(*shape).astype(np.float32))


# The emulation against centernet_bf16_plain: both round to bf16 at the
# same points, so they differ where their float32 sums, taken over other
# terms (Cin padded to 16; the heads' 1x1 over 32 channels, the plain
# version's over 64 with exact zeros), land on either side of a bf16
# rounding boundary. Such a flip moves one activation by one bf16 ulp
# (2**-8 of it) and carries on; the bound is one such ulp of the output's
# scale. Measured: at most 1.1e-7 of the scale (no flip in the body; the
# heads' float32 sums in another order).
EMU_TOL = 2.0 ** -8


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_emulation_matches_plain(shape):
    packed = _packed_bf16(shape[-1], seed=shape[0])
    bev = _bev(shape, seed=shape[1])
    plan = kcn.centernet_bf16_plan(*shape)
    with torch.no_grad():
        ref = kcn.centernet_bf16_plain(packed, bev)
        got = emulate_centernet(plan, packed, bev)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and torch.isfinite(g).all()
        err = _rel_err(g.numpy(), r.numpy())
        print(f"bf16 emulation vs plain {shape}: {err:.3e} of scale")
        assert err <= EMU_TOL


@pytest.mark.parametrize("batch", [1, 2])
def test_bf16_emulation_matches_tpu_kernel(batch):
    """The reference's pallas_centernet in interpret mode on the harness of
    tests/test_torch_bf16_routes.py, the emulation on the port's packed
    weights, at its tolerance (CENTERNET_TOL there: bf16 flips where the
    float32 sums run in another order)."""
    from tests.test_torch_bf16_routes import CENTERNET_TOL, _sub
    v = perturbed_variables(small_cfg(**BF16), 7)
    v["params"]["center_net"]["Conv_1"]["kernel"] *= np.float32(30.0)
    model = port_model(small_cfg(**BF16), v)
    bev = np.random.RandomState(6 + batch).rand(batch, 32, 32, 15) \
        .astype(np.float32)
    hm_r, size_r = pallas_centernet(_sub(v, "center_net"), jnp.asarray(bev),
                                    interpret=True)
    packed = pack_centernet_bf16(model.pose_net.center_net)
    with torch.no_grad():
        hm, size = emulate_centernet(kcn.centernet_bf16_plan(*bev.shape),
                                     packed, torch.from_numpy(bev))
    e_hm, e_size = _rel_err(hm.numpy(), hm_r), _rel_err(size.numpy(), size_r)
    print(f"bf16 emulation vs pallas_centernet (B = {batch}): hm "
          f"{e_hm:.3e}, size {e_size:.3e} of scale")
    assert e_hm < CENTERNET_TOL and e_size < CENTERNET_TOL


# -- CenterNet: the schedule ------------------------------------------------------

def _bf16_tile_outputs(op):
    """(n, y, x, c) of every output the op's tiles store, as the kernel maps
    tiles to blocks, warps to (M fragment, channel group) and lanes to
    fragment rows g, g + 8 and channel pairs (one entry per store)."""
    th, tw, tn, wn, nf = op["th"], op["tw"], op["tn"], op["wn"], op["nf"]
    dy, dx, dc = [], [], []
    for wid in range(kcn.WARPS):
        ng, mf = wid % wn, wid // wn
        for lane in range(32):
            g, tq = lane >> 2, lane & 3
            for e in range(2):
                if op["kind"] == kcn.UPCONV:
                    q = g + 8 * e
                    py, px = 2 * (q >> 2) + (mf >> 1), 2 * (q & 3) + (mf & 1)
                else:
                    py, px = 2 * mf + e, g
                for j in range(nf):
                    for c in range(2):
                        dy.append(py)
                        dx.append(px)
                        dc.append(ng * nf * 8 + 8 * j + 2 * tq + c)
    dy, dx, dc = map(np.asarray, (dy, dx, dc))
    t = np.arange(op["tiles"])
    tc = t % op["tiles_c"]
    r = t // op["tiles_c"]
    tx = r % op["tiles_x"]
    r //= op["tiles_x"]
    ty = r % op["tiles_y"]
    n = r // op["tiles_y"]
    y = (ty * th)[:, None] + dy[None]
    x = (tx * tw)[:, None] + dx[None]
    c = (tc * tn)[:, None] + dc[None]
    n = np.broadcast_to(n[:, None], y.shape)
    keep = (y < op["h"]) & (x < op["w"])
    return n[keep], y[keep], x[keep], c[keep]


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_tiles_cover_every_output_once(shape):
    plan = kcn.centernet_bf16_plan(*shape)
    assert len(plan.stages) == 16
    for op in plan.ops:
        n, y, x, c = _bf16_tile_outputs(op)
        count = np.zeros((op["b"], op["h"], op["w"], op["cout"]), np.int64)
        np.add.at(count, (n, y, x, c), 1)
        assert count.min() == 1 and count.max() == 1, op["name"]
        assert op["wm"] * op["wn"] == kcn.WARPS and op["wm"] == op["th"] // 2
        assert op["tn"] == op["wn"] * op["nf"] * 8 and op["tw"] == 8
        if op["kind"] == kcn.UPCONV:          # a fragment per parity
            assert op["th"] == 8
        if op["kind"] == kcn.HEADS:           # all 64 channels in a tile
            assert op["tn"] == op["cout"] == 64


def _bf16_ranges(op):
    """The arena ranges (offset, elements) an op reads and writes."""
    B, h, w = op["b"], op["h"], op["w"]
    reads = []
    if op["in_src"] == kcn.SRC_ARENA:
        scale = 4 if op["in_pool"] else (
            0.25 if op["kind"] == kcn.UPCONV else 1)
        reads.append((op["in_off"], int(B * h * w * op["cin"] * scale)))
    if op["res_kind"] in (kcn.RES_ADD, kcn.RES_SKIP):
        reads.append((op["res_off"], B * h * w * op["cout"]))
    if op["res_kind"] == kcn.RES_PROJ:
        scale = 4 if op["p_pool"] else 1
        reads.append((op["p_in_off"], B * h * w * op["p_cin"] * scale))
    writes = [] if op["kind"] == kcn.HEADS else \
        [(op["out_off"], B * h * w * op["cout"])]
    return reads, writes


def _overlap(a, b):
    return a[0] < b[0] + b[1] and b[0] < a[0] + a[1]


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_stages_and_arena(shape):
    plan = kcn.centernet_bf16_plan(*shape)
    assert not any(b.name in ("hm", "size") for b in plan.bufs)
    for a, b in plan.stages:
        rw = [_bf16_ranges(op) for op in plan.ops[a:b]]
        reads = [r for rs, _ in rw for r in rs]
        writes = [w for _, ws in rw for w in ws]
        assert not any(_overlap(w, r) for w in writes for r in reads)
        assert not any(_overlap(w, v) for i, w in enumerate(writes)
                       for v in writes[i + 1:])
    for i, p in enumerate(plan.bufs):
        size = int(np.prod(p.shape))
        assert p.off % kcn.ALIGN == 0 and p.off + size <= plan.arena_elems
        for q in plan.bufs[i + 1:]:
            if p.write <= q.last_read and q.write <= p.last_read:
                assert not _overlap((p.off, size),
                                    (q.off, int(np.prod(q.shape)))), \
                    (p.name, q.name)
    # every read is of a buffer an earlier stage wrote and that still lives
    for op in plan.ops:
        for off, _ in _bf16_ranges(op)[0]:
            assert any(b.off == off and b.write < op["stage"] <= b.last_read
                       for b in plan.bufs), op["name"]


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_shared_memory_fits_a_block(shape):
    plan = kcn.centernet_bf16_plan(*shape)
    assert plan.smem_bytes <= kcn.MAX_SMEM
    assert plan.smem_bytes == max(op["smem"] for op in plan.ops)
    for op in plan.ops:
        # ldmatrix rows of 16-byte units, an odd number of them a row
        for xs in (op["xs"], op["xsp"]):
            assert xs == 0 or (xs % 8 == 0 and (xs // 8) % 2 == 1)
        assert op["ck"] % 16 == 0 and op["cinp"] % op["ck"] == 0
        assert op["ck"] <= 128 and op["ckp"] <= 128
        assert op["p_cin"] == 0 or op["p_cin"] % op["ckp"] == 0
        assert op["xf"] % 8 == 0 and op["wf"] % 8 == 0


def test_bf16_flat_layout():
    """wflat holds each layer as (taps, Cout, Cin16), zero past Cin, and
    affflat its (scale, shift) rows, at bf16_offsets; the layers the plain
    version reads are untouched."""
    for J in (15, 17):
        packed = _packed_bf16(J)
        offs = kcn.bf16_offsets(J)
        assert packed["wflat"].dtype == _BF
        assert packed["wflat"].numel() == offs["w_total"]
        assert packed["affflat"].numel() == offs["aff_total"]
        for path, taps, cin, cout in kcn.bf16_layers(J):
            wo, ao = offs[path]
            assert wo % 16 == 0
            lay = kcn._get(packed, path)
            cinp = kcn.round16(cin)
            got = packed["wflat"][wo:wo + taps * cout * cinp] \
                .view(taps, cout, cinp)
            assert torch.equal(got[..., :cin],
                               lay["w"].reshape(taps, cin, cout)
                               .transpose(1, 2))
            assert not got[..., cin:].any()
            assert torch.equal(packed["affflat"][ao:ao + 2 * cout],
                               lay["aff"].reshape(-1))


def test_bf16_op_table_matches_the_kernel_enum():
    src = (_build.CSRC / "centernet_bf16.cu").read_text()
    body = re.search(r"enum Field \{(.*?)\};", src, re.S).group(1)
    names = [f.strip() for f in body.split(",") if f.strip()]
    assert names == ["F_" + f.upper() for f in kcn.BF16_OP_FIELDS]
    assert re.search(r"constexpr int kOpW = (\d+);", src).group(1) == \
        str(kcn.OPW)
    assert re.search(r"constexpr int kHidStride = (\d+);", src).group(1) \
        == str(kcn.HID_STRIDE)
    plan = kcn.centernet_bf16_plan(1, 16, 16, 15)
    assert len(plan.table()) == kcn.OPW * len(plan.ops)
    assert len(plan.stage_table()) == 2 * len(plan.stages)
    # the tables fit the kernel's shared copies
    assert len(plan.ops) <= int(re.search(r"constexpr int kMaxOps = (\d+);",
                                          src).group(1))
    assert len(plan.stages) <= int(re.search(
        r"constexpr int kMaxStages = (\d+);", src).group(1))


def test_bf16_plan_refuses_what_it_cannot_take():
    with pytest.raises(ValueError):
        kcn.centernet_bf16_plan(1, 82, 80, 15)
    with pytest.raises(ValueError):
        kcn.centernet_bf16_plan(1, 80, 78, 15)


@pytest.mark.parametrize("J,ck", [(15, 16), (48, 48), (64, 16), (2000, 16)])
def test_bf16_front_chunks_cover_its_channels(J, ck):
    """The 7x7 front stages the BEV's channels in chunks: all of them in
    one where its 49 taps' weights fit, else chunks of 16, each staging
    BEV channels [ci0, ci0 + ck) (csrc/centernet_bf16.cu::stage_bev), so
    the chunks cover the padded channels once and the real ones among
    them."""
    front = kcn.centernet_bf16_plan(1, 80, 80, J).ops[0]
    assert front["name"] == "front" and front["in_src"] == kcn.SRC_BEV
    assert front["ck"] == ck and front["cinp"] == kcn.round16(J)
    assert front["cinp"] % front["ck"] == 0 and front["smem"] <= \
        kcn.SMEM_TARGET
    chans = [c for ci0 in range(0, front["cinp"], front["ck"])
             for c in range(ci0, ci0 + front["ck"])]
    assert chans == list(range(front["cinp"])) and front["cinp"] >= J


def test_bf16_launch_arguments_match_the_entry_point(monkeypatch):
    from fvp_torch.ops.kernels import Kernel

    calls = []
    monkeypatch.setattr(Kernel, "__call__",
                        lambda self, *a: calls.append((self.fn, a)))
    monkeypatch.setattr(kcn, "check", lambda *a, **k: None)
    packed = _packed_bf16(15)
    plan = kcn.centernet_bf16_plan(1, 16, 16, 15)
    arena = torch.empty(plan.arena_elems, dtype=_BF)
    out = torch.empty(3 * 16 * 16)
    kcn.launch_bf16(packed, _bev((1, 16, 16, 15)), arena, out)
    kcn.launch_bf16(packed, _bev((1, 16, 16, 15)), arena, out, 5, 6)
    assert [c[0] for c in calls] == ["fvp_centernet_bf16"] * 2
    for fn, args in calls:
        assert len(args) + 1 == len(_build.SIGNATURES[fn])
    assert calls[0][1][7:] == (len(plan.ops), 16, 0, 16, plan.max_tiles,
                               plan.smem_bytes, 1)
    assert calls[1][1][9:12] == (5, 6, sum(
        op["tiles"] for op in plan.ops[plan.stages[5][0]:plan.stages[5][1]]))
    assert calls[1][1][-1] == 0                        # one stage: no barrier


# -- WeightNet's bf16 pool ---------------------------------------------------------

POOL_SHAPES = [(30, 64, 64, 15, None, None), (240, 64, 64, 15, None, None),
               (30, 64, 64, 15, None, 4), (2, 40, 22, 17, None, None),
               (3, 10, 6, 2, 4, None), (1, 4, 512, 64, None, None),
               (1, 256, 256, 96, None, 7)]


def _pool_packed(seed=0):
    """Seeded bf16 pool weights: (16, 32) taps (9.. zero), (scale, shift)."""
    rng = np.random.RandomState(seed)
    w = torch.zeros(16, 32, dtype=_BF)
    w[:9] = torch.from_numpy(rng.normal(0, 0.3, (9, 32)).astype(np.float32))
    aff = np.stack([1 + 0.1 * rng.randn(32), 0.1 * rng.randn(32)])
    return {"w": w, "aff": torch.from_numpy(aff.astype(np.float32))}


def emulate_pool(plan, planes, packed):
    """The bf16 kernel on the CPU: each band's tile with its halo, rounded
    to bf16; each pooled cell as the plain version computes it (the
    kernel's order, the max before the affine, gives the same bits:
    test_pool_max_before_the_affine_is_exact); a joint's band sum as the
    kernel takes it (the thread of pooled column 8 pc + i sums its cells
    in patch order, then the fixed butterfly over i); the bands in band
    order, then the mean."""
    N, A, B, J = planes.shape
    wt = packed["w"][:9].float().t().reshape(32, 1, 3, 3)
    sc, sh = packed["aff"][0], packed["aff"][1]
    cols = -(-B // 16)
    out = torch.zeros(N, J, 32)
    for n in range(N):
        tot = None
        for band in range(plan.bands):
            y0 = band * plan.rows
            bh = min(plan.rows, A - y0)
            tile = torch.zeros(J, bh + 2, B + 2)
            lo, hi = max(y0 - 1, 0), min(y0 + bh + 1, A)
            tile[:, lo - (y0 - 1):hi - (y0 - 1), 1:B + 1] = \
                planes[n, lo:hi].permute(2, 0, 1).to(_BF).float()
            h = F.conv2d(tile[:, None], wt)                  # (J, 32, bh, B)
            h = torch.relu(h * sc[:, None, None] + sh[:, None, None])
            m = F.max_pool2d(h.to(_BF).float(), 2, 2)     # (J, 32, bh/2, B/2)
            m = F.pad(m, (0, 8 * cols - B // 2))
            m = m.reshape(J, 32, bh // 2, cols, 8)
            s = torch.zeros(J, 32, 8)
            for r in range(bh // 2):
                for pc in range(cols):
                    s = s + m[:, :, r, pc]
            part = ((s[..., 0] + s[..., 1]) + (s[..., 2] + s[..., 3])) \
                + ((s[..., 4] + s[..., 5]) + (s[..., 6] + s[..., 7]))
            tot = part if tot is None else tot + part
        out[n] = tot / float((A // 2) * (B // 2))
    return out


@pytest.mark.parametrize("shape", POOL_SHAPES)
def test_pool_bands_chunks_and_warps_cover_once(shape):
    """Every map row is a band's once, in bands of even rows; every joint
    is a chunk's once; the warps of a block take every joint of the chunk
    once; a band's tiles with their halo fit."""
    N, A, B, J, rows, joints = shape
    plan = kw.weightnet_bf16_plan(N, A, B, J, rows, joints)
    assert plan.rows % 2 == 0 and 2 <= plan.rows <= A
    assert plan.smem == 2 * plan.joints * plan.plane <= kw.MAX_SMEM
    assert plan.plane >= (plan.rows + 2) * (B + 2)
    assert (plan.rows + 2) * (B * plan.joints) ** 2 < 2 ** 32
    assert 1 <= plan.warps <= kw.MAX_WARPS_BF16
    rows_seen = np.zeros(A, np.int64)
    for band in range(plan.bands):
        y0 = band * plan.rows
        bh = min(plan.rows, A - y0)
        assert bh >= 2 and bh % 2 == 0
        rows_seen[y0:y0 + bh] += 1
    assert (rows_seen == 1).all()
    joints_seen = np.zeros(J, np.int64)
    for jb in range(plan.chunks):
        jn = min(plan.joints, J - jb * plan.joints)
        joints_seen[jb * plan.joints:jb * plan.joints + jn] += 1
        taken = np.zeros(jn, np.int64)
        for warp in range(plan.warps):
            taken[warp:jn:plan.warps] += 1
        assert (taken == 1).all()
    assert (joints_seen == 1).all()


def test_pool_flagship_plans():
    """(30, 64, 64, 15): 4 bands of 16 rows, 120 blocks of 15 warps; the
    eval batch's (240, 64, 64, 15): whole maps, 240 blocks (the fastest
    of the band heights timed on the H100, weightnet_bf16_plan's note)."""
    p = kw.weightnet_bf16_plan(30, 64, 64, 15)
    assert (p.rows, p.bands, p.joints, p.warps, p.blocks) == \
        (16, 4, 15, 15, 120)
    p = kw.weightnet_bf16_plan(240, 64, 64, 15)
    assert (p.rows, p.blocks) == (64, 240)
    # a band of all 64 joints of a 512-wide map does not fit: two chunks
    assert kw.weightnet_bf16_plan(1, 4, 512, 64).chunks == 2


def test_pool_plan_refuses_odd_maps():
    for args in [(1, 63, 64, 15), (1, 64, 7, 15), (1, 64, 64, 0)]:
        with pytest.raises(ValueError):
            kw.weightnet_bf16_plan(*args)
    with pytest.raises(ValueError):
        kw.weightnet_bf16_plan(1, 64, 64, 15, 5)
    with pytest.raises(ValueError):
        kw.weightnet_bf16_plan(1, 64, 64, 15, None, 16)


@pytest.mark.parametrize("shape", [s for s in POOL_SHAPES[:5]
                                   if s[0] != 240])
def test_pool_emulation_matches_plain(shape):
    """At the card test's tolerance, one bf16 ulp of the features' scale:
    the 9 products are exact, a pooled value may round to its bf16
    neighbour where the 9-term sum runs in another order; the float32 mean
    in another order adds ~1e-7."""
    N, A, B, J, rows, joints = shape
    planes = torch.from_numpy(np.random.RandomState(A).randn(N, A, B, J)
                              .astype(np.float32))
    packed = _pool_packed(J)
    plan = kw.weightnet_bf16_plan(N, A, B, J, rows, joints)
    ref = kw.weightnet_pool_bf16_plain(planes, packed)
    got = emulate_pool(plan, planes, packed)
    scale = float(ref.abs().max())
    assert got.shape == ref.shape and scale > 0
    torch.testing.assert_close(got, ref, rtol=0, atol=2.0 ** -8 * scale)


def test_pool_max_before_the_affine_is_exact():
    """The kernel's order: the max of a window's four conv outputs (taps
    negated where the scale is negative), then fl(fl(m |s|) + b), ReLU and
    bf16 rounding; the plain order: each output's affine, ReLU and
    rounding, then the max. Bit for bit, on conv outputs with many equal
    and near-equal values and negative scales."""
    rng = np.random.RandomState(5)
    a = torch.from_numpy((rng.randn(4, 4096, 32) * 10.0 ** rng.randint(
        -6, 4, (4, 4096, 32))).astype(np.float32))
    a[1, ::7] = a[0, ::7]                      # ties
    a[2, ::5] = torch.nextafter(a[0, ::5], torch.tensor(np.inf))
    sc = torch.from_numpy((1 + 0.1 * rng.randn(32)).astype(np.float32))
    sc[::3] *= -1
    sh = torch.from_numpy((0.1 * rng.randn(32)).astype(np.float32))

    def g(x, s):
        return torch.relu(x * s + sh).to(_BF)

    plain = g(a, sc).float().amax(0)
    neg = torch.where(sc < 0, -1.0, 1.0)
    assert torch.equal(g((a * neg).amax(0), sc.abs()).float(), plain)


def test_pool_emulation_matches_tpu_kernel():
    """The reference's pallas_weightnet_pool in interpret mode on the
    harness of tests/test_torch_bf16_routes.py (bit for bit there against
    the plain version), the emulation in three bands of 6 rows."""
    from fvp_tpu.ops.pallas.deconv_head import bn_affine
    from fvp_tpu.ops.pallas.weightnet import pallas_weightnet_pool
    from tests.test_torch_bf16_routes import POOL_TOL, _sub
    v = perturbed_variables(small_cfg(**BF16), 7)
    model = port_model(small_cfg(**BF16), v)
    planes = np.random.RandomState(4).rand(6, 16, 16, 15).astype(np.float32)
    s = _sub(v, "weight_net")
    p, st = s["params"], s["batch_stats"]
    aff = bn_affine(p["BatchNorm_0"]["scale"], p["BatchNorm_0"]["bias"],
                    st["BatchNorm_0"]["mean"], st["BatchNorm_0"]["var"])
    ref = np.asarray(pallas_weightnet_pool(
        jnp.asarray(planes), p["Conv_0"]["kernel"], p["Conv_0"]["bias"],
        aff, interpret=True))
    plan = kw.weightnet_bf16_plan(6, 16, 16, 15, 6)
    assert plan.bands == 3
    got = emulate_pool(plan, torch.from_numpy(planes),
                       pack_weightnet_bf16(model.joint_net.weight_net))
    assert got.shape == ref.shape
    assert _rel_err(got.numpy(), ref) < POOL_TOL


def test_pool_launch_arguments_match_the_entry_point(monkeypatch):
    from fvp_torch.ops.kernels import Kernel

    calls = []
    monkeypatch.setattr(Kernel, "__call__",
                        lambda self, *a: calls.append((self.fn, a)))
    monkeypatch.setattr(kw, "last_block_counters",
                        lambda device, n: torch.zeros(n))
    plan = kw.weightnet_bf16_plan(2, 40, 24, 15, 16)
    kw.launch_bf16(torch.zeros(2, 40, 24, 15), _pool_packed(),
                   torch.empty(2, 15, 32), plan)
    (fn, args), = calls
    assert fn == "fvp_weightnet_pool_bf16"
    assert len(args) + 1 == len(_build.SIGNATURES[fn])
    assert args[6:] == (2, 40, 24, 15, 32, 16, 3, 15, 15, plan.plane,
                        plan.smem)
