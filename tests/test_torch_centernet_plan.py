"""The premises of the CenterNet kernel's design (csrc/centernet.cu),
checked on the CPU with its Python schedule (ops/kernels/centernet.py::
centernet_plan):

- every stage's tiles, split over the block's warps and lanes as the
  kernel splits them, cover each output (pixel, channel) exactly once;
- no stage reads a buffer the same stage writes, the arena's buffers whose
  lifetimes overlap never share memory, and every tile's shared memory
  fits a block;
- the kernel's op table has the fields of the kernel's enum, in order;
- the merged heads (one 32 -> 64 conv) reproduce centernet_plain's hm and
  size;
- a PyTorch emulation of the fused schedule, run on the plan's arena
  offsets and the flat weight buffer (pool in the load, the projection as
  an extra K segment, the skip in the up-conv's epilogue, the merged
  heads), reproduces centernet_plain, and flax CenterNet with the same
  numpy-seeded weights.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvp_torch.engine.packing import pack_centernet, pack_model
from fvp_torch.models.cnns import CenterNet
from fvp_torch.ops.kernels import _build
from fvp_torch.ops.kernels import centernet as kcn
from fvp_tpu.models.cnns import CenterNet as FlaxCenterNet
from tests.test_torch_nets import _close, _sub

SHAPES = [(1, 80, 80, 15), (2, 80, 80, 15), (1, 40, 24, 17), (1, 16, 16, 15)]


def _net(J, seed=0):
    """A port CenterNet with numpy-seeded weights: convs N(0, 0.1), BN
    affines and running stats shifted by up to 0.05 (var from 1)."""
    net = CenterNet(J).eval()
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


def _bev(shape, seed=1):
    return torch.from_numpy(
        np.random.RandomState(seed).rand(*shape).astype(np.float32))


# -- the emulation -------------------------------------------------------------

def emulate(plan, flat, bev):
    """The plan's ops in stage order on a NaN-filled arena: each op reads
    its inputs at the plan's offsets, computes as its tile's fusions do, and
    writes its output at its offset once every op of its stage has read."""
    arena = torch.full((plan.arena_floats,), float("nan"))
    B = plan.B

    def view(buf, off, shape):
        n = int(np.prod(shape))
        return buf[off:off + n].view(shape)

    def layer(w_off, sc_off, sh_off, k, cin, cout):
        return {"w": view(flat, w_off, (k, k, cin, cout)),
                "scale": view(flat, sc_off, (cout,)),
                "shift": view(flat, sh_off, (cout,))}

    def read(off, h, w, c, pool):
        x = view(arena, off, (B, 2 * h, 2 * w, c) if pool else (B, h, w, c))
        return kcn._pool_plain(x) if pool else x

    for a, b in plan.stages:
        writes = []
        for op in plan.ops[a:b]:
            h, w, cin, cout = op["h"], op["w"], op["cin"], op["cout"]
            lay = layer(op["w_off"], op["sc_off"], op["sh_off"], op["k"],
                        cin, cout)
            if op["kind"] == kcn.UPCONV:
                x = read(op["in_off"], h // 2, w // 2, cin, False)
                skip = view(arena, op["res_off"], (B, h, w, cout))
                writes.append((op["out_off"], kcn._upconv_plain(x, lay,
                                                                skip)))
                continue
            x = bev if op["in_src"] == kcn.SRC_BEV else \
                read(op["in_off"], h, w, cin, op["in_pool"])
            if op["kind"] == kcn.HEADS:
                hid = kcn._conv_plain(x, lay, relu=True)
                hm = kcn._conv_plain(hid[..., :32], layer(
                    op["h1_w_off"], op["h1_sc_off"], op["h1_sh_off"], 1, 32,
                    1))
                size = kcn._conv_plain(hid[..., 32:], layer(
                    op["h2_w_off"], op["h2_sc_off"], op["h2_sh_off"], 1, 32,
                    2))
                writes += [(op["out_off"], hm), (op["out2_off"], size)]
                continue
            res = None
            if op["res_kind"] == kcn.RES_ADD:
                res = view(arena, op["res_off"], (B, h, w, cout))
            elif op["res_kind"] == kcn.RES_PROJ:
                p = read(op["p_in_off"], h, w, op["p_cin"], op["p_pool"])
                res = kcn._conv_plain(p, layer(
                    op["p_w_off"], op["p_sc_off"], op["p_sh_off"], 1,
                    op["p_cin"], cout))
            writes.append((op["out_off"], kcn._conv_plain(
                x, lay, res=res, relu=bool(op["relu"]))))
        for off, y in writes:
            arena[off:off + y.numel()] = y.reshape(-1)
    return kcn.outputs(plan, arena)


# -- the schedule --------------------------------------------------------------

def _tile_outputs(op):
    """(n, y, x, c) index arrays of every output the op's tiles store, as
    the kernel maps tiles to blocks and outputs to the lanes of the warps
    of K group 0 (one entry per store)."""
    th, tw, tn, wk, wn = op["th"], op["tw"], op["tn"], op["wk"], op["wn"]
    dy, dx, dc = [], [], []
    for wid in range(kcn.WARPS):
        kg, rest = wid % wk, wid // wk
        if kg:
            continue
        ng, mg = rest % wn, rest // wn
        for lane in range(32):
            pr = (mg // op["wmc"]) * 4
            pc = (mg % op["wmc"]) * 8 + (lane & 7)
            wc = ng * 16 + (lane >> 3) * 4
            for i in range(4):
                for c in range(4):
                    dy.append(pr + i)
                    dx.append(pc)
                    dc.append(wc + c)
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
def test_tiles_cover_every_output_once(shape):
    plan = kcn.centernet_plan(*shape)
    assert len(plan.stages) == 16
    for op in plan.ops:
        n, y, x, c = _tile_outputs(op)
        count = np.zeros((op["b"], op["h"], op["w"], op["cout"]), np.int64)
        np.add.at(count, (n, y, x, c), 1)
        assert count.min() == 1 and count.max() == 1, op["name"]
        assert op["th"] * op["tw"] == 32 * op["wmr"] * op["wmc"]
        assert op["wmr"] * op["wmc"] * op["wn"] * op["wk"] == kcn.WARPS
        if op["kind"] == kcn.HEADS:        # all 64 channels in one tile
            assert op["tn"] == op["cout"] == 64


def _ranges(plan, op, which):
    B, h, w = op["b"], op["h"], op["w"]
    out = []
    if which == "write":
        if op["kind"] == kcn.HEADS:
            return [(op["out_off"], B * h * w), (op["out2_off"], 2 * B * h * w)]
        return [(op["out_off"], B * h * w * op["cout"])]
    if op["in_src"] == kcn.SRC_ARENA:
        scale = 4 if op["in_pool"] else (
            0.25 if op["kind"] == kcn.UPCONV else 1)
        out.append((op["in_off"], int(B * h * w * op["cin"] * scale)))
    if op["res_kind"] in (kcn.RES_ADD, kcn.RES_SKIP):
        out.append((op["res_off"], B * h * w * op["cout"]))
    if op["res_kind"] == kcn.RES_PROJ:
        scale = 4 if op["p_pool"] else 1
        out.append((op["p_in_off"], B * h * w * op["p_cin"] * scale))
    return out


def _overlap(a, b):
    return a[0] < b[0] + b[1] and b[0] < a[0] + a[1]


@pytest.mark.parametrize("shape", SHAPES)
def test_stages_and_arena(shape):
    plan = kcn.centernet_plan(*shape)
    for a, b in plan.stages:
        writes = [r for op in plan.ops[a:b] for r in _ranges(plan, op,
                                                              "write")]
        reads = [r for op in plan.ops[a:b] for r in _ranges(plan, op, "read")]
        assert not any(_overlap(w, r) for w in writes for r in reads)
        assert not any(_overlap(w, v) for i, w in enumerate(writes)
                       for v in writes[i + 1:])
    for i, p in enumerate(plan.bufs):
        size = int(np.prod(p.shape))
        assert p.off % kcn.ALIGN == 0
        assert p.off + size <= plan.arena_floats
        for q in plan.bufs[i + 1:]:
            live = p.write <= q.last_read and q.write <= p.last_read
            if live:
                assert not _overlap((p.off, size),
                                    (q.off, int(np.prod(q.shape)))), \
                    (p.name, q.name)
    # a buffer is read only in stages after the one that writes it
    for op in plan.ops:
        for off, _ in _ranges(plan, op, "read"):
            src = next(b for b in plan.bufs if b.off == off
                       and b.write < op["stage"] <= b.last_read)
            assert src is not None


@pytest.mark.parametrize("shape", SHAPES)
def test_shared_memory_fits_a_block(shape):
    plan = kcn.centernet_plan(*shape)
    assert plan.smem_bytes <= kcn.MAX_SMEM
    assert plan.smem_bytes == max(op["smem"] for op in plan.ops)
    for op in plan.ops:
        assert op["smem"] <= kcn.SMEM_TARGET
        # 8 lanes reading 8 neighbouring staged pixels hit 8 bank quads
        for xs in (op["xs"], op["xsp"]):
            assert xs == 0 or ((xs // 4) % 2 == 1 and xs % 4 == 0)
        assert op["ck"] % 4 == 0 and op["xf"] % 4 == 0


@pytest.mark.parametrize("J", [15, 17])
def test_weight_offsets_are_aligned(J):
    """Every weight, scale and shift the kernel reads 16 bytes at a time
    starts on a 16-byte boundary of the flat buffer (the heads' 1x1 convs,
    read one float at a time, come last)."""
    offs = kcn.weight_offsets(J)
    for path, shape in kcn.weight_entries(J):
        if path[0] not in ("hm1", "size1"):
            assert offs[path] % 4 == 0, path
    packed = pack_centernet(_net(J))
    assert packed["flat"].numel() == offs["total"]
    for path, _ in kcn.weight_entries(J):
        t = kcn._get(packed, path)
        assert t.data_ptr() == packed["flat"].data_ptr() + 4 * offs[path]


def test_op_table_matches_the_kernel_enum():
    src = (_build.CSRC / "centernet.cu").read_text()
    body = re.search(r"enum Field \{(.*?)\};", src, re.S).group(1)
    names = [f.strip() for f in body.split(",") if f.strip()]
    assert names == ["F_" + f.upper() for f in kcn.OP_FIELDS]
    assert re.search(r"constexpr int kOpW = (\d+);", src).group(1) == \
        str(kcn.OPW)
    plan = kcn.centernet_plan(1, 16, 16, 15)
    assert len(plan.table()) == kcn.OPW * len(plan.ops)
    assert len(plan.stage_table()) == 2 * len(plan.stages)


# -- the arithmetic ------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
def test_merged_heads_match_plain(shape):
    packed = pack_centernet(_net(shape[-1]))
    bev = _bev(shape)
    with torch.no_grad():
        hm, size = kcn.centernet_plain(packed, bev)
        x = kcn._trunk(packed, bev, kcn.PLAIN)
        # the kernel's heads: one 32 -> 64 conv, its first 32 channels into
        # hm1, the last 32 into size1
        hid = kcn._conv_plain(x, packed["heads"], relu=True)
        hm_m = kcn._conv_plain(hid[..., :32], packed["hm1"])
        size_m = kcn._conv_plain(hid[..., 32:], packed["size1"])
    torch.testing.assert_close(hm_m, hm, rtol=0, atol=1e-6)
    torch.testing.assert_close(size_m, size, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_schedule_matches_plain(shape):
    packed = pack_centernet(_net(shape[-1], seed=shape[0]))
    bev = _bev(shape, seed=shape[1])
    plan = kcn.centernet_plan(*shape)
    with torch.no_grad():
        hm, size = kcn.centernet_plain(packed, bev)
        hm_e, size_e = emulate(plan, packed["flat"], bev)
    for got, ref in ((hm_e, hm), (size_e, size)):
        assert got.shape == ref.shape and torch.isfinite(got).all()
        scale = float(ref.abs().max())
        assert scale > 0
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-5 * scale)


def test_fused_schedule_matches_flax(rng):
    """The harness of tests/test_torch_nets.py: flax CenterNet with the
    reference package's perturbed variables, the port model converted from
    them, the emulation on its packed weights; float32 on both sides."""
    from tests.test_torch_nets import perturbed_variables, port_model, \
        small_cfg

    cfg = small_cfg()
    variables = perturbed_variables(cfg, 5)
    model = port_model(cfg, variables)
    vol = rng.rand(1, 16, 16, 8, 15).astype(np.float32)
    hm_r, size_r = FlaxCenterNet().apply(_sub(variables, "center_net"),
                                         jnp.asarray(vol), train=False)
    packed = pack_model(model)["center_net"]
    bev = torch.from_numpy(vol).amax(dim=3)
    with torch.no_grad():
        hm, size = emulate(kcn.centernet_plan(*bev.shape), packed["flat"],
                           bev)
    assert hm.shape == hm_r.shape and size.shape == size_r.shape
    _close(hm, hm_r, 1e-4)
    _close(size, size_r, 1e-4)


def test_launch_arguments_match_the_entry_points(monkeypatch):
    """The wrappers' launches, driven on CPU tensors with the device checks
    switched off, pass each C entry point the arguments its ctypes
    signature declares (the stream is added by Kernel)."""
    from fvp_torch.ops.kernels import Kernel
    from fvp_torch.ops.kernels import sampler as ksamp
    from tests.test_torch_person_plan import _inputs

    calls = []
    monkeypatch.setattr(Kernel, "__call__",
                        lambda self, *a: calls.append((self.fn, a)))
    for mod in (kcn, ksamp):
        monkeypatch.setattr(mod, "check", lambda *a, **k: None)
    packed = pack_centernet(_net(15))
    plan = kcn.centernet_plan(1, 16, 16, 15)
    arena = torch.empty(plan.arena_floats)
    kcn.launch(packed, _bev((1, 16, 16, 15)), arena)
    kcn.launch(packed, _bev((1, 16, 16, 15)), arena, 3, 4)
    cfg, rc, hm, centers, bbox, mask = _inputs(15, 16)
    corner, start, end, _ = ksamp.person_bounds(centers, bbox, mask, cfg)
    ksamp.sample_planes(ksamp.pixel_major_plain(hm), rc, cfg, corner, start,
                        end, 15)
    assert [c[0] for c in calls] == ["fvp_centernet"] * 2 + \
        ["fvp_person_planes"]
    for fn, args in calls:
        assert len(args) + 1 == len(_build.SIGNATURES[fn]), fn
    assert calls[0][1][5:] == (0, 16, plan.max_tiles, plan.smem_bytes, 1)
    assert calls[1][1][5:8] == (3, 4, sum(
        op["tiles"] for op in plan.ops[plan.stages[3][0]:plan.stages[3][1]]))
    assert calls[1][1][-1] == 0                        # one stage: no barrier
