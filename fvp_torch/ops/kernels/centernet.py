"""Wrapper of K3 `centernet` (csrc/centernet.cu), with its plain version.

`centernet_forward(packed, bev)` runs CenterNet on the BEV map (B, X, Y, J)
and returns (hm (B, X, Y, 1), size (B, X, Y, 2)). A CPU tensor takes the
plain version, `centernet_plain`, layer by layer in PyTorch; a CUDA tensor
launches the kernel once or raises.

The kernel is persistent: one cooperative launch walks the net as the
stages of `centernet_plan`, with a grid-wide barrier between stages. Ops
that do not depend on each other share a stage (a ResBlock's first conv
beside the next level's, the skip branch beside the encoder). Fusions:
- the 2x2 max pool is taken as the conv that reads it stages its input,
  so a pooled map is never written;
- a ResBlock's 1x1 projection is an extra K segment of its second conv's
  tile, with its own accumulators and affine, added where the plain
  version adds it;
- an up-conv adds its skip in its epilogue;
- the two heads' 3x3 convs are one 32 -> 64 conv (`packed["heads"]`,
  packed once at load time) whose tile holds all 64 channels of its
  pixels, and their 1x1 convs (32 -> 1, 32 -> 2) run in its epilogue.
Each stage is a list of output tiles (a patch of pixels x a slice of
output channels, split over the block's 8 warps by pixel block, channel
block and K group). `centernet_plan` is the tiling, in Python on shapes
alone, so that the CPU tests can check it; the kernel reads it as two
int32 tables (ops, stages). `packed["flat"]` holds every weight in one
float32 buffer (engine/packing.py::pack_centernet), the intermediates live
in one arena the wrapper allocates with torch.empty, and hm and size are
views into it.

`centernet_bf16` is the bf16 route that `compute_dtype='bfloat16'` takes:
the arithmetic of the TPU kernel (fvp_tpu/ops/pallas/hourglass.py::
_centernet_kernel), which computes in bf16 inside. It runs the hourglass
body on the bf16 conv kernels of csrc/conv_bf16.cu, as the `fuse_p2p`
P2PNet does (ops/kernels/hourglass.py::body: the same rounding points),
then the two heads' 3x3 convs as one 32 -> 64 conv rounded to bf16 after
its bias and ReLU, and their 1x1 convs as one 64 -> 3 conv (block-diagonal
weights) that sums in float32 and adds its float32 bias: 24 conv launches
and 2 pools a call. Its `packed` comes from
engine/packing.py::pack_centernet_bf16.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import NamedTuple

import torch
import torch.nn.functional as F

from fvp_torch.ops.kernels import Kernel, check, ptr
from fvp_torch.ops.kernels import conv_bf16, hourglass

CENTERNET = Kernel("centernet", "fvp_centernet")
CONV_BF16 = conv_bf16.conv_kernel("centernet_bf16.conv")
POOL_BF16 = conv_bf16.pool_kernel("centernet_bf16.pool")
_CUDA_BF16 = conv_bf16.make_ops(CONV_BF16, POOL_BF16)

THREADS = 256
WARPS = THREADS // 32
H100_SMS = 132
MAX_SMEM = 232448        # dynamic shared memory one block may use
# a tile's shared memory is held under this (the tilings were tuned with
# it; the kernel runs one block per SM)
SMEM_TARGET = 113 * 1024
ALIGN = 64               # arena buffers start on 256-byte boundaries

_ENC = ("skip_res1", "encoder_res1", "skip_res2", "encoder_res2", "mid_res",
        "decoder_res2", "decoder_res1")

# The fields of one op of the kernel's op table, in the order of the enum
# `Field` in csrc/centernet.cu (tests/test_torch_centernet_plan.py checks
# that the two agree).
OP_FIELDS = (
    "kind", "k", "h", "w", "cin", "cout",
    "in_src", "in_off", "in_pool", "w_off", "sc_off", "sh_off", "relu",
    "res_kind", "res_off",
    "p_in_off", "p_cin", "p_pool", "p_w_off", "p_sc_off", "p_sh_off",
    "out_off", "out2_off",
    "h1_w_off", "h1_sc_off", "h1_sh_off", "h2_w_off", "h2_sc_off",
    "h2_sh_off",
    "th", "tw", "tn", "wmr", "wmc", "wn", "wk", "ck", "ckp",
    "tiles_y", "tiles_x", "tiles_c", "tiles", "xs", "xsp", "xf", "wf")
OPW = 48                 # ints per op in the table
assert len(OP_FIELDS) <= OPW

CONV, UPCONV, HEADS = 0, 1, 2                    # op kinds
RES_NONE, RES_ADD, RES_PROJ, RES_SKIP = 0, 1, 2, 3
SRC_BEV, SRC_ARENA = 0, 1


# -- plain versions (NHWC in and out) ---------------------------------------

def _conv_plain(x, layer, res=None, relu=False):
    w = layer["w"]                                   # (k, k, Cin, Cout)
    k = w.shape[0]
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=k // 2)
    y = y.permute(0, 2, 3, 1) * layer["scale"] + layer["shift"]
    if res is not None:
        y = y + res
    return torch.relu(y) if relu else y


def _pool_plain(x):
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def _upconv_plain(x, layer, skip):
    w = layer["w"]                                   # (2, 2, Cin, Cout)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w.permute(2, 3, 0, 1),
                           stride=2)
    y = torch.relu(y.permute(0, 2, 3, 1) * layer["scale"] + layer["shift"])
    return y + skip


PLAIN = SimpleNamespace(conv=_conv_plain, pool=_pool_plain,
                        upconv=_upconv_plain)


def _res(x, r, ops):
    """conv3-aff-relu, conv3-aff, + (1x1 proj-aff) skip, relu at the join."""
    h = ops.conv(x, r["c0"], relu=True)
    skip = ops.conv(x, r["proj"]) if r["proj"] is not None else x
    return ops.conv(h, r["c1"], res=skip, relu=True)


def _trunk(packed, bev, ops):
    """Front, ResBlock and encoder-decoder: (B, X, Y, J) -> (B, X, Y, 32)."""
    x = ops.conv(bev, packed["front"], relu=True)
    x = _res(x, packed["res0"], ops)
    e = packed["enc"]
    skip1 = _res(x, e["skip_res1"], ops)
    x = _res(ops.pool(x), e["encoder_res1"], ops)
    skip2 = _res(x, e["skip_res2"], ops)
    x = _res(ops.pool(x), e["encoder_res2"], ops)
    x = _res(x, e["mid_res"], ops)
    x = _res(x, e["decoder_res2"], ops)
    x = ops.upconv(x, e["decoder_upsample2"], skip2)
    x = _res(x, e["decoder_res1"], ops)
    return ops.upconv(x, e["decoder_upsample1"], skip1)


def centernet_plain(packed: dict, bev: torch.Tensor):
    """Plain version of K3 on any device: (B, X, Y, J) -> (hm (B, X, Y, 1),
    size (B, X, Y, 2))."""
    x = _trunk(packed, bev, PLAIN)
    hm = _conv_plain(_conv_plain(x, packed["hm0"], relu=True), packed["hm1"])
    size = _conv_plain(_conv_plain(x, packed["size0"], relu=True),
                       packed["size1"])
    return hm, size


# -- the packed weights as one buffer ----------------------------------------

def weight_entries(J: int) -> list[tuple[tuple[str, ...], tuple[int, ...]]]:
    """(path in the packed dict, shape) of every weight the kernel reads, in
    the order of packed["flat"]."""
    out = []

    def layer(path, k, cin, cout):
        out.append((path + ("w",), (k, k, cin, cout)))
        out.append((path + ("scale",), (cout,)))
        out.append((path + ("shift",), (cout,)))

    def res(path, cin, cout):
        layer(path + ("c0",), 3, cin, cout)
        layer(path + ("c1",), 3, cout, cout)
        if cin != cout:
            layer(path + ("proj",), 1, cin, cout)

    layer(("front",), 7, J, 16)
    res(("res0",), 16, 32)
    chans = {"skip_res1": (32, 32), "encoder_res1": (32, 64),
             "skip_res2": (64, 64), "encoder_res2": (64, 128),
             "mid_res": (128, 128), "decoder_res2": (128, 128),
             "decoder_res1": (64, 64)}
    for name in _ENC:
        res(("enc", name), *chans[name])
    layer(("enc", "decoder_upsample2"), 2, 128, 64)
    layer(("enc", "decoder_upsample1"), 2, 64, 32)
    layer(("heads",), 3, 32, 64)
    layer(("hm1",), 1, 32, 1)
    layer(("size1",), 1, 32, 2)
    return out


@functools.lru_cache(maxsize=None)
def weight_offsets(J: int) -> dict:
    """path -> float offset in packed["flat"], and "total"."""
    offs, o = {}, 0
    for path, shape in weight_entries(J):
        offs[path] = o
        n = 1
        for s in shape:
            n *= s
        o += n
    offs["total"] = o
    return offs


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def flatten_weights(packed: dict) -> dict:
    """Adds packed["flat"], one float32 buffer of every weight in the order
    of weight_entries, and makes each packed weight a view into it."""
    J = packed["front"]["w"].shape[2]
    parts = []
    for path, shape in weight_entries(J):
        t = _get(packed, path)
        if tuple(t.shape) != shape:
            raise ValueError(f"centernet weight {path}: {tuple(t.shape)}, "
                             f"expected {shape}")
        parts.append(t.reshape(-1).float())
    flat = torch.cat(parts)
    offs = weight_offsets(J)
    for path, shape in weight_entries(J):
        o = offs[path]
        n = flat[o:o + _get(packed, path).numel()]
        _get(packed, path[:-1])[path[-1]] = n.view(shape)
    packed["flat"] = flat
    return packed


# -- the plan -----------------------------------------------------------------

class Buf(NamedTuple):
    name: str
    shape: tuple          # (B, H, W, C)
    off: int              # float offset in the arena
    write: int            # stage that writes it
    last_read: int        # last stage that reads it (or the last stage)


class Plan(NamedTuple):
    B: int
    H: int
    W: int
    J: int
    ops: tuple            # one dict per op (OP_FIELDS, "name", "stage", "b",
                          # "smem")
    stages: tuple         # (first op, end op) per stage
    bufs: tuple           # Buf, in order of first write
    arena_floats: int
    smem_bytes: int       # the kernel's dynamic shared memory
    max_tiles: int        # the most tiles of any stage

    def table(self) -> list[int]:
        """The op table, OPW ints per op."""
        out = []
        for op in self.ops:
            row = [int(op[f]) for f in OP_FIELDS]
            out += row + [0] * (OPW - len(row))
        return out

    def stage_table(self) -> list[int]:
        return [i for s in self.stages for i in s]

    def buf(self, name: str) -> Buf:
        return next(b for b in self.bufs if b.name == name)


def round4(c: int) -> int:
    return (c + 3) // 4 * 4


def xstride(ck: int) -> int:
    """Floats per pixel of a staged input patch: ck channels padded so that
    the stride in 16-byte units is odd (8 lanes reading 8 neighbouring
    pixels then hit 8 distinct bank quads)."""
    return ck if (ck // 4) % 2 else ck + 4


def _tile_cost(kind, k, cin, cout, p_cin, B, H, W, wmr, wmc, wn, wk, sms):
    """Relative time of one op at this tiling: tiles per SM (rounded up)
    times one tile's time, in units of one warp's K step (64 FMAs a
    thread), with its staging (16-byte copies spread over 256 threads)
    and a fixed cost for the reduction, epilogue and barrier."""
    th, tw, tn = 4 * wmr, 8 * wmc, 16 * wn
    tiles = B * -(-H // th) * -(-W // tw) * (cout // tn)
    if kind == UPCONV:
        steps = cin // 4
        staged = (th // 2) * (tw // 2) * cin + 4 * cin * tn
    else:
        steps = k * k * round4(cin) // 4 + p_cin // 4
        staged = ((th + k - 1) * (tw + k - 1) * round4(cin) + k * k
                  * round4(cin) * tn + th * tw * p_cin + p_cin * tn)
    per_tile = steps / wk + staged / (4 * THREADS) / 4 + 24 + 8 * (wk > 1)
    return -(-tiles // sms) * per_tile, tiles


def _smem_floats(kind, k, th, tw, tn, wk, ck, ckp, p_cin, nch):
    """(xs, xsp, xf, wf, total floats) of one op's tiles: two staging
    buffers (one for a single chunk), or the K groups' partial sums and the
    heads' hidden tile, whichever is larger."""
    xs, xsp = xstride(ck), xstride(ckp) if p_cin else 0
    if kind == UPCONV:
        xf = (th // 2) * (tw // 2) * xs
        wf = 4 * ck * tn
    else:
        xf = (th + k - 1) * (tw + k - 1) * xs
        wf = k * k * ck * tn
    if p_cin:
        xf, wf = max(xf, th * tw * xsp), max(wf, ckp * tn)
    staging = min(2, nch) * (xf + wf)
    red = (wk - 1) * th * tw * tn * (2 if p_cin else 1)
    hid = th * tw * 68 if kind == HEADS else 0
    return xs, xsp, xf, wf, max(staging, red + hid)


def _choose(op, B, sms):
    """The op's tiling: the cheapest of the warp arrangements whose shared
    memory stays under SMEM_TARGET (see _tile_cost)."""
    kind, k, cin, cout = op["kind"], op["k"], op["cin"], op["cout"]
    H, W, p_cin = op["h"], op["w"], op["p_cin"]
    best = None
    for wmr, wmc in ((1, 1), (2, 1), (1, 2), (2, 2), (4, 2), (2, 4)):
        for wn in (1, 2, 4):
            tn = 16 * wn
            if cout % tn or (kind == HEADS and tn != cout):
                continue
            wm = wmr * wmc
            if WARPS % (wm * wn):
                continue
            wk = WARPS // (wm * wn)
            th, tw = 4 * wmr, 8 * wmc
            if kind == UPCONV:
                ck = min(cin, 32)
            elif k == 7:
                ck = round4(cin)                      # the front: one chunk
            else:
                ck = min(round4(cin), 32 if tn <= 32 else 16)
            ckp = min(p_cin, 32)
            nch = -(-cin // ck) + (-(-p_cin // ckp) if p_cin else 0)
            steps = (cin // 4 if kind == UPCONV else k * k * ck // 4)
            if wk > steps:
                continue
            sm = _smem_floats(kind, k, th, tw, tn, wk, ck, ckp, p_cin, nch)
            if sm[-1] * 4 > SMEM_TARGET:
                continue
            cost, tiles = _tile_cost(kind, k, cin, cout, p_cin, B, H, W, wmr,
                                     wmc, wn, wk, sms)
            key = (cost, tiles)
            if best is None or key < best[0]:
                best = (key, dict(
                    th=th, tw=tw, tn=tn, wmr=wmr, wmc=wmc, wn=wn, wk=wk,
                    ck=ck, ckp=ckp, tiles_y=-(-H // th),
                    tiles_x=-(-W // tw), tiles_c=cout // tn, tiles=tiles,
                    xs=sm[0], xsp=sm[1], xf=sm[2], wf=sm[3],
                    smem=sm[4] * 4))
    if best is None:
        raise ValueError(f"centernet_plan: no tiling for {op['name']}")
    return best[1]


def _stages(J: int):
    """The net as stages of ops: (name, kind, k, cin, cout, level, input,
    pool, weights path, relu, residual (kind, buffer or proj input,
    proj pool), output)."""
    e = ("enc",)

    def res_c1(path, h, x, out, lvl, cin, cout, pool=False):
        if cin == cout:
            return (f"{path[-1]}.c1", CONV, 3, cout, cout, lvl, h, False,
                    path + ("c1",), True, (RES_ADD, x, False), out)
        return (f"{path[-1]}.c1+proj", CONV, 3, cout, cout, lvl, h, False,
                path + ("c1",), True, (RES_PROJ, x, pool), out)

    def c0(path, x, out, lvl, cin, cout, pool=False):
        return (f"{path[-1]}.c0", CONV, 3, cin, cout, lvl, x, pool,
                path + ("c0",), True, (RES_NONE, None, False), out)

    return [
        [("front", CONV, 7, J, 16, 0, "bev", False, ("front",), True,
          (RES_NONE, None, False), "x0")],
        [c0(("res0",), "x0", "r0h", 0, 16, 32)],
        [res_c1(("res0",), "r0h", "x0", "x1", 0, 16, 32)],
        [c0(e + ("skip_res1",), "x1", "s1h", 0, 32, 32),
         c0(e + ("encoder_res1",), "x1", "e1h", 1, 32, 64, pool=True)],
        [res_c1(e + ("skip_res1",), "s1h", "x1", "skip1", 0, 32, 32),
         res_c1(e + ("encoder_res1",), "e1h", "x1", "x2", 1, 32, 64,
                pool=True)],
        [c0(e + ("skip_res2",), "x2", "s2h", 1, 64, 64),
         c0(e + ("encoder_res2",), "x2", "e2h", 2, 64, 128, pool=True)],
        [res_c1(e + ("skip_res2",), "s2h", "x2", "skip2", 1, 64, 64),
         res_c1(e + ("encoder_res2",), "e2h", "x2", "x3", 2, 64, 128,
                pool=True)],
        [c0(e + ("mid_res",), "x3", "mh", 2, 128, 128)],
        [res_c1(e + ("mid_res",), "mh", "x3", "x4", 2, 128, 128)],
        [c0(e + ("decoder_res2",), "x4", "dh", 2, 128, 128)],
        [res_c1(e + ("decoder_res2",), "dh", "x4", "x5", 2, 128, 128)],
        [("decoder_upsample2", UPCONV, 2, 128, 64, 1, "x5", False,
          e + ("decoder_upsample2",), True, (RES_SKIP, "skip2", False),
          "x6")],
        [c0(e + ("decoder_res1",), "x6", "d1h", 1, 64, 64)],
        [res_c1(e + ("decoder_res1",), "d1h", "x6", "x7", 1, 64, 64)],
        [("decoder_upsample1", UPCONV, 2, 64, 32, 0, "x7", False,
          e + ("decoder_upsample1",), True, (RES_SKIP, "skip1", False),
          "x8")],
        [("heads", HEADS, 3, 32, 64, 0, "x8", False, ("heads",), True,
          (RES_NONE, None, False), "hm")],
    ]


@functools.lru_cache(maxsize=None)
def centernet_plan(B: int, H: int, W: int, J: int) -> Plan:
    """The kernel's schedule for a (B, H, W, J) BEV map, on shapes alone:
    stages of ops, each op's tiling, the arena's buffers and the kernel's
    shared memory. H and W must be multiples of 4 (two pooling levels)."""
    if H % 4 or W % 4 or H < 4 or W < 4:
        raise ValueError(f"centernet_plan: map {H}x{W}, needs multiples "
                         "of 4")
    spec = _stages(J)
    dims = {0: (H, W), 1: (H // 2, W // 2), 2: (H // 4, W // 4)}
    shapes, write, last = {}, {}, {}
    for s, stage in enumerate(spec):
        for (name, kind, k, cin, cout, lvl, x, pool, wpath, relu, res,
             out) in stage:
            h, w = dims[lvl]
            shapes[out] = (B, h, w, 1 if out == "hm" else cout)
            write[out] = s
            for r in (x, res[1]):
                if r is not None:
                    last[r] = s
    shapes["size"] = (B, H, W, 2)
    write["size"] = len(spec) - 1
    # arena: first fit by lifetimes [write, last read]; outputs live to the
    # end
    order = sorted(shapes, key=lambda n: write[n])
    placed, bufs = [], []
    for name in order:
        b, h, w, c = shapes[name]
        size = -(-(b * h * w * c) // ALIGN) * ALIGN
        lo, hi = write[name], last.get(name, len(spec) - 1)
        off, moved = 0, True
        while moved:                     # first fit among the live ones
            moved = False
            for o, n, l2, h2 in sorted(placed):
                if l2 <= hi and lo <= h2 and off < o + n and o < off + size:
                    off, moved = o + n, True
        placed.append((off, size, lo, hi))
        bufs.append(Buf(name, shapes[name], off, lo, hi))
    arena = max(o + n for o, n, _, _ in placed)
    boff = {b.name: b.off for b in bufs}
    woff = weight_offsets(J)

    ops, stages = [], []
    for s, stage in enumerate(spec):
        first = len(ops)
        for (name, kind, k, cin, cout, lvl, x, pool, wpath, relu, res,
             out) in stage:
            h, w = dims[lvl]
            op = dict.fromkeys(OP_FIELDS, 0)
            op.update(
                name=name, stage=s, kind=kind, k=k, b=B, h=h, w=w, cin=cin,
                cout=cout, in_src=SRC_BEV if x == "bev" else SRC_ARENA,
                in_off=0 if x == "bev" else boff[x], in_pool=int(pool),
                w_off=woff[wpath + ("w",)], sc_off=woff[wpath + ("scale",)],
                sh_off=woff[wpath + ("shift",)], relu=int(relu),
                res_kind=res[0], out_off=boff[out])
            if res[0] in (RES_ADD, RES_SKIP):
                op["res_off"] = boff[res[1]]
            elif res[0] == RES_PROJ:
                pp = wpath[:-1] + ("proj",)
                op.update(p_in_off=boff[res[1]], p_cin=shapes[res[1]][3],
                          p_pool=int(res[2]), p_w_off=woff[pp + ("w",)],
                          p_sc_off=woff[pp + ("scale",)],
                          p_sh_off=woff[pp + ("shift",)])
            if kind == HEADS:
                op.update(out2_off=boff["size"],
                          h1_w_off=woff[("hm1", "w")],
                          h1_sc_off=woff[("hm1", "scale")],
                          h1_sh_off=woff[("hm1", "shift")],
                          h2_w_off=woff[("size1", "w")],
                          h2_sc_off=woff[("size1", "scale")],
                          h2_sh_off=woff[("size1", "shift")])
            op.update(_choose(op, B, H100_SMS))
            ops.append(op)
        stages.append((first, len(ops)))
    smem = max(op["smem"] for op in ops)
    max_tiles = max(sum(op["tiles"] for op in ops[a:b]) for a, b in stages)
    return Plan(B, H, W, J, tuple(ops), tuple(stages), tuple(bufs), arena,
                smem, max_tiles)


# -- kernel launches ---------------------------------------------------------

_TABLES: dict = {}


def _tables(plan: Plan, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The plan's op and stage tables on the device (made once)."""
    key = (plan.B, plan.H, plan.W, plan.J, device)
    if key not in _TABLES:
        _TABLES[key] = (
            torch.tensor(plan.table(), dtype=torch.int32, device=device),
            torch.tensor(plan.stage_table(), dtype=torch.int32,
                         device=device))
    return _TABLES[key]


def launch(packed: dict, bev: torch.Tensor, arena: torch.Tensor,
           first: int = 0, end: int | None = None) -> None:
    """Run stages [first, end) of the map's plan on `arena`: one
    cooperative launch with a barrier between stages (one plain launch for
    a single stage)."""
    B, H, W, J = bev.shape
    plan = centernet_plan(B, H, W, J)
    end = len(plan.stages) if end is None else end
    check(bev, "bev")
    check(packed["flat"], "flat", (weight_offsets(J)["total"],),
          device=bev.device)
    check(arena, "arena", (plan.arena_floats,), device=bev.device)
    ops, stages = _tables(plan, bev.device)
    tiles = max(sum(op["tiles"] for op in plan.ops[a:b])
                for a, b in plan.stages[first:end])
    CENTERNET(ptr(bev), ptr(packed["flat"]), ptr(arena), ptr(ops),
              ptr(stages), first, end, tiles, plan.smem_bytes,
              int(end - first > 1))


def outputs(plan: Plan, arena: torch.Tensor):
    """(hm, size): views into the arena."""
    B, H, W = plan.B, plan.H, plan.W
    hm, size = plan.buf("hm"), plan.buf("size")
    return (arena[hm.off:hm.off + B * H * W].view(B, H, W, 1),
            arena[size.off:size.off + B * H * W * 2].view(B, H, W, 2))


def centernet_forward(packed: dict, bev: torch.Tensor):
    """CenterNet on the BEV map (B, X, Y, J) -> (hm (B, X, Y, 1), size
    (B, X, Y, 2)): the kernel for a CUDA tensor, the plain version for a
    CPU tensor."""
    if not bev.is_cuda:
        return centernet_plain(packed, bev)
    bev = bev.contiguous()
    plan = centernet_plan(*bev.shape)
    arena = torch.empty(plan.arena_floats, dtype=torch.float32,
                        device=bev.device)
    launch(packed, bev, arena)
    return outputs(plan, arena)


# -- the bf16 route ------------------------------------------------------------

def bf16_launches() -> int:
    return CONV_BF16.launches + POOL_BF16.launches


def run_bf16(packed: dict, bev: torch.Tensor, ops):
    """The bf16 CenterNet through `ops` (conv_bf16.PLAIN or the kernels'
    ops): (B, X, Y, J) -> (hm (B, X, Y, 1), size (B, X, Y, 2)) float32."""
    x = hourglass.body(packed, bev, ops)
    h = ops.conv(x, packed["heads"], relu=True)
    out = ops.conv(h, packed["out"], out_dtype=torch.float32)
    return out[..., :1].contiguous(), out[..., 1:].contiguous()


def centernet_bf16_plain(packed: dict, bev: torch.Tensor):
    """Plain version of the bf16 route, on any device."""
    return run_bf16(packed, bev, conv_bf16.PLAIN)


def centernet_bf16(packed: dict, bev: torch.Tensor):
    """CenterNet's bf16 route on the BEV map (B, X, Y, J) float32 -> (hm
    (B, X, Y, 1), size (B, X, Y, 2)) float32: the kernels for a CUDA
    tensor, the plain version for a CPU tensor. X and Y must divide by 4
    (two pools)."""
    if bev.shape[1] % 4 or bev.shape[2] % 4:
        raise ValueError(f"centernet_bf16: map {tuple(bev.shape[1:3])}, "
                         "needs multiples of 4")
    if not bev.is_cuda:
        return centernet_bf16_plain(packed, bev)
    return run_bf16(packed, bev.contiguous(), _CUDA_BF16)
