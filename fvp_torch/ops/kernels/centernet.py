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
_centernet_kernel), which computes in bf16 inside, rounding where the
`fuse_p2p` P2PNet rounds (ops/kernels/hourglass.py::body), then the two
heads' 3x3 convs as one 32 -> 64 conv rounded to bf16 after its bias and
ReLU, and their 1x1 convs as one 64 -> 3 conv (block-diagonal weights)
that sums in float32 and adds its float32 bias. A CUDA tensor launches
the persistent bf16 kernel (csrc/centernet_bf16.cu) once, on the stages
of `centernet_bf16_plan`; its plain version `centernet_bf16_plain` runs
the same ops layer by layer (`run_bf16` with conv_bf16.PLAIN), and
`run_bf16` with `_CUDA_BF16`, 24 conv and 2 pool launches on
csrc/conv_bf16.cu, is the route's earlier lowering, kept as a yardstick.
Its `packed` comes from engine/packing.py::pack_centernet_bf16.
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
# (Cin, Cout) of each ResBlock of the encoder-decoder
_CHANS = {"skip_res1": (32, 32), "encoder_res1": (32, 64),
          "skip_res2": (64, 64), "encoder_res2": (64, 128),
          "mid_res": (128, 128), "decoder_res2": (128, 128),
          "decoder_res1": (64, 64)}

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
    for name in _ENC:
        res(("enc", name), *_CHANS[name])
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


def _dims(H: int, W: int) -> dict:
    """The map's size at each of the net's three levels."""
    if H % 4 or W % 4 or H < 4 or W < 4:
        raise ValueError(f"centernet_plan: map {H}x{W}, needs multiples "
                         "of 4")
    return {0: (H, W), 1: (H // 2, W // 2), 2: (H // 4, W // 4)}


def _arena(spec, dims, B: int, heads_out: bool):
    """The arena's buffers (Buf, in order of first write) and its size in
    elements: first fit by lifetimes [write, last read], aligned to ALIGN
    elements. With `heads_out` the heads' outputs hm and size are buffers
    too, living to the end; without, they are not in the arena."""
    shapes, write, last = {}, {}, {}
    for s, stage in enumerate(spec):
        for (name, kind, k, cin, cout, lvl, x, pool, wpath, relu, res,
             out) in stage:
            h, w = dims[lvl]
            if out != "hm" or heads_out:
                shapes[out] = (B, h, w, 1 if out == "hm" else cout)
                write[out] = s
            for r in (x, res[1]):
                if r is not None:
                    last[r] = s
    if heads_out:
        shapes["size"] = (B, *dims[0], 2)
        write["size"] = len(spec) - 1
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
    return tuple(bufs), max(o + n for o, n, _, _ in placed)


@functools.lru_cache(maxsize=None)
def centernet_plan(B: int, H: int, W: int, J: int) -> Plan:
    """The kernel's schedule for a (B, H, W, J) BEV map, on shapes alone:
    stages of ops, each op's tiling, the arena's buffers and the kernel's
    shared memory. H and W must be multiples of 4 (two pooling levels)."""
    spec = _stages(J)
    dims = _dims(H, W)
    bufs, arena = _arena(spec, dims, B, heads_out=True)
    shapes = {b.name: b.shape for b in bufs}
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
    return Plan(B, H, W, J, tuple(ops), tuple(stages), bufs, arena,
                smem, max_tiles)


# -- kernel launches ---------------------------------------------------------

_TABLES: dict = {}


def _tables(plan: Plan, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The plan's op and stage tables on the device (made once)."""
    key = (type(plan), plan.B, plan.H, plan.W, plan.J, device)
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
#
# The persistent bf16 kernel (csrc/centernet_bf16.cu) walks the same stages
# as the float32 one (_stages), on tensor cores: a tile is th x 8 output
# pixels x tn channels, its th / 2 M fragments of 16 pixels (2 rows x 8
# columns; an up-conv's fragment is the 16 pixels of one output parity)
# split over the block's 8 warps as wm = th / 2 pixel fragments by wn =
# 8 / wm channel groups of nf n8 fragments each (no K groups: every warp
# sums its whole K in order).

CENTERNET_BF16 = Kernel("centernet_bf16", "fvp_centernet_bf16")

# The fields of one op of the bf16 kernel's op table, in the order of the
# enum `Field` in csrc/centernet_bf16.cu (tests/test_torch_bf16_plans.py
# checks that the two agree).
BF16_OP_FIELDS = (
    "kind", "k", "h", "w", "cin", "cinp", "cout",
    "in_src", "in_off", "in_pool", "w_off", "aff_off", "relu",
    "res_kind", "res_off",
    "p_in_off", "p_cin", "p_pool", "p_w_off", "p_aff_off",
    "out_off", "out2_off", "o_w_off", "o_aff_off",
    "th", "tw", "tn", "wm", "wn", "nf", "ck", "ckp",
    "tiles_y", "tiles_x", "tiles_c", "tiles", "xs", "xsp", "xf", "wf")
assert len(BF16_OP_FIELDS) <= OPW
HID_STRIDE = 72          # bf16 elements a pixel of the heads' hidden tile


def round16(c: int) -> int:
    return (c + 15) // 16 * 16


def bf16_layers(J: int) -> list[tuple[tuple[str, ...], int, int, int]]:
    """(path in the packed dict, taps, Cin, Cout) of every layer the bf16
    kernel reads, in the order of packed["wflat"] and packed["affflat"]."""
    out = []

    def res(path, cin, cout):
        out.append((path + ("c0",), 9, cin, cout))
        out.append((path + ("c1",), 9, cout, cout))
        if cin != cout:
            out.append((path + ("proj",), 1, cin, cout))

    out.append((("front",), 49, J, 16))
    res(("res0",), 16, 32)
    for name in _ENC:
        res(("enc", name), *_CHANS[name])
    out.append((("enc", "decoder_upsample2"), 4, 128, 64))
    out.append((("enc", "decoder_upsample1"), 4, 64, 32))
    out.append((("heads",), 9, 32, 64))
    out.append((("out",), 1, 64, 3))
    return out


@functools.lru_cache(maxsize=None)
def bf16_offsets(J: int) -> dict:
    """path -> (bf16 offset in packed["wflat"], float offset in
    packed["affflat"]); and the totals "w_total", "aff_total"."""
    offs, wo, ao = {}, 0, 0
    for path, taps, cin, cout in bf16_layers(J):
        offs[path] = (wo, ao)
        wo += taps * cout * round16(cin)
        ao += 2 * cout
    offs["w_total"], offs["aff_total"] = wo, ao
    return offs


def flatten_bf16(packed: dict) -> dict:
    """Adds what the bf16 kernel reads to a packed bf16 CenterNet
    (engine/packing.py::pack_centernet_bf16): packed["wflat"], every
    layer's bf16 weights as (taps, Cout, Cin rounded up to 16), taps
    row-major (an up-conv's tap 2 r + s), zero past Cin, so that a tile
    stages rows of input channels with 16-byte copies; packed["affflat"],
    every layer's float32 (scale, shift) rows (the heads' (1, bias)). The
    layers that the plain version reads stay as they are."""
    J = packed["front"]["w"].shape[1]
    ws, affs = [], []
    for path, taps, cin, cout in bf16_layers(J):
        lay = _get(packed, path)
        if lay["w"].numel() != taps * cin * cout or \
                tuple(lay["aff"].shape) != (2, cout):
            raise ValueError(f"centernet_bf16 layer {path}: w "
                             f"{tuple(lay['w'].shape)}, aff "
                             f"{tuple(lay['aff'].shape)}; expected {taps} "
                             f"taps of {cin} -> {cout}")
        w = lay["w"].reshape(taps, cin, cout).transpose(1, 2)
        wk = torch.zeros((taps, cout, round16(cin)), dtype=torch.bfloat16,
                         device=w.device)
        wk[:, :, :cin] = w
        ws.append(wk.reshape(-1))
        affs.append(lay["aff"].float().reshape(-1))
    packed["wflat"] = torch.cat(ws)
    packed["affflat"] = torch.cat(affs)
    return packed


class Bf16Plan(NamedTuple):
    B: int
    H: int
    W: int
    J: int
    ops: tuple            # one dict per op (BF16_OP_FIELDS, "name",
                          # "stage", "b", "smem")
    stages: tuple         # (first op, end op) per stage
    bufs: tuple           # Buf (offsets in bf16 elements), hm and size not
                          # among them: they go to the float32 output
    arena_elems: int      # bf16 elements of the arena
    smem_bytes: int
    max_tiles: int

    def table(self) -> list[int]:
        out = []
        for op in self.ops:
            row = [int(op[f]) for f in BF16_OP_FIELDS]
            out += row + [0] * (OPW - len(row))
        return out

    def stage_table(self) -> list[int]:
        return [i for s in self.stages for i in s]

    def buf(self, name: str) -> Buf:
        return next(b for b in self.bufs if b.name == name)


def xstride8(ck: int) -> int:
    """bf16 elements a row of a staged chunk (a pixel's ck channels, or an
    output channel's ck weights): padded so that the row's stride in
    16-byte units is odd, so the 8 rows of an ldmatrix phase hit 8
    distinct bank quads."""
    return ck if (ck // 8) % 2 else ck + 8


def _bf16_smem(kind, k, th, tw, tn, ck, ckp, p_cin, nch):
    """(xs, xsp, xf, wf, bytes) of one op's tiles. A staging buffer holds a
    chunk's input patch (xf elements, the larger of the main chunks' and
    the projection's) and then its weights; buffers are xf + wf apart (wf
    the larger weights of the two where they alternate). Two buffers (one
    for a single chunk); where one main chunk is followed by the
    projection's, the second buffer holds only the projection's weights
    after its patch. The heads' hidden tile lies past the first buffer
    (the block keeps that buffer's weights for its next tile)."""
    xs, xsp = xstride8(ck), xstride8(ckp) if p_cin else 0
    if kind == UPCONV:
        xf, wf = (th // 2) * (tw // 2) * xs, 4 * tn * xs
    else:
        xf, wf = (th + k - 1) * (tw + k - 1) * xs, k * k * tn * xs
    staging = min(2, nch) * (xf + wf)
    if p_cin:
        xf, wfp = max(xf, th * tw * xsp), tn * xsp
        if nch == 2:                    # one main chunk, the projection's
            staging = 2 * xf + wf + wfp
        else:
            wf = max(wf, wfp)
            staging = 2 * (xf + wf)
    hid = th * tw * HID_STRIDE if kind == HEADS else 0
    return xs, xsp, xf, wf, 2 * max(staging, xf + wf + hid)


def _choose_bf16(op, B, sms):
    """The op's tiling: th rows (2, 4 or 8) of 8 columns by tn channels,
    the input channels in one chunk of at most 128 where its staging fits
    SMEM_TARGET, else in chunks of 32 (the 7x7 front, whose 49 taps'
    weights fill the staging, in chunks of 16 where 32 do not fit), and
    the projection's in one more; the cheapest by tiles per SM (rounded
    up) times one tile's time,
    in units of one warp's k16 step (an A and B ldmatrix, nf mma), with
    its staging (16-byte copies spread over the block) and a fixed cost
    per chunk and per tile. An up-conv takes th = 8 (a fragment per
    parity), the heads all 64 channels in one tile (their 1x1 convs'
    epilogue)."""
    kind, k, cin, cout = op["kind"], op["k"], op["cin"], op["cout"]
    cinp, H, W, p_cin = op["cinp"], op["h"], op["w"], op["p_cin"]
    ckp = p_cin
    steps = (1 if kind == UPCONV else k * k) * (cinp // 16) + p_cin // 16
    chunks = (cinp, 32, 16) if op["in_src"] == SRC_BEV else (cinp, 32)
    best = None
    for th in (2, 4, 8):
        for tn in (16, 32, 64):
            wm = th // 2
            wn = WARPS // wm
            nf = tn // (8 * wn)
            if nf not in (1, 2, 4) or tn % (8 * wn) or cout % tn:
                continue
            if (kind == HEADS and tn != cout) or (kind == UPCONV and th != 8):
                continue
            # all input channels in one chunk where they fit (one round
            # trip to L2 a tile), else chunks of 32 (or the front's of 16)
            sm = None
            for ck in (c for c in chunks if c <= 128 and cinp % c == 0):
                nch = cinp // ck + (1 if p_cin else 0)
                sm = _bf16_smem(kind, k, th, 8, tn, ck, ckp, p_cin, nch)
                if sm[-1] <= SMEM_TARGET:
                    break
            if sm is None or sm[-1] > SMEM_TARGET:
                continue
            tiles = B * -(-H // th) * -(-W // 8) * (cout // tn)
            per_tile = (steps * (1 + nf) + nch * (sm[2] + sm[3])
                        / (THREADS * 8) * 4 + 16 * nch + 40)
            key = (-(-tiles // sms) * per_tile, tiles)
            if best is None or key < best[0]:
                best = (key, dict(
                    th=th, tw=8, tn=tn, wm=wm, wn=wn, nf=nf, ck=ck, ckp=ckp,
                    tiles_y=-(-H // th), tiles_x=-(-W // 8),
                    tiles_c=cout // tn, tiles=tiles, xs=sm[0], xsp=sm[1],
                    xf=sm[2], wf=sm[3], smem=sm[4]))
    if best is None:
        raise ValueError(f"centernet_bf16_plan: no tiling for {op['name']} "
                         f"({cin} -> {cout})")
    return best[1]


@functools.lru_cache(maxsize=None)
def centernet_bf16_plan(B: int, H: int, W: int, J: int) -> Bf16Plan:
    """The bf16 kernel's schedule for a (B, H, W, J) BEV map, on shapes
    alone: the stages of `_stages`, each op's tiling (`_choose_bf16`), the
    bf16 arena's buffers and the kernel's shared memory. H and W must be
    multiples of 4 (two pooling levels); raises where no tiling fits."""
    spec = _stages(J)
    dims = _dims(H, W)
    bufs, arena = _arena(spec, dims, B, heads_out=False)
    shapes = {b.name: b.shape for b in bufs}
    boff = {b.name: b.off for b in bufs}
    offs = bf16_offsets(J)
    ops, stages = [], []
    for s, stage in enumerate(spec):
        first = len(ops)
        for (name, kind, k, cin, cout, lvl, x, pool, wpath, relu, res,
             out) in stage:
            h, w = dims[lvl]
            op = dict.fromkeys(BF16_OP_FIELDS, 0)
            op.update(
                name=name, stage=s, kind=kind, k=k, b=B, h=h, w=w, cin=cin,
                cinp=round16(cin), cout=cout,
                in_src=SRC_BEV if x == "bev" else SRC_ARENA,
                in_off=0 if x == "bev" else boff[x], in_pool=int(pool),
                w_off=offs[wpath][0], aff_off=offs[wpath][1],
                relu=int(relu), res_kind=res[0])
            if res[0] in (RES_ADD, RES_SKIP):
                op["res_off"] = boff[res[1]]
            elif res[0] == RES_PROJ:
                pp = wpath[:-1] + ("proj",)
                op.update(p_in_off=boff[res[1]], p_cin=shapes[res[1]][3],
                          p_pool=int(res[2]), p_w_off=offs[pp][0],
                          p_aff_off=offs[pp][1])
            if kind == HEADS:
                op.update(out_off=0, out2_off=B * H * W,
                          o_w_off=offs[("out",)][0],
                          o_aff_off=offs[("out",)][1])
            else:
                op["out_off"] = boff[out]
            op.update(_choose_bf16(op, B, H100_SMS))
            ops.append(op)
        stages.append((first, len(ops)))
    smem = max(op["smem"] for op in ops)
    max_tiles = max(sum(op["tiles"] for op in ops[a:b]) for a, b in stages)
    return Bf16Plan(B, H, W, J, tuple(ops), tuple(stages), bufs, arena, smem,
                    max_tiles)


def launch_bf16(packed: dict, bev: torch.Tensor, arena: torch.Tensor,
                out: torch.Tensor, first: int = 0,
                end: int | None = None) -> None:
    """Run stages [first, end) of the map's bf16 plan on `arena` (bf16) and
    `out` (float32, hm then size): one cooperative launch with a barrier
    between stages (one plain launch for a single stage)."""
    B, H, W, J = bev.shape
    plan = centernet_bf16_plan(B, H, W, J)
    end = len(plan.stages) if end is None else end
    offs = bf16_offsets(J)
    check(bev, "bev")
    check(packed["wflat"], "wflat", (offs["w_total"],), dtype=torch.bfloat16,
          device=bev.device)
    check(packed["affflat"], "affflat", (offs["aff_total"],),
          device=bev.device)
    check(arena, "arena", (plan.arena_elems,), dtype=torch.bfloat16,
          device=bev.device)
    check(out, "out", (3 * B * H * W,), device=bev.device)
    ops, stages = _tables(plan, bev.device)
    tiles = max(sum(op["tiles"] for op in plan.ops[a:b])
                for a, b in plan.stages[first:end])
    CENTERNET_BF16(ptr(bev), ptr(packed["wflat"]), ptr(packed["affflat"]),
                   ptr(arena), ptr(out), ptr(ops), ptr(stages),
                   len(plan.ops), len(plan.stages), first, end, tiles,
                   plan.smem_bytes, int(end - first > 1))


def bf16_outputs(plan: Bf16Plan, out: torch.Tensor):
    """(hm, size): views into the float32 output."""
    n = plan.B * plan.H * plan.W
    return (out[:n].view(plan.B, plan.H, plan.W, 1),
            out[n:].view(plan.B, plan.H, plan.W, 2))


def bf16_launches() -> int:
    return CENTERNET_BF16.launches


def layered_bf16_launches() -> int:
    """Launches of the layer-by-layer bf16 route (`_CUDA_BF16`)."""
    return CONV_BF16.launches + POOL_BF16.launches


def run_bf16(packed: dict, bev: torch.Tensor, ops):
    """The bf16 CenterNet layer by layer through `ops`: conv_bf16.PLAIN
    (the plain version), or `_CUDA_BF16`, the 24 conv and 2 pool launches
    on csrc/conv_bf16.cu that the route took before its persistent kernel,
    kept as a yardstick and called by nothing on the model's path:
    (B, X, Y, J) -> (hm (B, X, Y, 1), size (B, X, Y, 2)) float32."""
    x = hourglass.body(packed, bev, ops)
    h = ops.conv(x, packed["heads"], relu=True)
    out = ops.conv(h, packed["out"], out_dtype=torch.float32)
    return out[..., :1].contiguous(), out[..., 1:].contiguous()


def centernet_bf16_plain(packed: dict, bev: torch.Tensor):
    """Plain version of the bf16 route, on any device."""
    return run_bf16(packed, bev, conv_bf16.PLAIN)


def centernet_bf16(packed: dict, bev: torch.Tensor):
    """CenterNet's bf16 route on the BEV map (B, X, Y, J) float32 -> (hm
    (B, X, Y, 1), size (B, X, Y, 2)) float32: one launch of the persistent
    bf16 kernel for a CUDA tensor, the plain version for a CPU tensor. X
    and Y must divide by 4 (two pools)."""
    if bev.shape[1] % 4 or bev.shape[2] % 4:
        raise ValueError(f"centernet_bf16: map {tuple(bev.shape[1:3])}, "
                         "needs multiples of 4")
    if not bev.is_cuda:
        return centernet_bf16_plain(packed, bev)
    bev = bev.contiguous()
    B, H, W, J = bev.shape
    plan = centernet_bf16_plan(B, H, W, J)
    arena = torch.empty(plan.arena_elems, dtype=torch.bfloat16,
                        device=bev.device)
    out = torch.empty(3 * B * H * W, dtype=torch.float32, device=bev.device)
    launch_bf16(packed, bev, arena, out)
    return bf16_outputs(plan, out)
