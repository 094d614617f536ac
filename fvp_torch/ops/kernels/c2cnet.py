"""Wrapper of the C2CNet kernel (csrc/c2cnet.cu), with its plain version:
the `fuse_p2p` lowering of the HDN's 1D height net.

Replaces fvp_tpu/ops/pallas/hourglass.py::pallas_c2cnet, which runs the
whole 1D hourglass for all columns in one grid step with the items on the
sublanes, so that each layer is one matrix product over all of them. The
kernel does the same on Hopper's tensor cores: one launch, and each layer
one implicit GEMM over every column of a CTA (rows: column x height,
K: taps x input channels, N: output channels) on `mma.sync` m16n8k16
(bf16 operands, float32 sums). A ResBlock's 1x1 projection shares the
GEMM of its first conv (extra B columns on the centre tap, their own
epilogue), and the 2x2 max pool runs in the epilogue of the conv before
it, so the 23 layers take 19 phases with a barrier after each.

Each CTA takes a few columns (at the flagship's 10 columns, 5 CTAs of 2)
and holds all of their activations in shared memory (bf16, (column,
height + halo, channels + 8) rows, zero halo rows, so a tap is a row
offset); it streams each layer's weights and affines into a ring of
two slots with bulk copies (the next layer's weights are in flight while
this one computes; one slot where a tall column leaves no room for two)
and ends each phase with a block barrier.
`c2cnet_plan` is the tiling and the phase table the kernel walks, in
Python on shapes alone, so that the CPU tests can check it.

Numerics are the TPU kernel's (`_c2c_kernel`): the input rounds to bf16;
each ResBlock's first conv rounds relu(aff(conv)); a projection skip stays
float32; the join relu(aff(conv) + skip) rounds, where an identity skip is
the bf16 input; each up-conv rounds relu(aff(.)), adds the bf16 skip and
rounds again; the 1x1 output conv adds its bias in float32. Products of
bf16 values are exact in float32, so only the order of the sums differs
from the plain version.

`packed` comes from engine/packing.py::pack_c2cnet: the layers as
{"w": (k, Cin, F) bf16, "aff": (2, F) float32} (an up-conv's "w" is
(2, Cin, F), w[r] the tap of output 2z + r), all of them views into two
flat buffers, "w_flat" and "aff_flat", in the order `layer_shapes` lists,
and "w_frag": every layer but the output conv in the order of the mma's B
fragments (`fragments`). The plain version is P2PNet's hourglass
(`hourglass.run`) on the 1D plain ops.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from fvp_torch.ops.kernels import Kernel, check, ptr
from fvp_torch.ops.kernels.conv_bf16 import PLAIN
from fvp_torch.ops.kernels.hourglass import run

C2C = Kernel("c2cnet", "fvp_c2cnet")
# the encoder-decoder's widths and the front's (models/blocks.py)
_C0, _C1, _C2, _FRONT = 32, 64, 128, 16

THREADS = 256
ITEM_TILES = 2           # n8 tiles of a warp's item (csrc kItemTiles)
MAX_SMEM = 232448        # shared memory one block may use
STATIC_SMEM = 24 * 26 * 4  # the kernel's static copy of the phase table
FRAG_BYTES = 256         # one n8 x k16 B fragment of a warp: 32 lanes x 8 B

# The fields of one phase of the kernel's table, in the order of the enum
# `Field` in csrc/c2cnet.cu (tests/test_torch_c2cnet_plan.py checks that
# the two agree). Offsets are bytes into shared memory unless named.
FIELDS = (
    "kind",       # CONV, UPCONV or FINAL
    "in_off", "in_stride", "in_rpc", "in_base",
    # input buffer, its row stride (elements), rows per column, and the
    # row of (z = 0, tap 0) in a column: halo - taps // 2
    "zl",         # height of the input level (GEMM rows per column)
    "taps", "csteps",  # taps, and 16-channel steps per tap (Cin / 16)
    "ncols", "fo",     # GEMM columns (F, or 2F for an up-conv), and F
    "out_off", "out_stride", "out_rpc",
    "res", "res_off",  # RES_*, and the bf16 skip's buffer (out's layout)
    "relu",
    "pool_off", "pool_rpc",  # the pooled output (-1: none), rows/column
    "proj",       # 1: a 1x1 projection shares this GEMM (output to P)
    "w_off", "pw_off",  # byte offsets into w_frag (final: w_flat index)
    "aff_off", "paff_off",  # float offsets into aff_flat
    "p_off")      # the float32 projection buffer
NF = 26                  # ints per phase in the table
assert len(FIELDS) <= NF
CONV, UPCONV, FINAL = 0, 1, 2
RES_NONE, RES_BF16, RES_PROJ = 0, 1, 2


def layer_shapes(J: int) -> list[tuple[str, int, int, int]]:
    """(name, taps, Cin, F) of every layer in the kernel's order."""
    def res(name, cin, f):
        out = [(f"{name}.c0", 3, cin, f), (f"{name}.c1", 3, f, f)]
        return out + ([(f"{name}.proj", 1, cin, f)] if cin != f else [])

    return ([("front", 7, J, _FRONT)] + res("res0", _FRONT, _C0)
            + res("skip_res1", _C0, _C0) + res("encoder_res1", _C0, _C1)
            + res("skip_res2", _C1, _C1) + res("encoder_res2", _C1, _C2)
            + res("mid_res", _C2, _C2) + res("decoder_res2", _C2, _C2)
            + [("decoder_upsample2", 2, _C2, _C1)]
            + res("decoder_res1", _C1, _C1)
            + [("decoder_upsample1", 2, _C1, _C0), ("final", 1, _C0, 1)])


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def gemm_shape(name: str, taps: int, cin: int, f: int, J: int
               ) -> tuple[int, int, int]:
    """(taps, padded Cin, columns) of a layer as the kernel's GEMM: an
    up-conv is one tap of 2F columns (column r F + f is output 2z + r);
    the front's J channels are padded to a multiple of 16."""
    if name.startswith("decoder_upsample"):
        return 1, cin, 2 * f
    return taps, _pad16(cin), f


# -- weights in fragment order -------------------------------------------------

def fragments(w: torch.Tensor, cin_pad: int) -> torch.Tensor:
    """A GEMM's weights (taps, Cin, columns) -> flat, in the order of the
    mma.m16n8k16 B fragments: [column tile of 8][k16 step][lane][4], lane
    (g, t) holding K rows 16 s + 2 t + {0, 1, 8, 9} of column 8 n + g,
    K = tap x cin_pad (zero rows where a tap has fewer channels). One
    column tile's fragments are contiguous, so a CTA's slice of columns
    is contiguous."""
    T, cin, nc = w.shape
    wp = w.new_zeros((T, cin_pad, nc))
    wp[:, :cin] = w
    S, NT = T * cin_pad // 16, nc // 8
    v = wp.reshape(S, 2, 4, 2, NT, 8)          # (s, h, t, e, n, g)
    return v.permute(4, 0, 5, 2, 1, 3).reshape(-1).contiguous()


def gemm_weights(name: str, w: torch.Tensor) -> torch.Tensor:
    """A packed layer's "w" as its GEMM's (taps, Cin, columns)."""
    if name.startswith("decoder_upsample"):
        return w.permute(1, 0, 2).reshape(1, w.shape[1], -1)
    return w


def frag_offsets(J: int) -> list[int]:
    """Byte offset in w_frag of each layer of layer_shapes but the last."""
    offs, off = [], 0
    for name, t, ci, f in layer_shapes(J)[:-1]:
        offs.append(off)
        taps, cinp, nc = gemm_shape(name, t, ci, f, J)
        off += taps * cinp * nc * 2
    return offs + [off]


def pack_fragments(layers: list[dict], J: int) -> torch.Tensor:
    """w_frag (bf16) of the packed layers in layer_shapes' order."""
    parts = []
    for (name, t, ci, f), lay in zip(layer_shapes(J)[:-1], layers):
        taps, cinp, _ = gemm_shape(name, t, ci, f, J)
        parts.append(fragments(gemm_weights(name, lay["w"]), cinp))
    return torch.cat(parts)


# -- the tiling -----------------------------------------------------------------

class C2CPlan(NamedTuple):
    """How one launch runs C2CNet on (N, Z, J) columns: `ctas` CTAs of
    `cols` columns each (the last may have fewer); a ring of `depth`
    weight slots of `slot_bytes` at shared offset 0, its mbarriers at
    `bar_off`, then the activation buffers (`buffers`: name -> (offset,
    bytes)); `smem` bytes in all. `phases` is the table the kernel walks
    (NF ints each): 19 GEMM phases and the output conv."""
    N: int
    Z: int
    J: int
    cols: int
    ctas: int
    depth: int
    slot_bytes: int
    bar_off: int
    x_off: int
    x_stride: int
    smem: int
    buffers: tuple
    phases: tuple

    @property
    def barriers(self) -> int:
        """Block barriers of a CTA after its set-up: one after the input,
        one per GEMM phase."""
        return len(self.phases)


def _col_bytes(Z: int, J: int) -> dict[str, int]:
    """bf16 elements per column of each activation buffer: A, B, H hold
    any level ((height + 2) rows of channels + 8), S1 and S2 the skips of
    levels 0 and 1, X the input with a 3-row halo."""
    gen = max((z + 2) * (c + 8) for z, c in
              ((Z, _C0), (Z // 2, _C1), (Z // 4, _C2)))
    return {"X": (Z + 6) * (_pad16(J) + 8), "A": gen, "B": gen, "H": gen,
            "S1": (Z + 2) * (_C0 + 8), "S2": (Z // 2 + 2) * (_C1 + 8)}


def _align(n: int, a: int = 128) -> int:
    return -(-n // a) * a


def phase_weight_bytes(ph: dict) -> tuple[int, int]:
    """Bytes of a GEMM phase's weights that a CTA copies: its conv's and
    its projection's."""
    nt = ph["ncols"] // 8
    return (nt * ph["taps"] * ph["csteps"] * FRAG_BYTES,
            nt * ph["csteps"] * FRAG_BYTES if ph["proj"] else 0)


def phase_slot_bytes(ph: dict) -> int:
    """A ring slot's bytes for a GEMM phase: the weights, then the whole
    (2, F) float32 affine of the conv and of its projection."""
    return sum(phase_weight_bytes(ph)) + \
        8 * ph["fo"] * (2 if ph["proj"] else 1)


def _layout(cols: int, Z: int, J: int, depth: int, slot: int):
    bar_off = depth * slot
    off = _align(bar_off + 8 * depth)
    bufs = {}
    for name, elems in _col_bytes(Z, J).items():
        bufs[name] = (off, _align(cols * elems * 2))
        off += bufs[name][1]
    bufs["P"] = (off, _align(cols * Z * _C0 * 4))
    return bar_off, bufs, off + bufs["P"][1]


def _phases(Z: int, J: int, bufs: dict) -> list[dict]:
    """The kernel's walk of the net: (buffer, level) of every input and
    output, the fused projections and pools, the weights' offsets."""
    shapes = layer_shapes(J)
    woff = frag_offsets(J)
    aoff, a = [], 0
    for _, _, _, f in shapes:
        aoff.append(a)
        a += 2 * f
    idx = {name: i for i, (name, *_r) in enumerate(shapes)}
    Zs = (Z, Z // 2, Z // 4)
    chans = {}                      # buffer -> channels of its tensor now
    out = []

    def stride(c):
        return c + 8

    def gemm(name, src, lvl, dst, relu, res=RES_NONE, res_buf=None,
             pool=None, proj=None, halo_in=1):
        i = idx[name]
        _, t, ci, f = shapes[i]
        taps, cinp, nc = gemm_shape(name, t, ci, f, J)
        up = name.startswith("decoder_upsample")
        zl = Zs[lvl]
        zo = 2 * zl if up else zl
        in_stride = _pad16(J) + 8 if src == "X" else stride(chans[src])
        ph = dict.fromkeys(FIELDS, 0)
        ph.update(
            kind=UPCONV if up else CONV, in_off=bufs[src][0],
            in_stride=in_stride, in_rpc=zl + 2 * halo_in,
            in_base=halo_in - (taps // 2), zl=zl, taps=taps,
            csteps=cinp // 16, ncols=nc, fo=f, out_off=bufs[dst][0],
            out_stride=stride(f), out_rpc=zo + 2, res=res,
            res_off=bufs[res_buf][0] if res == RES_BF16 else 0,
            relu=int(relu), pool_off=-1, pool_rpc=0, proj=0,
            w_off=woff[i], pw_off=0, aff_off=aoff[i], paff_off=0,
            p_off=bufs["P"][0])
        if pool is not None:
            ph.update(pool_off=bufs[pool][0], pool_rpc=zl // 2 + 2)
        if proj is not None:
            j = idx[proj]
            ph.update(proj=1, pw_off=woff[j], paff_off=aoff[j])
        chans[dst] = f
        if pool is not None:
            chans[pool] = f
        out.append(ph)

    def resblock(name, x, lvl, dst, cin, f, pool=None):
        proj = f"{name}.proj" if cin != f else None
        gemm(f"{name}.c0", x, lvl, "H", True, proj=proj)
        if proj:
            gemm(f"{name}.c1", "H", lvl, dst, True, RES_PROJ, pool=pool)
        else:
            gemm(f"{name}.c1", "H", lvl, dst, True, RES_BF16, x, pool=pool)

    gemm("front", "X", 0, "A", True, halo_in=3)
    resblock("res0", "A", 0, "B", _FRONT, _C0, pool="A")
    resblock("skip_res1", "B", 0, "S1", _C0, _C0)
    resblock("encoder_res1", "A", 1, "B", _C0, _C1, pool="A")
    resblock("skip_res2", "B", 1, "S2", _C1, _C1)
    resblock("encoder_res2", "A", 2, "B", _C1, _C2)
    resblock("mid_res", "B", 2, "A", _C2, _C2)
    resblock("decoder_res2", "A", 2, "B", _C2, _C2)
    gemm("decoder_upsample2", "B", 2, "A", True, RES_BF16, "S2")
    resblock("decoder_res1", "A", 1, "B", _C1, _C1)
    gemm("decoder_upsample1", "B", 1, "A", True, RES_BF16, "S1")
    fin = dict.fromkeys(FIELDS, 0)
    fin.update(kind=FINAL, in_off=bufs["A"][0], in_stride=stride(_C0),
               in_rpc=Z + 2, in_base=1, zl=Z, taps=1, csteps=_C0 // 16,
               ncols=1, fo=1, pool_off=-1,
               w_off=sum(t * ci * f for _, t, ci, f in shapes[:-1]),
               aff_off=aoff[-1])
    return out + [fin]


@functools.lru_cache(maxsize=None)
def c2cnet_plan(N: int, Z: int, J: int,
                depth: int | None = None) -> C2CPlan:
    """The tiling of one launch: the columns per CTA (as many as one CTA's
    shared memory holds beside a ring of `depth` slots, then balanced over
    the CTAs), the ring's depth (unless given: 2, or 1 where one column
    of height Z does not fit beside two slots, as from Z = 56 at J = 15;
    three ~99 KB slots never fit) and the shared-memory offsets. Z % 4 ==
    0."""
    if N < 1 or Z < 4 or Z % 4 or J < 1:
        raise ValueError(f"c2cnet_plan: N = {N}, Z = {Z} (a multiple of "
                         f"4), J = {J}")
    budget = MAX_SMEM - STATIC_SMEM
    probe = _phases(Z, J, {k: (0, 0) for k in
                           ("X", "A", "B", "H", "S1", "S2", "P")})
    slot = _align(max(phase_slot_bytes(ph) for ph in probe[:-1]))

    def most_cols(d):
        c = 0
        while c < N and _layout(c + 1, Z, J, d, slot)[2] <= budget:
            c += 1
        return c

    if depth is None:
        depth = 2 if most_cols(2) >= 1 else 1
    if depth not in (1, 2):
        raise ValueError(f"c2cnet_plan: depth = {depth}, not 1 or 2")
    cmax = most_cols(depth)
    if cmax < 1:
        raise ValueError(f"c2cnet_plan: one column of height {Z} does not "
                         f"fit in shared memory beside the weight ring")
    ctas = -(-N // cmax)
    cols = -(-N // ctas)
    bar_off, bufs, smem = _layout(cols, Z, J, depth, slot)
    phases = _phases(Z, J, bufs)
    table = tuple(tuple(ph[k] for k in FIELDS) + (0,) * (NF - len(FIELDS))
                  for ph in phases)
    return C2CPlan(N, Z, J, cols, ctas, depth, slot, bar_off, bufs["X"][0],
                   _pad16(J) + 8, smem, tuple(sorted(bufs.items())), table)


def phase_dicts(plan: C2CPlan) -> list[dict]:
    """The plan's phases as dicts of FIELDS."""
    return [dict(zip(FIELDS, row)) for row in plan.phases]


_TABLES: dict = {}


def _table(plan: C2CPlan, device) -> torch.Tensor:
    key = (plan, str(device))
    if key not in _TABLES:
        _TABLES[key] = torch.tensor(plan.phases, dtype=torch.int32,
                                    device=device).reshape(-1).contiguous()
    return _TABLES[key]


# -- plain version ------------------------------------------------------------

def c2cnet_plain(packed: dict, cols: torch.Tensor) -> torch.Tensor:
    """Plain version on any device: (N, Z, J) float32 -> (N, Z) float32,
    the hourglass of ops/kernels/hourglass.py on the 1D plain ops."""
    return run(packed, cols, PLAIN)[..., 0]


# -- kernel launch ------------------------------------------------------------

def c2cnet(packed: dict, cols: torch.Tensor) -> torch.Tensor:
    """C2CNet on proposal z-columns (N, Z, J) float32 -> (N, Z) float32
    height heatmaps: one kernel launch for a CUDA tensor, the plain version
    for a CPU tensor. Z must be a multiple of 4 (two pooling levels)."""
    if not cols.is_cuda:
        return c2cnet_plain(packed, cols)
    N, Z, J = cols.shape
    if Z % 4:
        raise ValueError(f"c2cnet: Z = {Z} is not a multiple of 4")
    cols = cols.contiguous()
    check(cols, "cols")
    shapes = layer_shapes(J)
    n_w = sum(t * ci * f for _, t, ci, f in shapes)
    n_aff = sum(2 * f for _, _, _, f in shapes)
    check(packed["w_flat"], "w_flat", (n_w,), dtype=torch.bfloat16,
          device=cols.device)
    check(packed["aff_flat"], "aff_flat", (n_aff,), device=cols.device)
    check(packed["w_frag"], "w_frag", (frag_offsets(J)[-1] // 2,),
          dtype=torch.bfloat16, device=cols.device)
    out = torch.empty((N, Z), dtype=torch.float32, device=cols.device)
    if N:
        launch(packed, cols, out, c2cnet_plan(N, Z, J))
    return out


def launch(packed: dict, cols: torch.Tensor, out: torch.Tensor,
           plan: C2CPlan) -> None:
    """One launch of the kernel on checked tensors."""
    C2C(ptr(cols), ptr(packed["w_frag"]), ptr(packed["w_flat"]),
        ptr(packed["aff_flat"]), ptr(_table(plan, cols.device)), ptr(out),
        plan.N, plan.Z, plan.J, plan.cols, len(plan.phases),
        plan.depth, plan.slot_bytes, plan.bar_off, plan.x_off, plan.x_stride,
        plan.smem)


# -- CPU emulation --------------------------------------------------------------
# The kernel's arithmetic on the CPU, walking the plan's table on a byte
# buffer that stands for each CTA's shared memory (the GEMM in k16 steps,
# each step's 16 products summed exactly and rounded toward zero to float32
# as the tensor core does, then added in float32 in K order; the
# projection's own accumulators on the centre tap; the pool and the halo
# rows in the epilogue; the output conv's fused multiply-adds in channel
# order). The kernel is bit for bit this emulation
# (tests/test_torch_kernels_cuda.py, chip_smoke.py), and the emulation is
# held against the plain version and the reference on the CPU
# (tests/test_torch_c2cnet_plan.py).

_BF = torch.bfloat16


def unfragment(frag, taps, cin_pad, ncols):
    """The inverse of `fragments`: (taps, cin_pad, ncols)."""
    S, NT = taps * cin_pad // 16, ncols // 8
    v = frag.reshape(NT, S, 8, 4, 2, 2)        # (n, s, g, t, h, e)
    return v.permute(1, 4, 3, 5, 0, 2).reshape(taps, cin_pad, ncols)


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
    phases = phase_dicts(plan)
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
    b1 = nt * ks * FRAG_BYTES
    W = unfragment(wfrag[ph["w_off"]:][:b1].view(_BF), taps, cinp,
                   8 * nt).float()
    if ph["proj"]:
        b2 = nt * csteps * FRAG_BYTES
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

    if ph["kind"] == UPCONV:
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
    if ph["res"] == RES_BF16:
        y = y + bfm[ph["res_off"] // 2 + row * ostr + cols_].float()
    elif ph["res"] == RES_PROJ:
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
