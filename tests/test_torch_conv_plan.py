"""The premises of the bf16 conv kernels' and the stem kernel's designs
(csrc/conv_bf16.cu, csrc/stem.cu), checked on the CPU with their Python
tilings (ops/kernels/conv_bf16.py::conv_plan, ops/kernels/stem.py::
stem_plan):

- conv_plan routes P2PNet's 23 convs and the bottleneck stage's 10 as the
  design says: all but P2PNet's 7x7 front (float32, Cin = 15) and 1x1
  output layer (F = 15) to conv_wgmma;
- its patches cover every output pixel once, ragged edges included, its K
  blocks partition (tap, channel) once, its B boxes the N columns once,
  and every plan fits a block's shared memory;
- a PyTorch emulation of conv_wgmma (shifted, zero-filled tap boxes, the K
  blocks in ring order, the epilogue per column) reproduces conv_plain and
  upconv_plain for every residual and output type;
- stem_plan's pooled tiles cover the map once, each conv tile covers its
  pool windows, and the zero-padded K (24 per kernel row, 176 in all) of
  the kernel's GEMM reproduces stem_plain.
"""

import math

import numpy as np
import pytest
import torch

from fvp_torch.engine.packing import pack_bottleneck_stage, pack_p2pnet
from fvp_torch.models.cnns import P2PNet
from fvp_torch.models.resnet import Bottleneck, _down
from fvp_torch.ops.kernels import conv_bf16 as kcv
from fvp_torch.ops.kernels import hourglass as khg
from fvp_torch.ops.kernels import stem as kst
from fvp_torch.ops.kernels import trunk as ktr

_BF, _F32 = torch.bfloat16, torch.float32


class _Shapes:
    """The three conv ops on shapes alone: each call recorded as the
    arguments conv_plan takes, outputs of the right shape (zeros)."""

    def __init__(self):
        self.calls = []

    def conv(self, x, layer, res=None, relu=False, out_dtype=_BF):
        N, H, W, Cin = x.shape
        T, _, Fo = layer["w"].shape
        self.calls.append((N, H, W, Cin, Fo, math.isqrt(T), 0))
        return torch.zeros((N, H, W, Fo), dtype=out_dtype)

    def upconv(self, x, layer, skip):
        N, H, W, Cin = x.shape
        self.calls.append((N, H, W, Cin, layer["w"].shape[-1], 1, 1))
        return torch.zeros(skip.shape, dtype=_BF)

    def pool(self, x):
        N, H, W, C = x.shape
        return torch.zeros((N, H // 2, W // 2, C), dtype=_BF)


def _layer1():
    mods = [Bottleneck(64, 64, 1, _down(64, 256, 1))]
    mods += [Bottleneck(256, 64, 1, None) for _ in range(2)]
    stage = torch.nn.Sequential(*mods).eval()
    return pack_bottleneck_stage(stage), ((64, True), (64, False),
                                          (64, False))


def test_conv_plan_routes_p2pnet_and_the_stage():
    rec = _Shapes()
    packed = pack_p2pnet(P2PNet(15).eval())
    khg.run(packed, torch.zeros((30, 64, 64, 15)), rec)
    p2p = [kcv.conv_plan(*c).route for c in rec.calls]
    assert len(p2p) == 23
    assert p2p[0] == p2p[-1] == "wmma"                  # front, output
    assert rec.calls[0][3] == 15 and rec.calls[-1][4] == 15
    assert p2p[1:-1] == ["wgmma"] * 21
    rec = _Shapes()
    packed, cfg = _layer1()
    ktr.run(torch.zeros((5, 128, 240, 64), dtype=_BF), packed, cfg, rec)
    assert [kcv.conv_plan(*c).route for c in rec.calls] == ["wgmma"] * 10
    # the M tiles the design counts on: layer1 1200, P2PNet level 0 960,
    # level 2 60 (fewer than the SMs: one CTA per tile, the rest idle)
    assert kcv.conv_plan(5, 128, 240, 64, 64, 3, 0).mtiles == 1200
    assert kcv.conv_plan(30, 64, 64, 16, 32, 3, 0).mtiles == 960
    lvl2 = kcv.conv_plan(30, 16, 16, 128, 128, 3, 0)
    assert lvl2.mtiles == lvl2.ctas == 60


# (N, H, W, Cin, F, k, mode): P2PNet's and layer1's widths, ragged maps,
# narrow maps (8 x 16 patches), every N tile and K block width
SHAPES = [(5, 128, 240, 64, 64, 3, 0), (5, 128, 240, 64, 256, 1, 0),
          (5, 128, 240, 256, 64, 1, 0), (30, 64, 64, 16, 32, 3, 0),
          (30, 32, 32, 32, 64, 1, 0), (30, 16, 16, 128, 128, 3, 0),
          (30, 16, 16, 128, 64, 1, 1), (30, 32, 32, 64, 32, 1, 1),
          (2, 13, 40, 32, 128, 3, 0), (1, 7, 5, 256, 16, 1, 0),
          (1, 3, 37, 256, 32, 1, 1), (2, 5, 9, 16, 16, 1, 1),
          (1, 1, 1, 16, 16, 3, 0), (2, 19, 21, 16, 64, 1, 0)]


@pytest.mark.parametrize("shape", SHAPES)
def test_patches_cover_every_output_pixel_once(shape):
    N, H, W, Cin, Fo, k, mode = shape
    plan = kcv.conv_plan(*shape)
    assert plan.route == "wgmma" and plan.th * plan.tw == kcv.TILE_M
    hits = np.zeros((N, H, W), np.int64)
    rows = np.arange(kcv.TILE_M)
    for mt in range(plan.mtiles):
        img, h0, w0 = kcv.patch_origin(plan, mt)
        hi, wi = h0 + rows // plan.tw, w0 + rows % plan.tw
        ok = (hi < H) & (wi < W)                 # the epilogue's store mask
        np.add.at(hits, (img, hi[ok], wi[ok]), 1)
    assert (hits == 1).all()
    assert plan.ctas == min(plan.mtiles, kcv.H100_SMS)


@pytest.mark.parametrize("shape", SHAPES)
def test_k_blocks_and_b_boxes_partition_once(shape):
    N, H, W, Cin, Fo, k, mode = shape
    plan = kcv.conv_plan(*shape)
    seen = np.zeros((k * k, Cin), np.int64)
    for dy, dx, c0 in kcv.k_blocks(Cin, k, plan):
        seen[dy * k + dx, c0:c0 + plan.bk] += 1
    assert (seen == 1).all()
    cols = np.zeros(plan.bn, np.int64)
    for p, f0 in kcv.b_boxes(Fo, plan):
        assert f0 + plan.bw <= Fo and p < (4 if mode else 1)
        cols[p * Fo + f0:p * Fo + f0 + plan.bw] += 1
    assert (cols == 1).all()
    # TMA boxes of 32, 64 or 128 bytes, each with its own swizzle
    assert plan.swizzle_a == 2 * plan.bk in (32, 64, 128)
    assert plan.swizzle_b == 2 * plan.bw in (32, 64, 128)


@pytest.mark.parametrize("bn", kcv.WGMMA_N)
@pytest.mark.parametrize("cin", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("k", [1, 3])
def test_every_plan_fits_shared_memory(bn, cin, k):
    plan = kcv.conv_plan(1, 32, 32, cin, bn, k, 0)
    assert plan.route == "wgmma" and plan.bn == bn
    assert 2 <= plan.stages <= kcv.MAX_STAGES
    fit = (k, plan.th, plan.tw)
    assert kcv.smem_bytes(plan.bk, bn, plan.stages, *fit) <= kcv.MAX_SMEM
    assert kcv.smem_bytes(plan.bk, bn, plan.stages + 1, *fit) \
        > kcv.MAX_SMEM or plan.stages == kcv.MAX_STAGES
    # 64-channel K blocks unless two such ring stages do not fit
    assert plan.bk == min(cin, 64) or (
        plan.bk == 32 and kcv.smem_bytes(64, bn, 2, *fit) > kcv.MAX_SMEM)


@pytest.mark.parametrize("shape", [(1, 8, 8, 24, 40, 3, 0),
                                   (1, 8, 8, 48, 32, 1, 0),
                                   (1, 8, 8, 64, 512, 1, 0),
                                   (1, 8, 8, 128, 128, 1, 1)])
def test_other_shapes_take_the_wmma_kernel(shape):
    """Cin 24 or 48 (no 32/64/128-byte box), N 512 (no wgmma N tile),
    an up-conv of 4 F = 512."""
    assert kcv.conv_plan(*shape).route == "wmma"


def _emulate(x, layer, res, relu, out_dtype, mode, plan):
    """conv_wgmma's arithmetic in PyTorch, tile by tile: per M tile, the K
    blocks in ring order, each the tap's box (zero outside x) times the B
    boxes side by side, summed in float32; then per column the affine, the
    residual, ReLU and rounding (an up-conv: bf16(bf16(ReLU(aff)) + skip)),
    each row scattered to its output pixel."""
    N, H, W, Cin = x.shape
    w, aff = layer["w"].float(), layer["aff"]
    Fo = w.shape[-1]
    k = 1 if mode else math.isqrt(w.shape[0])
    w2 = w.reshape(-1, Fo)                        # (taps or parities x Cin, F)
    xb = x.to(_BF).float()
    ncol = plan.bn
    chan = torch.arange(ncol) % Fo
    sc, sh = aff[0][chan], aff[1][chan]
    oshape = (N, 2 * H, 2 * W, Fo) if mode else (N, H, W, Fo)
    y = torch.full(oshape, float("nan"), dtype=_F32)
    rows = torch.arange(kcv.TILE_M)
    for mt in range(plan.mtiles):
        img, h0, w0 = kcv.patch_origin(plan, mt)
        acc = torch.zeros((kcv.TILE_M, ncol), dtype=_F32)
        for dy, dx, c0 in kcv.k_blocks(Cin, k, plan):
            hh = h0 + dy - k // 2 + rows // plan.tw
            ww = w0 + dx - k // 2 + rows % plan.tw
            ok = (hh >= 0) & (hh < H) & (ww >= 0) & (ww < W)
            box = torch.zeros((kcv.TILE_M, plan.bk))
            box[ok] = xb[img, hh[ok], ww[ok], c0:c0 + plan.bk]
            t = dy * k + dx
            b = torch.cat([w2[(p * k * k + t) * Cin + c0:
                              (p * k * k + t) * Cin + c0 + plan.bk,
                              f0:f0 + plan.bw]
                           for p, f0 in kcv.b_boxes(Fo, plan)], dim=1)
            acc = acc + box @ b
        hi, wi = h0 + rows // plan.tw, w0 + rows % plan.tw
        ok = (hi < H) & (wi < W)
        v = acc[ok] * sc + sh
        hi, wi = hi[ok], wi[ok]
        if mode:
            v = torch.relu(v).to(_BF).float()
            for p in range(4):
                oy, ox = 2 * hi + (p >> 1), 2 * wi + (p & 1)
                y[img, oy, ox] = (v[:, p * Fo:(p + 1) * Fo]
                                  + res[img, oy, ox].float()).to(_BF).float()
        else:
            if res is not None:
                v = v + res[img, hi, wi].float()
            if relu:
                v = torch.relu(v)
            y[img, hi, wi] = v.to(out_dtype).float()
    return y.to(_BF if mode else out_dtype)


def _layer(rng, taps, cin, f, up=False, exact=False):
    shape = (2, 2, cin, f) if up else (taps, cin, f)
    if exact:      # multiples of 1/8: bf16 values, exact float32 sums
        w = rng.randint(-3, 4, shape) / 8.0
        aff = np.stack([1 + rng.randint(0, 4, f) / 4.0,
                        rng.randint(-4, 5, f) / 8.0])
    else:
        w = rng.randn(*shape) / np.sqrt(taps * cin)
        aff = np.stack([rng.rand(f) + 0.5, rng.randn(f) * 0.1])
    return {"w": torch.as_tensor(w, dtype=_F32).to(_BF),
            "aff": torch.as_tensor(aff, dtype=_F32)}


def _within_one_bf16_ulp(got, ref):
    g, r = got.float(), ref.float()
    bound = 2.0 ** -7 * torch.maximum(g.abs(), r.abs()) \
        + 1e-4 * float(r.abs().max())
    return bool(((g - r).abs() <= bound).all())


@pytest.mark.parametrize("N,H,W,cin,f,k,res,out", [
    (1, 9, 21, 16, 32, 3, None, _BF),
    (2, 5, 17, 32, 32, 3, _BF, _BF),           # identity join
    (1, 6, 19, 16, 32, 1, None, _F32),         # projection skip
    (1, 9, 11, 64, 64, 3, _F32, _BF),          # join of a projection
    (1, 3, 7, 128, 256, 1, _BF, _BF),          # conv3 + residual
    (1, 4, 5, 64, 128, 3, None, _F32),         # 8 x 16 patch, f32 out
])
@pytest.mark.parametrize("exact", [True, False])
def test_emulated_conv_wgmma_reproduces_conv_plain(N, H, W, cin, f, k, res,
                                                    out, exact):
    rng = np.random.RandomState(H * W + f + exact)
    if exact:
        x = torch.as_tensor(rng.randint(-3, 4, (N, H, W, cin)) / 4.0,
                            dtype=_F32).to(_BF)
    else:
        x = torch.as_tensor(rng.randn(N, H, W, cin), dtype=_F32).to(_BF)
    layer = _layer(rng, k * k, cin, f, exact=exact)
    r = None if res is None else torch.as_tensor(
        rng.randint(-4, 5, (N, H, W, f)) / 8.0 if exact
        else rng.randn(N, H, W, f), dtype=_F32).to(res)
    plan = kcv.conv_plan(N, H, W, cin, f, k, 0)
    assert plan.route == "wgmma"
    for relu in (False, True):
        got = _emulate(x, layer, r, relu, out, 0, plan)
        ref = kcv.conv_plain(x, layer, res=r, relu=relu, out_dtype=out)
        assert got.dtype == ref.dtype == out and float(ref.abs().max()) > 0
        if exact:
            assert torch.equal(got, ref)
        elif out == _F32:
            torch.testing.assert_close(got, ref, rtol=1e-5,
                                       atol=1e-5 * float(ref.abs().max()))
        else:
            assert _within_one_bf16_ulp(got, ref)


@pytest.mark.parametrize("N,H,W,cin,f", [(2, 4, 4, 128, 64), (1, 3, 9, 64, 32),
                                         (1, 5, 3, 16, 16)])
@pytest.mark.parametrize("exact", [True, False])
def test_emulated_conv_wgmma_reproduces_upconv_plain(N, H, W, cin, f, exact):
    rng = np.random.RandomState(cin + f + exact)
    if exact:
        x = torch.as_tensor(rng.randint(-3, 4, (N, H, W, cin)) / 4.0,
                            dtype=_F32).to(_BF)
        skip = torch.as_tensor(rng.randint(-4, 5, (N, 2 * H, 2 * W, f)) / 8.0,
                               dtype=_F32).to(_BF)
    else:
        x = torch.as_tensor(rng.randn(N, H, W, cin), dtype=_F32).to(_BF)
        skip = torch.as_tensor(rng.randn(N, 2 * H, 2 * W, f),
                               dtype=_F32).to(_BF)
    layer = _layer(rng, 1, cin, f, up=True, exact=exact)
    plan = kcv.conv_plan(N, H, W, cin, f, 1, 1)
    assert plan.route == "wgmma" and plan.bn == 4 * f
    got = _emulate(x, layer, skip, True, _BF, 1, plan)
    ref = kcv.upconv_plain(x, layer, skip)
    assert float(ref.float().abs().max()) > 0
    if exact:
        assert torch.equal(got, ref)
    else:
        assert _within_one_bf16_ulp(got, ref)


def test_wrapper_rounds_a_float32_input_once():
    """conv_wgmma's TMA copies bytes, so the wrapper rounds a float32 x to
    bf16 before the launch; the plain version rounds it the same way."""
    rng = np.random.RandomState(3)
    x = torch.as_tensor(rng.randn(1, 6, 10, 32) * 3, dtype=_F32)
    layer = _layer(rng, 9, 32, 32)
    assert torch.equal(kcv.conv_plain(x, layer),
                       kcv.conv_plain(x.to(_BF), layer))


# -- the stem -----------------------------------------------------------------

STEM_SHAPES = [(5, 512, 960), (1, 70, 130), (2, 9, 9), (1, 257, 95),
               (1, 3, 200), (2, 100, 90)]


@pytest.mark.parametrize("N,H,W", STEM_SHAPES)
def test_stem_tiles_cover_the_pooled_map_and_their_windows(N, H, W):
    plan = kst.stem_plan(N, H, W)
    Hc, Hp = kst.out_size(H)
    Wc, Wp = kst.out_size(W)
    assert (plan.conv_h, plan.conv_w) == (2 * plan.tph + 1, 2 * plan.tpw + 1)
    assert plan.ctas == min(plan.tiles, kst.CTAS_PER_SM * kst.H100_SMS)
    hits = np.zeros((N, Hp, Wp), np.int64)
    for tile in range(plan.tiles):
        img, py0, px0 = kst.tile_origin(plan, tile)
        py, px = np.meshgrid(py0 + np.arange(plan.tph),
                             px0 + np.arange(plan.tpw), indexing="ij")
        ok = (py < Hp) & (px < Wp)
        np.add.at(hits, (img, py[ok], px[ok]), 1)
        # the windows' conv rows / cols {2p-1, 2p, 2p+1} inside the map lie
        # in the conv tile [2 p0 - 1, 2 p0 - 1 + conv side)
        for p, p0, side, n in ((py[ok], py0, plan.conv_h, Hc),
                               (px[ok], px0, plan.conv_w, Wc)):
            lo = np.maximum(2 * p - 1, 0)
            hi = np.minimum(2 * p + 1, n - 1)
            assert (lo >= 2 * p0 - 1).all() and (hi < 2 * p0 - 1 + side).all()
    assert (hits == 1).all()


def _stem_packed(rng, exact):
    if exact:
        w = rng.randint(-3, 4, (7, 7, 3, 64)) / 8.0
        aff = np.stack([1 + rng.randint(0, 4, 64) / 4.0,
                        rng.randint(-4, 5, 64) / 8.0])
    else:
        w = rng.randn(7, 7, 3, 64) * 0.1
        aff = np.stack([rng.rand(64) + 0.5, rng.randn(64) * 0.1])
    return {"w": torch.as_tensor(w, dtype=_F32).to(_BF),
            "aff": torch.as_tensor(aff, dtype=_F32)}


def _stem_emulated(x, packed, plan):
    """The stem kernel's GEMM in PyTorch: per pooled tile, the patch (bf16,
    zero outside), each conv position's A row read at 24 ky + j from its
    patch row (j < 24: past the 21 (kx, c) values of a row), times the
    zero-padded (176, 64) B; affine, ReLU, bf16; the pool over the windows'
    conv positions inside the map."""
    N, H, W, _ = x.shape
    Hc, Hp = kst.out_size(H)
    Wc, Wp = kst.out_size(W)
    B = kst.padded_weight(packed["w"], plan).float()
    a, b = packed["aff"]
    xb = torch.nn.functional.pad(x.to(_BF).float(), (0, 0, 8, 8 + 4 * plan.tpw,
                                                     8, 8 + 4 * plan.tph))
    out = torch.zeros((N, Hp, Wp, 64), dtype=_BF)
    ky, j = np.divmod(np.arange(plan.k_pad), plan.k_per_ky)
    for tile in range(plan.tiles):
        img, py0, px0 = kst.tile_origin(plan, tile)
        # patch origin (4 py0 - 5, 4 px0 - 5), shifted by the padding of 8
        patch = xb[img, 4 * py0 + 3:4 * py0 + 3 + 4 * plan.tph + 8,
                   4 * px0 + 3:4 * px0 + 3 + 4 * plan.tpw + 8].reshape(
                       4 * plan.tph + 8, -1)
        cl, cc = np.divmod(np.arange(plan.conv_h * plan.conv_w), plan.conv_w)
        A = patch[2 * cl[:, None] + ky[None], 6 * cc[:, None] + j[None]]
        conv = torch.relu((A @ B) * a + b).to(_BF).float()
        conv = conv.reshape(plan.conv_h, plan.conv_w, 64)
        for ly in range(plan.tph):
            for lx in range(plan.tpw):
                py, px = py0 + ly, px0 + lx
                if py >= Hp or px >= Wp:
                    continue
                ys = [2 * ly + d for d in range(3)
                      if 0 <= 2 * py - 1 + d < Hc]
                xs = [2 * lx + d for d in range(3)
                      if 0 <= 2 * px - 1 + d < Wc]
                out[img, py, px] = conv[ys][:, xs].amax(dim=(0, 1)).to(_BF)
    return out


@pytest.mark.parametrize("N,H,W", [(1, 37, 70), (2, 9, 9), (1, 3, 41)])
@pytest.mark.parametrize("exact", [True, False])
def test_emulated_stem_gemm_reproduces_stem_plain(N, H, W, exact):
    """The zero-padded K changes nothing: exactly, on values whose float32
    sums are exact in any order; within one bf16 ulp otherwise."""
    rng = np.random.RandomState(H + W + exact)
    if exact:
        x = torch.as_tensor(rng.randint(-3, 4, (N, H, W, 3)) / 4.0,
                            dtype=_F32)
    else:
        x = torch.as_tensor(rng.randn(N, H, W, 3), dtype=_F32)
    packed = _stem_packed(rng, exact)
    plan = kst.stem_plan(N, H, W)
    got = _stem_emulated(x, packed, plan)
    ref = kst.stem_plain(x, packed)
    assert got.shape == ref.shape and float(ref.float().abs().max()) > 0
    if exact:
        assert torch.equal(got, ref)
    else:
        assert _within_one_bf16_ulp(got, ref)


def test_stem_padded_weight_holds_every_tap_once():
    plan = kst.stem_plan(1, 64, 64)
    w = torch.arange(1, 147 * 64 + 1, dtype=_F32).reshape(7, 7, 3, 64)
    B = kst.padded_weight(w, plan)
    assert B.shape == (plan.k_pad, 64)
    nz = B[:, 0] != 0
    assert int(nz.sum()) == 147
    assert torch.equal(B[nz], w.reshape(147, 64))
