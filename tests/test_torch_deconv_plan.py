"""The premises of the deconv-head kernel's design (csrc/deconv_head.cu),
checked on the CPU with its Python tiling (ops/kernels/deconv_head.py):

- rounding stage 1's float32 input to bf16 once, before the kernel's TMA
  loads (which copy bytes), changes nothing: the plain version rounds it
  the same way;
- the plan's patches of each parity class cover every output pixel exactly
  once, its K splits partition the 4 * Cin reduction, and its CTA count
  fills the card;
- each tap's box, loaded at tap_box's coordinates with zero fill outside
  the input, times pack_deconv_weight's w[2r+s, 2u+v], reproduces the
  plain version: a PyTorch emulation of the kernel's tiling, split sums
  added in rank order, equals deconv_stage_plain bit for bit (on values
  whose float32 sums are exact in any order).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fvp_torch.ops.kernels import deconv_head as kdh

FLAGSHIP = [(5, 16, 30, 2048, 256), (5, 32, 60, 256, 256),
            (5, 64, 120, 256, 256)]
RAGGED = [(1, 1, 30, 64, 128), (1, 5, 7, 64, 128), (2, 1, 1, 64, 128),
          (1, 3, 6, 64, 128), (2, 5, 37, 128, 128), (3, 16, 30, 256, 256)]


def _packed(rng, C, Fo, exact=False):
    if exact:      # small multiples of 1/8: bf16 values, exact float32 sums
        w = rng.randint(-3, 4, (C, Fo, 4, 4)) / 8.0
        aff = np.stack([1 + rng.randint(0, 4, Fo) / 4.0,
                        rng.randint(-4, 5, Fo) / 8.0])
    else:
        w = rng.randn(C, Fo, 4, 4) / np.sqrt(4 * C)
        aff = np.stack([rng.rand(Fo) + 0.5, rng.randn(Fo) * 0.1])
    return {"w": kdh.pack_deconv_weight(torch.as_tensor(w, dtype=torch.float32)),
            "aff": torch.as_tensor(aff, dtype=torch.float32)}


@pytest.mark.parametrize("V,H,W,C", [(1, 3, 5, 2048), (2, 4, 6, 256),
                                     (1, 2, 3, 64)])
def test_casting_stage1_input_once_changes_nothing(V, H, W, C):
    rng = np.random.RandomState(C + W)
    x = torch.as_tensor(rng.randn(V, H, W, C).astype(np.float32) * 3)
    packed = _packed(rng, C, 128)
    a = kdh.deconv_stage_plain(x, packed)
    b = kdh.deconv_stage_plain(x.to(torch.bfloat16), packed)
    assert a.dtype == b.dtype == torch.bfloat16
    assert torch.equal(a, b)


@pytest.mark.parametrize("shape", FLAGSHIP + RAGGED)
def test_patches_cover_every_output_pixel_once(shape):
    V, H, W, C, Fo = shape
    plan = kdh.deconv_plan(V, H, W, C, Fo)
    assert plan.th * plan.tw == kdh.TILE_M and Fo % plan.bn == 0
    hits = np.zeros((V, 2 * H, 2 * W), np.int64)
    rows = np.arange(kdh.TILE_M)
    for r in (0, 1):
        for s in (0, 1):
            for mt in range(V * plan.tiles_h * plan.tiles_w):
                v, h0, w0 = kdh.patch_origin(plan, mt)
                hi, wi = h0 + rows // plan.tw, w0 + rows % plan.tw
                ok = (hi < H) & (wi < W)          # the kernel's store mask
                oy, ox = kdh.out_pixel(r, s, hi[ok], wi[ok])
                np.add.at(hits, (v, oy, ox), 1)
    assert (hits == 1).all()


@pytest.mark.parametrize("shape", FLAGSHIP + RAGGED)
def test_k_splits_partition_the_reduction(shape):
    V, H, W, C, Fo = shape
    plan = kdh.deconv_plan(V, H, W, C, Fo)
    parts = kdh.k_split(C, plan.splits)
    assert len(parts) == plan.splits and parts[0][0] == 0
    assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
    assert sum(e - b for b, e in parts) * kdh.TILE_K == 4 * C
    assert all(e > b for b, e in parts)


def test_flagship_plans_fill_the_card():
    """Stage 1 (160 M x N tiles of K = 8192) is split along K to at least
    two waves of CTAs on 132 SMs; stages 2 and 3 run one persistent CTA per
    SM over their tiles."""
    p1, p2, p3 = (kdh.deconv_plan(*s) for s in FLAGSHIP)
    assert p1.splits > 1 and p1.ctas == p1.items >= 2 * kdh.H100_SMS
    for p in (p2, p3):
        assert p.splits == 1 and p.ctas == kdh.H100_SMS < p.items


def _tiled(x, packed, plan):
    """The kernel's arithmetic in PyTorch, tile by tile: per parity,
    M tile, N tile and K rank, the tap boxes (zero outside x) times the
    packed weights, the ranks' partial sums added in rank order, then the
    affine, ReLU, bf16, scattered to each row's output pixel."""
    V, H, W, C = x.shape
    w, aff = packed["w"].double(), packed["aff"].double()
    Fo = w.shape[-1]
    xb = x.to(torch.bfloat16).double()
    y = torch.full((V, 2 * H, 2 * W, Fo), float("nan"), dtype=torch.float64)
    rows = torch.arange(kdh.TILE_M)
    kbt = C // kdh.TILE_K
    for p in range(4):
        r, s = p >> 1, p & 1
        for mt in range(V * plan.tiles_h * plan.tiles_w):
            v, h0, w0 = kdh.patch_origin(plan, mt)
            for n0 in range(0, Fo, plan.bn):
                acc = torch.zeros((kdh.TILE_M, plan.bn), dtype=torch.float64)
                for b, e in kdh.k_split(C, plan.splits):
                    part = torch.zeros_like(acc)
                    for kb in range(b, e):
                        t, c0 = kb // kbt, kb % kbt * kdh.TILE_K
                        hb, wb = kdh.tap_box(r, s, t >> 1, t & 1, h0, w0)
                        hh = hb + rows // plan.tw
                        ww = wb + rows % plan.tw
                        ok = (hh >= 0) & (hh < H) & (ww >= 0) & (ww < W)
                        box = torch.zeros((kdh.TILE_M, kdh.TILE_K),
                                          dtype=torch.float64)
                        box[ok] = xb[v, hh[ok], ww[ok], c0:c0 + kdh.TILE_K]
                        part += box @ w[p, t, c0:c0 + kdh.TILE_K,
                                        n0:n0 + plan.bn]
                    acc += part
                out = torch.relu(acc * aff[0, n0:n0 + plan.bn]
                                 + aff[1, n0:n0 + plan.bn])
                hi, wi = h0 + rows // plan.tw, w0 + rows % plan.tw
                ok = (hi < H) & (wi < W)
                oy, ox = kdh.out_pixel(r, s, hi[ok], wi[ok])
                y[v, oy, ox, n0:n0 + plan.bn] = out[ok]
    return y.float().to(torch.bfloat16)


@pytest.mark.parametrize("V,H,W,C,Fo", [(1, 3, 5, 64, 128),
                                        (2, 1, 1, 64, 128),
                                        (1, 2, 30, 64, 128),
                                        (1, 1, 3, 2048, 128),
                                        (1, 4, 6, 128, 256)])
def test_tap_boxes_reproduce_the_plain_deconv(V, H, W, C, Fo):
    rng = np.random.RandomState(H * W + C)
    x = torch.as_tensor(rng.randint(-3, 4, (V, H, W, C)) / 4.0,
                        dtype=torch.float32)
    packed = _packed(rng, C, Fo, exact=True)
    plan = kdh.deconv_plan(V, H, W, C, Fo)
    got = _tiled(x, packed, plan)
    ref = kdh.deconv_stage_plain(x, packed)
    assert float(ref.float().abs().max()) > 0
    assert torch.equal(got, ref)


def test_plain_version_matches_torch_conv_transpose():
    """The packed layout's convention, once more at a ragged shape: the
    plain version is torch's ConvTranspose2d(4, 2, 1) on the unpacked
    weights."""
    rng = np.random.RandomState(5)
    x = torch.as_tensor(rng.randint(-3, 4, (2, 3, 5, 64)) / 4.0,
                        dtype=torch.float32)
    packed = _packed(rng, 64, 128, exact=True)
    wt = kdh.unpack_deconv_weight(packed["w"])
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), wt, stride=2, padding=1)
    a, b = packed["aff"]
    y = torch.relu(y * a[:, None, None] + b[:, None, None])
    ref = y.permute(0, 2, 3, 1).to(torch.bfloat16)
    assert torch.equal(kdh.deconv_stage_plain(x, packed), ref)
