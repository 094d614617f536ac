"""The FLOP and byte counters on shapes worked out by hand."""

import json

import pytest
from torch import nn

from fvpbench import counts
from fvpbench.spec import BENCH_DIR, family_module

FVP = family_module("faster_voxelpose")


def config(name):
    return json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())


def test_layer_work_by_hand():
    conv = nn.Sequential(nn.Conv2d(3, 8, 3, padding=1))
    assert counts.layer_work(conv, (1, 3, 10, 10))[0][1] == 10 * 10 * 8 * 27
    up = nn.Sequential(nn.ConvTranspose2d(4, 2, 2, stride=2))
    # 200 outputs, each one tap of 4 input channels
    assert counts.layer_work(up, (1, 4, 5, 5))[0][1] == 200 * 4
    deconv = nn.Sequential(nn.ConvTranspose2d(4, 2, 4, 2, 1))
    # 2 x 10 x 10 outputs, each 2 x 2 taps of 4 channels
    assert counts.layer_work(deconv, (1, 4, 5, 5))[0][1] == 200 * 16
    lin = nn.Sequential(nn.Linear(32, 64))
    assert counts.layer_work(lin, (5, 32))[0][1] == 5 * 64 * 32


def test_layer_work_3d_by_hand():
    """3D convolutions count as their 2D forms do, a third axis on."""
    conv = nn.Sequential(nn.Conv3d(3, 8, 3, padding=1))
    # 6 x 5 x 4 x 8 outputs, each 3 x 3 x 3 taps of 3 channels
    assert counts.layer_work(conv, (1, 3, 6, 5, 4))[0][1] == 6 * 5 * 4 * 8 * 81
    up = nn.Sequential(nn.ConvTranspose3d(4, 2, 2, stride=2))
    # 2 x 6 x 6 x 6 outputs, each one tap of 4 input channels
    assert counts.layer_work(up, (1, 4, 3, 3, 3))[0][1] == 432 * 4
    deconv = nn.Sequential(nn.ConvTranspose3d(4, 2, 4, 2, 1))
    # 2 x 6 x 6 x 6 outputs, each 2 x 2 x 2 taps of 4 channels
    assert counts.layer_work(deconv, (1, 4, 3, 3, 3))[0][1] == 432 * 32
    # in a net, in call order: 2 frames of 2 x 12 x 10 x 8 outputs, each
    # one tap of the conv's 8 channels
    net = nn.Sequential(nn.Conv3d(3, 8, 3, padding=1), nn.ReLU(),
                        nn.ConvTranspose3d(8, 2, 2, stride=2))
    rows = counts.layer_work(net, (2, 3, 6, 5, 4))
    assert [r[0] for r in rows] == ["Conv3d", "ConvTranspose3d"]
    assert rows[1][1] == 2 * 2 * 12 * 10 * 8 * 8


def test_weightnet_flops_by_hand():
    from reference.nets import WeightNet
    J, n = 17, 64
    rows = counts.layer_work(WeightNet(32, 64), (1, J, n, n))
    macs = J * n * n * 32 * 9 + J * (32 * 64 + 64 * 1)
    assert sum(r[1] for r in rows) == macs


def test_resnet50_flops():
    """ResNet-50's published 4.1 GMAC at 224 x 224, and the panoptic
    frame's 5 views at 960 x 512 with the deconv head."""
    from reference.nets import PoseResNet
    rows = counts.layer_work(PoseResNet(15, 50), (1, 3, 224, 224))
    trunk = sum(r[1] for r in rows if r[0] != "ConvT2d") - 256 * 15 * 56 * 56
    assert trunk == pytest.approx(4.09e9, rel=0.01)
    f = FVP.model_flops(config("panoptic-jln64-bf16"), True)
    # each deconv output sums 2 x 2 taps of every input channel
    deconv = 2 * 4 * 256 * (2048 * 32 * 60 + 256 * 64 * 120
                            + 256 * 128 * 240)
    final = 2 * 256 * 15 * 128 * 240
    pixels = 960 * 512 / 224 ** 2
    assert f["backbone"] == pytest.approx(
        5 * (2 * pixels * 4.09e9 + deconv + final), rel=0.02)
    assert f["frame"] == f["backbone"] + f["hdn"] + f["jln"]


def test_bounds_by_hand():
    assert counts.bound_ms(3.35e9, 0.0, counts.PEAK_FP32) == \
        pytest.approx(1.0)
    assert counts.bound_ms(0.0, 67e9, counts.PEAK_FP32) == \
        pytest.approx(1.0)
    assert counts.bound_ms(0.0, 989e9, counts.PEAK_BF16) == \
        pytest.approx(1.0)
    c = config("shelf-jln64")
    b = FVP.kernel_bounds(c, 8, [(0.0, 0)], False)
    N, J, V = 80 * 80 * 20, 17, 5
    nbytes = 8 * V * J * 152 * 200 * 4 + V * 2 * N * 4 + 8 * N * J * 4
    flops = 8 * (N * J * V * 8.0 + N * J * 2.0)
    assert b["whole_sample"] == (1, pytest.approx(
        max(nbytes / 3.35e12, flops / 67e12) * 1e3))
    vox = 10 * 64 ** 3
    planes = FVP.kernel_bounds(c, 8, [(vox, 10)], False)["person_planes"][1]
    assert planes == pytest.approx(max(
        (8 * V * 152 * 200 * 20 * 4 + 10 * 3 * 64 * 64 * J * 4) / 3.35e12,
        (vox * V * (45 + 8 * J) + vox * J * 5) / 67e12) * 1e3)
    p = FVP.kernel_bounds(config("panoptic-jln64-bf16"), 8,
                          [(0.0, 0), (0.0, 0)], True)
    # the stem: 40 images 512 x 960 in float32 read, 128 x 240 x 64 bf16
    # written; 256 x 480 x 64 convs of 147 taps
    stem_bytes = 40 * 512 * 960 * 3 * 4 + 40 * 128 * 240 * 64 * 2 \
        + 147 * 64 * 2
    stem_ops = 40 * 256 * 480 * 64 * (2.0 * 147 + 2)
    assert p["stem"] == (1, pytest.approx(
        2 * max(stem_bytes / 3.35e12, stem_ops / 989e12) * 1e3))
    assert p["bottleneck_stage.wgmma"][0] == 10
    assert p["deconv_stage"][0] == 3
    assert "centernet_bf16" in p and "centernet" not in p
