"""The reference's networks, channels-first, eval mode.

Faster-VoxelPose's four task nets (CenterNet, C2CNet, P2PNet, WeightNet)
and the Pose-ResNet backbone, with the state-dict keys of the model's
published checkpoints, so that one state dict loads into the program and
into these. Each conv and linear layer rounds its input and weight
through the model's `Precision` (float32 unless a control asks for
less) and sums in float32; BatchNorms use their running statistics.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from .precision import Precision


class _Rounded:
    """A layer whose input and weight go through `self.prec` (set by
    `set_precision`) before the float32 product."""
    prec = Precision()

    def forward(self, x):
        return self.product(self.prec.q(x), self.prec.q(self.weight))


class Conv2d(_Rounded, nn.Conv2d):
    def product(self, x, w):
        return F.conv2d(x, w, self.bias, self.stride, self.padding)


class Conv1d(_Rounded, nn.Conv1d):
    def product(self, x, w):
        return F.conv1d(x, w, self.bias, self.stride, self.padding)


class ConvT2d(_Rounded, nn.ConvTranspose2d):
    def product(self, x, w):
        return F.conv_transpose2d(x, w, self.bias, self.stride,
                                  self.padding)


class ConvT1d(_Rounded, nn.ConvTranspose1d):
    def product(self, x, w):
        return F.conv_transpose1d(x, w, self.bias, self.stride,
                                  self.padding)


class Linear(_Rounded, nn.Linear):
    def product(self, x, w):
        return F.linear(x, w, self.bias)


def set_precision(net: nn.Module, prec: Precision) -> nn.Module:
    for m in net.modules():
        if isinstance(m, _Rounded):
            m.prec = prec
    return net


def _conv(dims, cin, cout, k):
    return (Conv2d if dims == 2 else Conv1d)(cin, cout, k, padding=k // 2)


def _bn(dims, c):
    return nn.BatchNorm2d(c) if dims == 2 else nn.BatchNorm1d(c)


def _pool(x, dims):
    return F.max_pool2d(x, 2, 2) if dims == 2 else F.max_pool1d(x, 2, 2)


class Basic(nn.Module):
    def __init__(self, cin, cout, k, dims=2):
        super().__init__()
        self.block = nn.Sequential(_conv(dims, cin, cout, k),
                                   _bn(dims, cout), nn.ReLU())

    def forward(self, x):
        return self.block(x)


class Res(nn.Module):
    def __init__(self, cin, cout, dims=2):
        super().__init__()
        self.res_branch = nn.Sequential(
            _conv(dims, cin, cout, 3), _bn(dims, cout), nn.ReLU(),
            _conv(dims, cout, cout, 3), _bn(dims, cout))
        self.skip_con = nn.Sequential() if cin == cout else nn.Sequential(
            _conv(dims, cin, cout, 1), _bn(dims, cout))

    def forward(self, x):
        return F.relu(self.res_branch(x) + self.skip_con(x))


class Up(nn.Module):
    def __init__(self, cin, cout, dims=2):
        super().__init__()
        self.block = nn.Sequential(
            (ConvT2d if dims == 2 else ConvT1d)(cin, cout, 2, stride=2),
            _bn(dims, cout), nn.ReLU())

    def forward(self, x):
        return self.block(x)


class Hourglass(nn.Module):
    """The two-level encoder-decoder, 32 -> 64 -> 128 channels, with
    residual skips at each level."""

    def __init__(self, dims=2):
        super().__init__()
        self.dims = dims
        self.skip_res1 = Res(32, 32, dims)
        self.encoder_res1 = Res(32, 64, dims)
        self.skip_res2 = Res(64, 64, dims)
        self.encoder_res2 = Res(64, 128, dims)
        self.mid_res = Res(128, 128, dims)
        self.decoder_res2 = Res(128, 128, dims)
        self.decoder_upsample2 = Up(128, 64, dims)
        self.decoder_res1 = Res(64, 64, dims)
        self.decoder_upsample1 = Up(64, 32, dims)

    def forward(self, x):
        skip1 = self.skip_res1(x)
        x = self.encoder_res1(_pool(x, self.dims))
        skip2 = self.skip_res2(x)
        x = self.mid_res(self.encoder_res2(_pool(x, self.dims)))
        x = self.decoder_upsample2(self.decoder_res2(x)) + skip2
        return self.decoder_upsample1(self.decoder_res1(x)) + skip1


class CenterNet(nn.Module):
    """BEV (B, J, X, Y) -> center heatmap (B, X, Y), bbox size (B, X, Y, 2)."""

    def __init__(self, J):
        super().__init__()
        self.front_layers = nn.Sequential(Basic(J, 16, 7), Res(16, 32))
        self.encoder_decoder = Hourglass(2)
        self.output_hm = nn.Sequential(Conv2d(32, 32, 3, padding=1),
                                       nn.ReLU(), Conv2d(32, 1, 1))
        self.output_size = nn.Sequential(Conv2d(32, 32, 3, padding=1),
                                         nn.ReLU(), Conv2d(32, 2, 1))

    def forward(self, bev):
        x = self.encoder_decoder(self.front_layers(bev))
        return (self.output_hm(x)[:, 0],
                self.output_size(x).permute(0, 2, 3, 1))


class C2CNet(nn.Module):
    """Z-columns (N, J, Z) -> height scores (N, Z)."""

    def __init__(self, J):
        super().__init__()
        self.front_layers = nn.Sequential(Basic(J, 16, 7, 1), Res(16, 32, 1))
        self.encoder_decoder = Hourglass(1)
        self.output_hm = Conv1d(32, 1, 1)

    def forward(self, x):
        x = self.encoder_decoder(self.front_layers(x))
        return self.output_hm(x)[:, 0]


class P2PNet(nn.Module):
    """Planes (N, J, A, A) -> joint heatmaps (N, J, A, A)."""

    def __init__(self, J):
        super().__init__()
        self.front_layers = nn.Sequential(Basic(J, 16, 7), Res(16, 32))
        self.encoder_decoder = Hourglass(2)
        self.output_layer = Conv2d(32, J, 1)

    def forward(self, x):
        return self.output_layer(self.encoder_decoder(self.front_layers(x)))


class WeightNet(nn.Module):
    """Joint heatmaps (N, J, A, A) -> fusion weights (N, J)."""

    def __init__(self, feat=32, hidden=64):
        super().__init__()
        self.heatmap_feature_net = nn.Sequential(
            Conv2d(1, feat, 3, padding=1), nn.BatchNorm2d(feat),
            nn.MaxPool2d(2), nn.ReLU())
        self.output = nn.Sequential(Linear(feat, hidden), nn.ReLU(),
                                    Linear(hidden, 1), nn.Sigmoid())

    def forward(self, x):
        n, j, a, b = x.shape
        f = self.heatmap_feature_net(x.reshape(n * j, 1, a, b))
        return self.output(f.mean(dim=(2, 3))).reshape(n, j)


class FasterVoxelPose(nn.Module):
    """The four nets under the checkpoint's key names."""

    def __init__(self, J, feat=32, hidden=64):
        super().__init__()
        self.pose_net = nn.Module()
        self.pose_net.center_net = CenterNet(J)
        self.pose_net.c2c_net = C2CNet(J)
        self.joint_net = nn.Module()
        self.joint_net.conv_net = P2PNet(J)
        self.joint_net.weight_net = WeightNet(feat, hidden)


class Bottleneck(nn.Module):
    def __init__(self, cin, planes, stride=1, down=False):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = nn.Sequential(
            Conv2d(cin, planes * 4, 1, stride, bias=False),
            nn.BatchNorm2d(planes * 4)) if down else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(out + res)


class PoseResNet(nn.Module):
    """Normalized images (N, 3, H, W) -> joint heatmaps (N, J, H/4, W/4):
    a Bottleneck ResNet, three 4x4 stride-2 deconvs of 256 channels with
    BN and ReLU, and a 1x1 conv."""

    BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}

    def __init__(self, J, depth=50):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin = 64
        for i, (planes, n) in enumerate(zip((64, 128, 256, 512),
                                            self.BLOCKS[depth])):
            blocks = []
            for b in range(n):
                stride = 2 if i > 0 and b == 0 else 1
                blocks.append(Bottleneck(cin, planes, stride, b == 0))
                cin = planes * 4
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        layers = []
        for _ in range(3):
            layers += [ConvT2d(cin, 256, 4, 2, 1, bias=False),
                       nn.BatchNorm2d(256), nn.ReLU()]
            cin = 256
        self.deconv_layers = nn.Sequential(*layers)
        self.final_layer = Conv2d(256, J, 1)

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
        return self.final_layer(self.deconv_layers(x))
