"""The four task networks: CenterNet (BEV center + bbox), C2CNet (1D
height), P2PNet (tri-plane joint heatmaps), WeightNet (fusion weights).

Inside they run channels-first (cuDNN's layout); at their boundaries they
take and return the reference package's channels-last layouts, so that the
two packages compare like with like:

  CenterNet  volume (B, X, Y, Z, J) -> hm (B, X, Y, 1), size (B, X, Y, 2)
  C2CNet     columns (N, Z, J)      -> (N, Z)
  P2PNet     planes (N, A, B, J)    -> (N, A, B, J)
  WeightNet  planes (N, A, B, J)    -> (N, J, 1)

On the serving path CenterNet runs as the hand-written kernel sequence of
`ops/kernels/centernet.py`, and WeightNet's conv front end as the kernel of
`ops/kernels/weightnet.py`; both read these modules' weights through
`engine/packing.py`. C2CNet and P2PNet run as these cuDNN modules by
default, as the reference package's default serving path leaves them to
XLA; with `cfg.fuse_p2p` the serving path runs them as bf16 kernels
instead (`ops/kernels/c2cnet.py`, one launch, and
`ops/kernels/hourglass.py`, layer by layer), on weights packed from these
modules.

In train mode their BatchNorms take batch statistics (models/blocks.py):
CenterNet's and C2CNet's over the whole batch, P2PNet's and WeightNet's
per scene over the matched people of a (B, 3K) mask, as the reference's
train branch runs them (fvp_tpu/models/faster_voxelpose.py:295-327).

Under `compute_dtype='bfloat16'` the serving path runs C2CNet and P2PNet
as bf16 copies (engine/packing.py::bf16_copy) up to their 1x1 output
convs, which take a float32 input and float32 weights, as the reference's
heads do (fvp_tpu/models/cnns.py: `x.astype(jnp.float32)`). The modules
themselves compute in bf16 under that dtype (`set_compute_dtype`, which
FasterVoxelPose calls): every conv and BatchNorm but the 1x1 output heads,
torch's own float32 convs, as the reference builds its nets with
`dtype=bfloat16` for training too; WeightNet's spatial mean and MLP stay
float32, as the reference's do.
"""

from __future__ import annotations

import torch
from torch import nn

from fvp_torch.models.blocks import (BasicBlock, BatchNorm2d, Conv2d,
                                     EncoderDecoder, ResBlock)


class CenterNet(nn.Module):
    def __init__(self, num_joints: int, head_conv: int = 32):
        super().__init__()
        self.front_layers = nn.Sequential(BasicBlock(num_joints, 16, 7),
                                          ResBlock(16, 32))
        self.encoder_decoder = EncoderDecoder(dims=2)
        self.output_hm = nn.Sequential(
            Conv2d(32, head_conv, 3, padding=1), nn.ReLU(inplace=True),
            nn.Conv2d(head_conv, 1, 1))
        self.output_size = nn.Sequential(
            Conv2d(32, head_conv, 3, padding=1), nn.ReLU(inplace=True),
            nn.Conv2d(head_conv, 2, 1))

    def forward(self, volume: torch.Tensor):
        return self.bev_forward(volume.amax(dim=3))

    def bev_forward(self, bev: torch.Tensor):
        """From the BEV map (B, X, Y, J), the volume's max over z."""
        x = bev.permute(0, 3, 1, 2)                     # (B, J, X, Y)
        x = self.encoder_decoder(self.front_layers(x))

        def head(h):
            return h[2](h[1](h[0](x)).float()).permute(0, 2, 3, 1)
        return head(self.output_hm), head(self.output_size)


class C2CNet(nn.Module):
    def __init__(self, num_joints: int):
        super().__init__()
        self.front_layers = nn.Sequential(BasicBlock(num_joints, 16, 7, 1),
                                          ResBlock(16, 32, 1))
        self.encoder_decoder = EncoderDecoder(dims=1)
        self.output_hm = nn.Conv1d(32, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.encoder_decoder(self.front_layers(x.permute(0, 2, 1)))
        return self.output_hm(x.float())[:, 0]


class P2PNet(nn.Module):
    def __init__(self, num_joints: int):
        super().__init__()
        self.front_layers = nn.Sequential(BasicBlock(num_joints, 16, 7),
                                          ResBlock(16, 32))
        self.encoder_decoder = EncoderDecoder(dims=2)
        self.output_layer = nn.Conv2d(32, num_joints, 1)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None
                ) -> torch.Tensor:
        """`mask` (train mode): (G, M) over the planes, group-major."""
        basic, res = self.front_layers
        x = res(basic(x.permute(0, 3, 1, 2), mask), mask)
        x = self.encoder_decoder(x, mask)
        return self.output_layer(x.float()).permute(0, 2, 3, 1)


class WeightNet(nn.Module):
    """Per-(plane, person, joint) fusion weight from each plane heatmap:
    conv + BN + maxpool + ReLU -> global average pool -> 2-layer MLP ->
    sigmoid."""

    def __init__(self, feat_channels: int = 32, hidden_channels: int = 64):
        super().__init__()
        self.heatmap_feature_net = nn.Sequential(
            Conv2d(1, feat_channels, 3, padding=1),
            BatchNorm2d(feat_channels), nn.MaxPool2d(2),
            nn.ReLU(inplace=True))
        self.output = nn.Sequential(
            nn.Linear(feat_channels, hidden_channels), nn.ReLU(inplace=True),
            nn.Linear(hidden_channels, 1), nn.Sigmoid())

    def pool(self, x: torch.Tensor, mask: torch.Tensor | None = None
             ) -> torch.Tensor:
        """(N, A, B, J) -> (N, J, C): the conv front end (conv -> BN -> 2x2
        max -> ReLU) and the spatial mean, as cuDNN convs. `mask` (train
        mode): (G, M) over the N planes, group-major; each plane's J maps
        take its entry."""
        n, a, b, j = x.shape
        x = x.permute(0, 3, 1, 2).reshape(n * j, 1, a, b)
        conv, bn, pool, relu = self.heatmap_feature_net
        jmask = None if mask is None else mask.repeat_interleave(j, dim=1)
        x = relu(pool(bn(conv(x), jmask))).float().mean(dim=(2, 3))
        return x.reshape(n, j, -1)

    def head(self, pooled: torch.Tensor) -> torch.Tensor:
        """(N, J, C) pooled features -> (N, J, 1) weights."""
        return self.output(pooled)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None
                ) -> torch.Tensor:
        return self.head(self.pool(x, mask))
