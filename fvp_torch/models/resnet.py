"""Pose-ResNet backbone, eval mode: normalized images -> per-joint heatmaps.

A ResNet trunk, three ConvTranspose(4x4, s2, p1) + BN + ReLU stages and a
1x1 conv to `num_joints` heatmaps at 1/4 of the input resolution (ResNet-50
by default: Bottleneck blocks [3, 4, 6, 3], 256-channel deconvs). The port
of fvp_tpu/models/resnet.py::PoseResNet in its serving lowering
(stem='host_s2d', head='pallas'):

- the stem, conv1 + bn1 + ReLU + 3x3/s2 max pool, is one kernel
  (ops/kernels/stem.py) that reads the NHWC float32 image and writes the
  pooled map in bf16;
- the trunk is nn.Conv2d + eval-mode BatchNorm (cuDNN on the card), on
  channels-last tensors: in float32 on the float32 cast of the stem's
  output; or, packed for `compute_dtype='bfloat16'` (the reference's
  serving configuration; engine/packing.py::pack_backbone), in bf16 on
  the stem's bf16 output, on copies of the layers whose convs hold bf16
  weights (each conv rounding to bf16, each BN applying its float32
  affine and rounding to bf16, as flax's `dtype=bfloat16` modules do),
  with a Bottleneck ResNet's layer1 on the bottleneck-stage kernel
  (ops/kernels/trunk.py, 10 launches for ResNet-50);
- the head is the deconv kernel, one launch per stage
  (ops/kernels/deconv_head.py), bf16 out, reading the bf16 trunk's output
  as it is and the float32 trunk's rounded to bf16;
- `final_layer` is a 1x1 conv with bias on the float32 cast of the head.

Parameter names are the reference model's state-dict keys (`conv1`, `bn1`,
`layerN.i.convK`, `layerN.i.bnK`, `layerN.i.downsample.{0,1}`,
`deconv_layers.{0,1,3,4,6,7}`, `final_layer`), so the reference package's
torch -> flax converter reads a port `state_dict()` unchanged.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from fvp_torch.ops.kernels.deconv_head import deconv_head
from fvp_torch.ops.kernels.stem import stem
from fvp_torch.ops.kernels.trunk import bottleneck_stage

# depth -> (block kind, blocks per layer); a copy of the reference
# package's table
RESNET_SPECS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


def _down(cin: int, cout: int, stride: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                         nn.BatchNorm2d(cout))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: nn.Module | None = None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = downsample

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        res = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + res)


class BasicResBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: nn.Module | None = None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = downsample

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        res = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + res)


class PoseResNet(nn.Module):
    """`forward(images, packed)`: images (N, H, W, 3) normalized float32,
    NHWC; `packed` from engine/packing.py::pack_backbone. Returns heatmaps
    (N, H/4, W/4, num_joints) float32, NHWC, as the reference module does."""

    def __init__(self, num_joints: int, num_layers: int = 50):
        super().__init__()
        kind, blocks = RESNET_SPECS[num_layers]
        block = Bottleneck if kind == "bottleneck" else BasicResBlock
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        inplanes = 64
        for li, (planes, n) in enumerate(zip((64, 128, 256, 512), blocks)):
            stride = 1 if li == 0 else 2
            layer = []
            for bi in range(n):
                s = stride if bi == 0 else 1
                out = planes * block.expansion
                down = None
                if bi == 0 and (s != 1 or inplanes != out):
                    down = _down(inplanes, out, s)
                layer.append(block(inplanes, planes, s, down))
                inplanes = out
            setattr(self, f"layer{li + 1}", nn.Sequential(*layer))
        deconv = []
        for _ in range(3):
            deconv += [nn.ConvTranspose2d(inplanes, 256, 4, 2, 1, bias=False),
                       nn.BatchNorm2d(256), nn.ReLU(inplace=True)]
            inplanes = 256
        self.deconv_layers = nn.Sequential(*deconv)
        self.final_layer = nn.Conv2d(256, num_joints, 1)

    def trunk(self, x: torch.Tensor, packed: dict | None = None
              ) -> torch.Tensor:
        """The stem's (N, h, w, 64) bf16 output -> layer4's (N, h/8, w/8,
        C), NHWC: float32 on the model's layers, or bf16 where `packed`
        (pack_backbone's) holds the bf16 copies of the trunk's layers
        (and layer1 for the stage kernel)."""
        layers = None if packed is None else packed.get("trunk")
        if layers is None:
            x = x.float()
            layers = [self.layer1, self.layer2, self.layer3, self.layer4]
        elif "layer1" in packed:
            x = bottleneck_stage(x, *packed["layer1"])
        x = x.permute(0, 3, 1, 2)                         # channels-last NCHW
        for layer in layers:
            x = layer(x)
        return x.permute(0, 2, 3, 1).contiguous()

    def forward(self, images: torch.Tensor, packed: dict) -> torch.Tensor:
        x = stem(images, packed["stem"])                  # (N, h, w, 64) bf16
        x = deconv_head(self.trunk(x, packed), packed["head"])
        x = self.final_layer(x.float().permute(0, 3, 1, 2))
        return x.permute(0, 2, 3, 1).contiguous()


def seeded_state_dict(model: PoseResNet, seed: int) -> dict:
    """Random weights for `model` from a numpy seed, scaled so that the
    activations stay O(1) through the eval-mode network, whose BatchNorms
    use running stats and so do not renormalise:

    - every conv is He-normal, N(0, 2 / fan_in), which keeps the second
      moment of a conv on ReLU'd input; a transposed conv's fan-in is
      4 * Cin (each output sees 2x2 taps);
    - BN: gamma 1 + U(-0.1, 0.1), beta and running mean N(0, 0.05),
      running var 1 + U(0, 0.1), i.e. close to the identity; the last BN
      of each residual branch (bn3, or bn2 in a basic block) has gamma
      0.25 x that, so each block adds a small branch to its input and the
      scale grows slowly over the 16 blocks of ResNet-50 instead of
      doubling per block;
    - final_layer: N(0, 1 / Cin) and bias N(0, 0.1), heatmaps of O(1).
    """
    rng = np.random.RandomState(seed)
    last_bn = "bn3" if isinstance(model.layer1[0], Bottleneck) else "bn2"
    out = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        name = k.rsplit(".", 1)[0]
        if k.endswith("num_batches_tracked"):
            out[k] = v.clone()
            continue
        if len(shape) == 4:
            if name.startswith("deconv_layers"):
                fan_in = 4 * shape[0]
            else:
                fan_in = int(np.prod(shape[1:]))
            gain = 1.0 if name == "final_layer" else 2.0
            a = rng.normal(0.0, np.sqrt(gain / fan_in), shape)
        elif name == "final_layer":
            a = rng.normal(0.0, 0.1, shape)
        elif k.endswith(".weight"):
            a = 1.0 + rng.uniform(-0.1, 0.1, shape)
            if name.endswith(last_bn):
                a *= 0.25
        elif k.endswith("running_var"):
            a = 1.0 + rng.uniform(0.0, 0.1, shape)
        else:                                        # beta, running mean
            a = rng.normal(0.0, 0.05, shape)
        out[k] = torch.from_numpy(np.asarray(a, np.float32))
    return out
