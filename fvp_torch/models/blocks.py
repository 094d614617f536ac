"""Shared conv building blocks (2D and 1D), channels-first (NCHW / NCW).

Basic (conv + BN + ReLU), Res (two 3x convs + projection skip), Upsample
(stride-2 transposed conv + BN + ReLU), max pool 2x, and the two-level
encoder-decoder with residual skips. Submodule names follow the reference
model's state-dict keys (`block.{0,1}`, `res_branch.{0,1,3,4}`,
`skip_con.{0,1}`, `skip_res1`, ...), so a port `state_dict()` converts to
the reference package's flax variables with its own converter.

BatchNorm follows the module's mode: running statistics in eval mode; in
train mode the reference package's two conventions (fvp_tpu/models/
blocks.py): flax's `nn.BatchNorm` without a mask, and `MaskedBatchNorm`'s
per-group masked statistics with a (G, M) mask, which every block takes
and hands to its BatchNorms.

The convs and BatchNorms here carry a `compute_dtype` (float32 unless
`set_compute_dtype` says otherwise): in bf16 they compute as the
reference's flax modules built with `dtype=bfloat16` do, in train and in
eval mode, their parameters (and so their gradients) staying float32. A
conv casts its input, weight and bias to bf16 at use, rounds its float32
sums to bf16 and then adds the bias in bf16, as flax's `nn.Conv` does; a
BatchNorm takes its statistics and normalises in float32 and rounds its
output to bf16, as flax's `nn.BatchNorm` and `MaskedBatchNorm` do. ReLU,
max pool and the residual and skip adds then run on bf16 tensors, as
flax's do. No autocast: the rounding points are these, module by module.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class _SumOver(torch.autograd.Function):
    """A sum over the ranks of an axis whose backward is the same sum:
    each rank's loss depends on every rank's input through the summed
    statistics, and the gradient of that dependence is gathered back the
    same way."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.all_reduce_sum(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce_sum(g.clone()), None


def batch_norm_train(bn: nn.modules.batchnorm._BatchNorm,
                     x: torch.Tensor) -> torch.Tensor:
    """Train-mode BatchNorm as flax's `nn.BatchNorm` computes it: batch
    statistics (biased variance) normalise; the running statistics move by
    the momentum towards the batch mean and the *biased* batch variance
    (torch's own BatchNorm would take the unbiased one).

    Where `bn.data` holds the 'data' axis of the data-parallel train step
    (parallel/mesh.py::Axis; set by `data_parallel`), the statistics are
    the global batch's, whose blocks the axis's ranks hold, as in the
    reference's one global program: the mean, then the biased variance
    about it, each a differentiable sum over the axis."""
    dims = [0] + list(range(2, x.dim()))
    if bn.data is None:
        y = F.batch_norm(x, None, None, bn.weight, bn.bias, training=True,
                         eps=bn.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=dims, correction=0)
    else:
        shape = [1, -1] + [1] * (x.dim() - 2)
        count = x.new_tensor([float(x.numel() // x.shape[1])])
        total = _SumOver.apply(torch.cat([x.sum(dim=dims), count]), bn.data)
        mean = total[:-1] / total[-1]
        d = x - mean.reshape(shape)
        var = _SumOver.apply((d * d).sum(dim=dims), bn.data) / total[-1]
        a = torch.rsqrt(var + bn.eps) * bn.weight
        y = d * a.reshape(shape) + bn.bias.reshape(shape)
        mean, var = mean.detach(), var.detach()
    with torch.no_grad():
        r = 1.0 - bn.momentum
        bn.running_mean.mul_(r).add_(mean, alpha=bn.momentum)
        bn.running_var.mul_(r).add_(var, alpha=bn.momentum)
    return y


def masked_batch_norm(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """The reference package's MaskedBatchNorm (fvp_tpu/models/blocks.py):
    x (G*M, C, ...) group-major, mask (G, M). Each group is normalised
    with the statistics of its members in the mask (biased variance);
    members outside it are zeroed. The running statistics take the
    closed form of torch's sequential update, once per group with a
    member, in group order, with the unbiased variance.

    A group is a scene, and a scene lives on one rank of the data-parallel
    train step, so the normalisation stays local; where `bn.data` holds
    the 'data' axis, the running update runs over the groups of every
    rank, in rank order: the global batch's group order."""
    G, M = mask.shape
    C = x.shape[1]
    xg = x.reshape(G, M, C, -1)
    S = xg.shape[-1]
    m = mask.to(x.dtype).reshape(G, M, 1, 1)
    cnt = m.sum(dim=(1, 2, 3)) * S                           # (G,)
    safe = cnt.clamp(min=1.0)[:, None]
    mean = (xg * m).sum(dim=(1, 3)) / safe                   # (G, C)
    d = xg - mean[:, None, :, None]
    var = (d * d * m).sum(dim=(1, 3)) / safe
    a = torch.rsqrt(var + bn.eps) * bn.weight                # (G, C)
    b = bn.bias - mean * a
    y = (xg * a[:, None, :, None] + b[:, None, :, None]) * m
    with torch.no_grad():
        unbiased = var * (cnt / (cnt - 1.0).clamp(min=1.0))[:, None]
        mean = mean.detach()
        if bn.data is not None:
            both = bn.data.all_gather(torch.cat(
                [mean, unbiased, cnt[:, None]], dim=1))
            mean, unbiased, cnt = both[:, :C], both[:, C:2 * C], both[:, -1]
        valid = (cnt > 0).to(x.dtype)
        r = 1.0 - bn.momentum
        after = valid.flip(0).cumsum(0).flip(0) - valid      # valid after g
        w = (valid * (1.0 - r) * r ** after)[:, None]
        rpow = r ** valid.sum()
        bn.running_mean.mul_(rpow).add_((w * mean).sum(0))
        bn.running_var.mul_(rpow).add_((w * unbiased).sum(0))
    return y.reshape(x.shape)


_BF16 = torch.bfloat16


class _TrainBN:
    # the 'data' axis of the data-parallel train step, or None
    data = None
    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None
                ) -> torch.Tensor:
        if self.compute_dtype == _BF16:
            return self._forward(x.float(), mask).to(_BF16)
        return self._forward(x, mask)

    def _forward(self, x: torch.Tensor, mask: torch.Tensor | None
                 ) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if mask is not None:
            return masked_batch_norm(self, x, mask)
        return batch_norm_train(self, x)


@contextlib.contextmanager
def data_parallel(model: nn.Module, data):
    """Inside, the train-mode BatchNorms of `model` take their statistics
    over the 'data' axis `data` (parallel/mesh.py::Axis) as
    `batch_norm_train` and `masked_batch_norm` say; None leaves them
    local. They are local again afterwards."""
    bns = [m for m in model.modules() if isinstance(m, _TrainBN)]
    for bn in bns:
        bn.data = data
    try:
        yield
    finally:
        for bn in bns:
            bn.data = None


class BatchNorm2d(_TrainBN, nn.BatchNorm2d):
    """nn.BatchNorm2d with the reference package's train-mode conventions
    (`batch_norm_train`, `masked_batch_norm`)."""


class BatchNorm1d(_TrainBN, nn.BatchNorm1d):
    """nn.BatchNorm1d with the reference package's train-mode conventions
    (`batch_norm_train`, `masked_batch_norm`)."""


class _TypedConv:
    """A conv with the reference's bf16 mode (flax's `nn.Conv` with
    `dtype=bfloat16`, see the module docstring); float32 as torch's
    own otherwise."""
    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype != _BF16:
            return super().forward(x)
        y = self.product(x.to(_BF16), self.weight.to(_BF16))
        return add_bias_bf16(y, self.bias)

    def product(self, x, w):
        """The conv without its bias, on `x` and `w` as given."""
        return self._conv_forward(x, w, None)


def add_bias_bf16(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """A bf16 conv output (N, C, ...) plus its bias rounded to bf16, the
    sum in bf16: flax's bias add under `dtype=bfloat16`."""
    return y + bias.to(_BF16).reshape(-1, *[1] * (y.dim() - 2))


class Conv1d(_TypedConv, nn.Conv1d):
    pass


class Conv2d(_TypedConv, nn.Conv2d):
    def product(self, x, w, padding=None):
        """`padding`: another than the module's (the spatial path's halo
        convs pad y alone)."""
        return F.conv2d(x, w, None, self.stride,
                        self.padding if padding is None else padding,
                        self.dilation, self.groups)


class ConvTranspose1d(_TypedConv, nn.ConvTranspose1d):
    def product(self, x, w):
        return F.conv_transpose1d(x, w, None, self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


class ConvTranspose2d(_TypedConv, nn.ConvTranspose2d):
    def product(self, x, w):
        return F.conv_transpose2d(x, w, None, self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


def set_compute_dtype(net: nn.Module, compute_dtype: str) -> nn.Module:
    """Set the `compute_dtype` ('float32' or 'bfloat16') of every conv and
    BatchNorm of this module's types in `net` (the task nets' 1x1 output
    convs are torch's own: float32 on a float32 input, as the reference
    computes them)."""
    dtypes = {"float32": torch.float32, "bfloat16": _BF16}
    if compute_dtype not in dtypes:
        raise ValueError(f"compute_dtype {compute_dtype!r}: the nets compute "
                         "in float32 or bfloat16")
    for m in net.modules():
        if isinstance(m, (_TypedConv, _TrainBN)):
            m.compute_dtype = dtypes[compute_dtype]
    return net


def _conv(dims: int, cin: int, cout: int, k: int) -> nn.Module:
    cls = Conv2d if dims == 2 else Conv1d
    return cls(cin, cout, k, padding=k // 2)


def _bn(dims: int, c: int) -> nn.Module:
    return BatchNorm2d(c) if dims == 2 else BatchNorm1d(c)


def max_pool(x: torch.Tensor, dims: int, window: int = 2) -> torch.Tensor:
    if dims == 2:
        return F.max_pool2d(x, window, stride=window)
    return F.max_pool1d(x, window, stride=window)


class BasicBlock(nn.Module):
    """Conv(k) + BN + ReLU."""

    def __init__(self, cin: int, cout: int, kernel: int, dims: int = 2):
        super().__init__()
        self.block = nn.Sequential(_conv(dims, cin, cout, kernel),
                                   _bn(dims, cout), nn.ReLU(inplace=True))

    def forward(self, x, mask=None):
        conv, bn, relu = self.block
        return relu(bn(conv(x), mask))


class ResBlock(nn.Module):
    """conv3-BN-ReLU-conv3-BN + (1x projection) skip, ReLU at the join."""

    def __init__(self, cin: int, cout: int, dims: int = 2):
        super().__init__()
        self.res_branch = nn.Sequential(
            _conv(dims, cin, cout, 3), _bn(dims, cout), nn.ReLU(inplace=True),
            _conv(dims, cout, cout, 3), _bn(dims, cout))
        if cin == cout:
            self.skip_con = nn.Sequential()
        else:
            self.skip_con = nn.Sequential(_conv(dims, cin, cout, 1),
                                          _bn(dims, cout))

    def forward(self, x, mask=None):
        c0, bn0, relu, c1, bn1 = self.res_branch
        r = bn1(c1(relu(bn0(c0(x), mask))), mask)
        if len(self.skip_con):
            x = self.skip_con[1](self.skip_con[0](x), mask)
        return F.relu(r + x)


class UpsampleBlock(nn.Module):
    """Stride-2 transposed conv (kernel 2) + BN + ReLU: exact 2x upsample."""

    def __init__(self, cin: int, cout: int, dims: int = 2):
        super().__init__()
        cls = ConvTranspose2d if dims == 2 else ConvTranspose1d
        self.block = nn.Sequential(cls(cin, cout, 2, stride=2),
                                   _bn(dims, cout), nn.ReLU(inplace=True))

    def forward(self, x, mask=None):
        conv, bn, relu = self.block
        return relu(bn(conv(x), mask))


class EncoderDecoder(nn.Module):
    """Two-level hourglass with residual skips: c0 -> c1 -> c2 channels
    down, mirrored up, skip adds at each level."""

    def __init__(self, dims: int = 2, channels: Sequence[int] = (32, 64, 128)):
        super().__init__()
        c0, c1, c2 = channels
        self.dims = dims
        self.skip_res1 = ResBlock(c0, c0, dims)
        self.encoder_res1 = ResBlock(c0, c1, dims)
        self.skip_res2 = ResBlock(c1, c1, dims)
        self.encoder_res2 = ResBlock(c1, c2, dims)
        self.mid_res = ResBlock(c2, c2, dims)
        self.decoder_res2 = ResBlock(c2, c2, dims)
        self.decoder_upsample2 = UpsampleBlock(c2, c1, dims)
        self.decoder_res1 = ResBlock(c1, c1, dims)
        self.decoder_upsample1 = UpsampleBlock(c1, c0, dims)

    def forward(self, x, mask=None):
        skip1 = self.skip_res1(x, mask)
        x = self.encoder_res1(max_pool(x, self.dims), mask)
        skip2 = self.skip_res2(x, mask)
        x = self.encoder_res2(max_pool(x, self.dims), mask)
        x = self.mid_res(x, mask)
        x = self.decoder_res2(x, mask)
        x = self.decoder_upsample2(x, mask) + skip2
        x = self.decoder_res1(x, mask)
        return self.decoder_upsample1(x, mask) + skip1
