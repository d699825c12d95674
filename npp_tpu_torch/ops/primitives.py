"""The primitive ops of the released NPPNet genotypes, as torch modules.

Port of ``npp_tpu/ops/primitives.py:181-392``: the whole ``OPS`` table
of the reference. Tensors are NCHW. Unlike flax, torch modules need their
input width at construction, so each module here takes ``c_in`` where
flax infers it. Every op takes ``affine``: the search's mixed ops build
their candidates with affine-free BNs (running statistics, no weight or
bias).

Child modules carry the names flax gives them (``Conv_0``, ``Conv_1``,
``BatchNorm_0``, ``DilConvS_0``), so a flax variable path maps onto the
state_dict key by a fixed rule (``utils/convert.py``). BN is plain
``nn.BatchNorm2d`` (momentum 0.1, eps 1e-5): it already updates
``running_var`` with the unbiased batch variance, which is what the
hand-rolled JAX BN (``npp_tpu/ops/primitives.py:24-82``) exists for.
Pools are torch's own: ``F.max_pool2d`` pads with -inf, the 3x3 average
pool leaves the padding out of its divisor (``count_include_pad=False``),
``F.avg_pool2d(2, 2)`` has no padding.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from npp_tpu_torch.ops.resize import resize_scale


def conv(c_in: int, c_out: int, kernel: int, stride: int = 1,
         padding: int = 0, dilation: int = 1, groups: int = 1,
         bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, kernel, stride, padding, dilation, groups,
                     bias=bias)


def batch_norm(c: int, affine: bool = True) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1, affine=affine)


class Zero(nn.Module):
    """'none' op."""

    def __init__(self, stride: int):
        super().__init__()
        self.stride = stride

    def forward(self, x):
        if self.stride == 1:
            return x * 0.0
        return x[:, :, ::self.stride, ::self.stride] * 0.0


class Identity(nn.Module):
    def forward(self, x):
        return x


class PoolBN(nn.Module):
    """3x3 max or average pool + BN (``max_pool_3x3``, ``avg_pool_3x3``)."""

    def __init__(self, pool_type: str, c: int, stride: int,
                 affine: bool = True):
        super().__init__()
        self.pool_type, self.stride = pool_type, stride
        self.BatchNorm_0 = batch_norm(c, affine)

    def forward(self, x):
        if self.pool_type == "max":
            x = F.max_pool2d(x, 3, self.stride, 1)
        else:
            x = F.avg_pool2d(x, 3, self.stride, 1, count_include_pad=False)
        return self.BatchNorm_0(x)


class ReLUConvBN(nn.Module):
    """ReLU - Conv - BN."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int,
                 padding: int, affine: bool = True):
        super().__init__()
        self.Conv_0 = conv(c_in, c_out, kernel, stride, padding, bias=False)
        self.BatchNorm_0 = batch_norm(c_out, affine)

    def forward(self, x):
        return self.BatchNorm_0(self.Conv_0(F.relu(x)))


class DilConvS(nn.Module):
    """ReLU - depthwise (dilated) - pointwise - BN."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int,
                 padding: int, dilation: int, affine: bool = True):
        super().__init__()
        self.Conv_0 = conv(c_in, c_in, kernel, stride, padding, dilation,
                           groups=c_in, bias=False)
        self.Conv_1 = conv(c_in, c_out, 1, bias=False)
        self.BatchNorm_0 = batch_norm(c_out, affine)

    def forward(self, x):
        return self.BatchNorm_0(self.Conv_1(self.Conv_0(F.relu(x))))


class SepConv(nn.Module):
    """Two stacked ``DilConvS`` with dilation 1; the stride is the first's."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int,
                 padding: int, affine: bool = True):
        super().__init__()
        self.DilConvS_0 = DilConvS(c_in, c_in, kernel, stride, padding, 1,
                                   affine)
        self.DilConvS_1 = DilConvS(c_in, c_out, kernel, 1, padding, 1, affine)

    def forward(self, x):
        return self.DilConvS_1(self.DilConvS_0(x))


class SEBlock(nn.Module):
    """Squeeze-excitation ``se_connect``; at stride 2 it appends a 2x2
    average pool and a BN, which is affine whatever ``affine`` says
    (``npp_tpu/ops/primitives.py:284-298``)."""

    def __init__(self, c_in: int, stride: int, affine: bool = True):
        super().__init__()
        self.stride = stride
        self.Conv_0 = conv(c_in, c_in // 2, 1)
        self.Conv_1 = conv(c_in // 2, c_in, 1)
        if stride != 1:
            self.BatchNorm_0 = batch_norm(c_in)

    def forward(self, x):
        w = x.mean(dim=(2, 3), keepdim=True)
        w = torch.sigmoid(self.Conv_1(F.relu(self.Conv_0(w))))
        out = x * w
        if self.stride == 1:
            return out
        return self.BatchNorm_0(F.avg_pool2d(out, 2, 2))


class FactorizedReduce(nn.Module):
    """Stride-2 factorized pointwise reduce; the second branch reads the
    input shifted by one pixel (``npp_tpu/ops/primitives.py:314``)."""

    def __init__(self, c_in: int, c_out: int, affine: bool = True):
        super().__init__()
        self.Conv_0 = conv(c_in, c_out // 2, 1, 2, bias=False)
        self.Conv_1 = conv(c_in, c_out // 2, 1, 2, bias=False)
        self.BatchNorm_0 = batch_norm(c_out, affine)

    def forward(self, x):
        x = F.relu(x)
        out = torch.cat([self.Conv_0(x), self.Conv_1(x[:, :, 1:, 1:])], dim=1)
        return self.BatchNorm_0(out)


class FacConv(nn.Module):
    """ReLU - Conv(Kx1) - Conv(1xK) - BN (``conv_7x1_1x7``)."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int,
                 padding: int, affine: bool = True):
        super().__init__()
        k, s, p = kernel, stride, padding
        self.Conv_0 = nn.Conv2d(c_in, c_in, (k, 1), (s, 1), (p, 0),
                                bias=False)
        self.Conv_1 = nn.Conv2d(c_in, c_out, (1, k), (1, s), (0, p),
                                bias=False)
        self.BatchNorm_0 = batch_norm(c_out, affine)

    def forward(self, x):
        return self.BatchNorm_0(self.Conv_1(self.Conv_0(F.relu(x))))


class PooledConv(nn.Module):
    """AvgPool2 - [ReLU-Conv-BN] x ``conv_nums`` - bilinear up x2
    (``poled_conv_x1``, ``poled_conv_x2``; the latter at stride 2 upsamples
    twice)."""

    def __init__(self, c_in: int, c_out: int, stride: int,
                 conv_nums: int = 1, affine: bool = True):
        super().__init__()
        self.conv_nums, self.stride = conv_nums, stride
        for i in range(conv_nums):
            setattr(self, f"Conv_{i}", conv(c_in if i == 0 else c_out, c_out,
                                            3, stride, 1, bias=True))
            setattr(self, f"BatchNorm_{i}", batch_norm(c_out, affine))

    def forward(self, x):
        x = F.avg_pool2d(x, 2, 2)
        for i in range(self.conv_nums):
            x = getattr(self, f"Conv_{i}")(F.relu(x))
            x = getattr(self, f"BatchNorm_{i}")(x)
        x = resize_scale(x, 2.0, align_corners=True)
        if self.conv_nums == 2 and self.stride == 2:
            x = resize_scale(x, 2.0, align_corners=True)
        return x


# The reference OPS table (``npp_tpu/ops/primitives.py:370-387``). Each
# factory is (channels, stride, affine) -> module; every op keeps the
# state's width.
OPS: dict[str, Callable[[int, int, bool], nn.Module]] = {
    "none": lambda c, s, a: Zero(s),
    "avg_pool_3x3": lambda c, s, a: PoolBN("avg", c, s, a),
    "max_pool_3x3": lambda c, s, a: PoolBN("max", c, s, a),
    "skip_connect": lambda c, s, a: (
        Identity() if s == 1 else FactorizedReduce(c, c, a)),
    "std_conv_3x3": lambda c, s, a: ReLUConvBN(c, c, 3, s, 1, a),
    "std_conv_1x1": lambda c, s, a: ReLUConvBN(c, c, 1, s, 0, a),
    "dil_conv_3x3_2": lambda c, s, a: DilConvS(c, c, 3, s, 2, 2, a),
    "dil_conv_3x3_4": lambda c, s, a: DilConvS(c, c, 3, s, 4, 4, a),
    "dil_conv_5x5_4": lambda c, s, a: DilConvS(c, c, 5, s, 4, 2, a),
    "se_connect": lambda c, s, a: SEBlock(c, s, a),
    "conv_7x1_1x7": lambda c, s, a: FacConv(c, c, 7, s, 3, a),
    "sep_conv_3x3": lambda c, s, a: SepConv(c, c, 3, s, 1, a),
    "sep_conv_5x5": lambda c, s, a: SepConv(c, c, 5, s, 2, a),
    "poled_conv_x1": lambda c, s, a: PooledConv(c, c, s, 1, a),
    "poled_conv_x2": lambda c, s, a: PooledConv(c, c, s, 2, a),
}


def make_op(name: str, channels: int, stride: int,
            affine: bool = True) -> nn.Module:
    """Build edge op ``name`` on a ``channels``-wide state."""
    if name not in OPS:
        raise KeyError(f"unknown op {name!r} (known: {sorted(OPS)})")
    return OPS[name](channels, stride, affine)
