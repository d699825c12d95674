"""The primitive ops of the released NPPNet genotypes, as torch modules.

Port of ``npp_tpu/ops/primitives.py:181-392``, restricted to the ops the
released genotypes use (``npp_tpu/genotypes.py:100-176``). Tensors are
NCHW. Unlike flax, torch modules need their input width at construction,
so each module here takes ``c_in`` where flax infers it.

Child modules carry the names flax gives them (``Conv_0``, ``Conv_1``,
``BatchNorm_0``), so a flax variable path maps onto the state_dict key by
a fixed rule (``utils/convert.py``). BN is plain ``nn.BatchNorm2d``
(momentum 0.1, eps 1e-5): it already updates ``running_var`` with the
unbiased batch variance, which is what the hand-rolled JAX BN
(``npp_tpu/ops/primitives.py:24-82``) exists for. Pools are torch's own:
``F.max_pool2d`` pads with -inf, ``F.avg_pool2d(2, 2)`` has no padding.
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


def batch_norm(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


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
    """3x3 max pool + BN (``max_pool_3x3``)."""

    def __init__(self, c: int, stride: int):
        super().__init__()
        self.stride = stride
        self.BatchNorm_0 = batch_norm(c)

    def forward(self, x):
        return self.BatchNorm_0(F.max_pool2d(x, 3, self.stride, 1))


class ReLUConvBN(nn.Module):
    """ReLU - Conv - BN."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int,
                 padding: int):
        super().__init__()
        self.Conv_0 = conv(c_in, c_out, kernel, stride, padding, bias=False)
        self.BatchNorm_0 = batch_norm(c_out)

    def forward(self, x):
        return self.BatchNorm_0(self.Conv_0(F.relu(x)))


class DilConvS(nn.Module):
    """ReLU - depthwise (dilated) - pointwise - BN."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int,
                 padding: int, dilation: int):
        super().__init__()
        self.Conv_0 = conv(c_in, c_in, kernel, stride, padding, dilation,
                           groups=c_in, bias=False)
        self.Conv_1 = conv(c_in, c_out, 1, bias=False)
        self.BatchNorm_0 = batch_norm(c_out)

    def forward(self, x):
        return self.BatchNorm_0(self.Conv_1(self.Conv_0(F.relu(x))))


class SEBlock(nn.Module):
    """Squeeze-excitation ``se_connect``; at stride 2 it appends a 2x2
    average pool and a BN (``npp_tpu/ops/primitives.py:295-298``)."""

    def __init__(self, c_in: int, stride: int):
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

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.Conv_0 = conv(c_in, c_out // 2, 1, 2, bias=False)
        self.Conv_1 = conv(c_in, c_out // 2, 1, 2, bias=False)
        self.BatchNorm_0 = batch_norm(c_out)

    def forward(self, x):
        x = F.relu(x)
        out = torch.cat([self.Conv_0(x), self.Conv_1(x[:, :, 1:, 1:])], dim=1)
        return self.BatchNorm_0(out)


class PooledConv(nn.Module):
    """AvgPool2 - ReLU-Conv-BN - bilinear up x2 (``poled_conv_x1``)."""

    def __init__(self, c_in: int, c_out: int, stride: int):
        super().__init__()
        self.Conv_0 = conv(c_in, c_out, 3, stride, 1, bias=True)
        self.BatchNorm_0 = batch_norm(c_out)

    def forward(self, x):
        x = F.avg_pool2d(x, 2, 2)
        x = self.BatchNorm_0(self.Conv_0(F.relu(x)))
        return resize_scale(x, 2.0, align_corners=True)


# The released genotypes' entries of the reference OPS table
# (``npp_tpu/ops/primitives.py:370-387``). Each factory is
# (channels, stride) -> module; every op keeps the state's width.
OPS: dict[str, Callable[[int, int], nn.Module]] = {
    "none": lambda c, s: Zero(s),
    "max_pool_3x3": lambda c, s: PoolBN(c, s),
    "skip_connect": lambda c, s: (
        Identity() if s == 1 else FactorizedReduce(c, c)),
    "std_conv_3x3": lambda c, s: ReLUConvBN(c, c, 3, s, 1),
    "std_conv_1x1": lambda c, s: ReLUConvBN(c, c, 1, s, 0),
    "dil_conv_3x3_2": lambda c, s: DilConvS(c, c, 3, s, 2, 2),
    "dil_conv_3x3_4": lambda c, s: DilConvS(c, c, 3, s, 4, 4),
    "se_connect": lambda c, s: SEBlock(c, s),
    "poled_conv_x1": lambda c, s: PooledConv(c, c, s),
}


def make_op(name: str, channels: int, stride: int) -> nn.Module:
    """Build edge op ``name`` on a ``channels``-wide state."""
    if name not in OPS:
        raise NotImplementedError(
            f"op {name!r} is not used by the released genotypes and is not "
            f"ported yet (ported: {sorted(OPS)})")
    return OPS[name](channels, stride)
