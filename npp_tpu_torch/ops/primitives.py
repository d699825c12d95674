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

The ops that read across rows other than through a conv module (the
pools, the squeeze-excitation mean, ``FactorizedReduce``'s shift, the
strided ``Zero``, ``PooledConv``'s resizes) run on H-sharded rows when
``parallel.spatial.convert_spatial`` gives them a ``space``; with
``space`` None (the default) they are the code below as it was. The ops
that read channels other than through a conv or a BN module
(``SEBlock``'s product, ``FactorizedReduce``'s concatenation) run on a
channel block when ``parallel.tensor.convert_tensor_parallel`` gives them
a ``tp``; with ``tp`` None they are unchanged too. Every dense conv
(groups 1) serves in int8 once ``ops/quantize.prepare_int8`` has made it
an ``Int8Conv2d``; grouped and depthwise convs stay floating point. A
ReLU that feeds a dense conv goes through ``quantize.relu_conv``: the
same ``conv(F.relu(x))`` in floating point, the ReLU folded into the
activation quantize in int8.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from npp_tpu_torch.ops.quantize import folds_relu, relu_conv
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

    space = None

    def __init__(self, stride: int):
        super().__init__()
        self.stride = stride

    def _strided(self, x):
        return x[:, :, ::self.stride, ::self.stride] * 0.0

    def forward(self, x):
        if self.stride == 1:
            return x * 0.0
        if self.space is not None:
            return self.space.window(x, self._strided, 1, self.stride, 0)
        return self._strided(x)


class Identity(nn.Module):
    def forward(self, x):
        return x


class PoolBN(nn.Module):
    """3x3 max or average pool + BN (``max_pool_3x3``, ``avg_pool_3x3``)."""

    space = None

    def __init__(self, pool_type: str, c: int, stride: int,
                 affine: bool = True):
        super().__init__()
        self.pool_type, self.stride = pool_type, stride
        self.BatchNorm_0 = batch_norm(c, affine)

    def _pool(self, x):
        if self.pool_type == "max":
            return F.max_pool2d(x, 3, self.stride, 1)
        return F.avg_pool2d(x, 3, self.stride, 1, count_include_pad=False)

    def forward(self, x):
        if self.space is not None:
            return self.BatchNorm_0(self.space.window(x, self._pool, 3,
                                                      self.stride, 1))
        return self.BatchNorm_0(self._pool(x))


class ReLUConvBN(nn.Module):
    """ReLU - Conv - BN."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int,
                 padding: int, affine: bool = True):
        super().__init__()
        self.Conv_0 = conv(c_in, c_out, kernel, stride, padding, bias=False)
        self.BatchNorm_0 = batch_norm(c_out, affine)

    def forward(self, x):
        return self.BatchNorm_0(relu_conv(self.Conv_0, x))


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

    space = None
    tp = None

    def __init__(self, c_in: int, stride: int, affine: bool = True):
        super().__init__()
        self.stride = stride
        self.Conv_0 = conv(c_in, c_in // 2, 1)
        self.Conv_1 = conv(c_in // 2, c_in, 1)
        if stride != 1:
            self.BatchNorm_0 = batch_norm(c_in)

    def forward(self, x):
        if self.space is not None:
            w = self.space.mean_hw(x)
        else:
            w = x.mean(dim=(2, 3), keepdim=True)
        w = torch.sigmoid(relu_conv(self.Conv_1, self.Conv_0(w)))
        if self.tp is not None:
            x, w = self.tp.aligned(x, w, self.Conv_1.out_channels)
        out = x * w
        if self.stride == 1:
            return out
        if self.space is not None:
            return self.BatchNorm_0(self.space.window(out, _avg_pool_2x2,
                                                      2, 2, 0))
        return self.BatchNorm_0(F.avg_pool2d(out, 2, 2))


class FactorizedReduce(nn.Module):
    """Stride-2 factorized pointwise reduce; the second branch reads the
    input shifted by one pixel (``npp_tpu/ops/primitives.py:314``)."""

    space = None
    tp = None

    def __init__(self, c_in: int, c_out: int, affine: bool = True):
        super().__init__()
        self.Conv_0 = conv(c_in, c_out // 2, 1, 2, bias=False)
        self.Conv_1 = conv(c_in, c_out // 2, 1, 2, bias=False)
        self.BatchNorm_0 = batch_norm(c_out, affine)

    def _branches(self, x, at_top=True, relu=False):
        """Both branches with the convs' own arithmetic: output row o reads
        input rows 2o and 2o + 1 (one window of 2 rows at stride 2). On a
        channel block each branch is gathered whole: the concatenation of
        two blocks is not the BN's block. ``_conv_forward`` is the conv
        alone, without a sharded conv's input handling; for an int8 conv
        (``ops/quantize.prepare_int8``) it is the int8 route, which takes
        ``relu=True`` (the ReLU folded into each branch's quantize: it
        commutes with the shift). The second branch's dynamic scale is
        that of the whole input without its first row and column; on rows
        that do not begin at the image's (``at_top`` False: a space rank
        below the first) only the first column is left out of it."""
        c0, c1 = self.Conv_0, self.Conv_1
        kw = dict(relu=True) if relu else {}
        y0 = c0._conv_forward(x, c0.weight, c0.bias, **kw)
        if relu and not at_top:
            kw["seen"] = x[:, :, :, 1:]
        y1 = c1._conv_forward(x[:, :, 1:, 1:], c1.weight, c1.bias, **kw)
        if self.tp is not None:
            y0 = self.tp.whole(y0, c0.out_channels)
            y1 = self.tp.whole(y1, c1.out_channels)
        return torch.cat([y0, y1], dim=1)

    def forward(self, x):
        fold = folds_relu(self.Conv_0)  # int8 (never tensor parallel)
        if not fold:
            x = F.relu(x)
        if self.tp is not None:  # once for both convs
            x = self.tp.conv_input(self.Conv_0, x)
        if self.space is not None:
            return self.BatchNorm_0(self.space.window(
                x, lambda t, at_top: self._branches(t, at_top, fold), 2, 2, 0,
                top=True))
        return self.BatchNorm_0(self._branches(x, relu=fold))


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
        return self.BatchNorm_0(self.Conv_1(relu_conv(self.Conv_0, x)))


class PooledConv(nn.Module):
    """AvgPool2 - [ReLU-Conv-BN] x ``conv_nums`` - bilinear up x2
    (``poled_conv_x1``, ``poled_conv_x2``; the latter at stride 2 upsamples
    twice)."""

    space = None

    def __init__(self, c_in: int, c_out: int, stride: int,
                 conv_nums: int = 1, affine: bool = True):
        super().__init__()
        self.conv_nums, self.stride = conv_nums, stride
        for i in range(conv_nums):
            setattr(self, f"Conv_{i}", conv(c_in if i == 0 else c_out, c_out,
                                            3, stride, 1, bias=True))
            setattr(self, f"BatchNorm_{i}", batch_norm(c_out, affine))

    def forward(self, x):
        if self.space is not None:
            x = self.space.window(x, _avg_pool_2x2, 2, 2, 0)
        else:
            x = F.avg_pool2d(x, 2, 2)
        for i in range(self.conv_nums):
            x = relu_conv(getattr(self, f"Conv_{i}"), x)
            x = getattr(self, f"BatchNorm_{i}")(x)
        x = resize_scale(x, 2.0, align_corners=True, space=self.space)
        if self.conv_nums == 2 and self.stride == 2:
            x = resize_scale(x, 2.0, align_corners=True, space=self.space)
        return x


def _avg_pool_2x2(x):
    return F.avg_pool2d(x, 2, 2)


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
