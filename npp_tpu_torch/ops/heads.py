"""Context heads: strip pooling, SPHead, PSP, ASPP and PMSF (NCHW).

Port of ``npp_tpu/ops/heads.py:20-179``, with npp_tpu's defaults. No
head is on the released NPPNet forward; they are here for custom heads.
Unlike flax, a torch module needs its input width at construction, so
each head takes ``c_in``.

Child modules carry the names flax gives them (``_ConvBN_<k>``,
``StripPooling_<k>``, ``Conv_<k>``, ``BatchNorm_<k>``), so a flax head's
``params`` and ``batch_stats`` load through the weight bridge
(``utils/convert.load_jax_variables``). BN is ``nn.BatchNorm2d``
(momentum 0.1, eps 1e-5). npp_tpu's matrix-product pools are torch's
own: its ``adaptive_avg_pool`` is ``F.adaptive_avg_pool2d`` (the same
bins, floor(i * H / OH) to ceil((i + 1) * H / OH)) and its
``global_avg_pool`` a mean over H and W. ASPP keeps npp_tpu's quirk: one
BN instance normalises all five branches, so in train mode its running
statistics take five updates in turn.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from npp_tpu_torch.ops.primitives import batch_norm, conv
from npp_tpu_torch.ops.resize import resize_bilinear, resize_scale


class _ConvBN(nn.Module):
    """Conv (no bias by default) -> BN -> optional ReLU."""

    def __init__(self, c_in: int, c_out: int, kernel=(1, 1), padding=(0, 0),
                 relu: bool = False, bias: bool = False):
        super().__init__()
        self.Conv_0 = conv(c_in, c_out, kernel, padding=padding, bias=bias)
        self.BatchNorm_0 = batch_norm(c_out)
        self.relu = relu

    def forward(self, x):
        x = self.BatchNorm_0(self.Conv_0(x))
        return F.relu(x) if self.relu else x


class StripPooling(nn.Module):
    """Strip pooling block: two square pools and the row and column
    strips, each through a conv and resized back, fused with the input."""

    def __init__(self, c_in: int, pool_size: tuple[int, int] = (20, 12)):
        super().__init__()
        inter = c_in // 4
        self.pool_size = tuple(pool_size)
        self._ConvBN_0 = _ConvBN(c_in, inter, relu=True)
        self._ConvBN_1 = _ConvBN(c_in, inter, relu=True)
        self._ConvBN_2 = _ConvBN(inter, inter, (3, 3), (1, 1))
        self._ConvBN_3 = _ConvBN(inter, inter, (3, 3), (1, 1))
        self._ConvBN_4 = _ConvBN(inter, inter, (3, 3), (1, 1))
        self._ConvBN_5 = _ConvBN(inter, inter, (1, 3), (0, 1))
        self._ConvBN_6 = _ConvBN(inter, inter, (3, 1), (1, 0))
        self._ConvBN_7 = _ConvBN(inter, inter, (3, 3), (1, 1), relu=True)
        self._ConvBN_8 = _ConvBN(inter, inter, (3, 3), (1, 1), relu=True)
        self._ConvBN_9 = _ConvBN(2 * inter, c_in)

    def forward(self, x):
        h, w = x.shape[-2:]
        up = dict(align_corners=True)
        x1 = self._ConvBN_0(x)
        x2 = self._ConvBN_1(x)
        x2_1 = self._ConvBN_2(x1)
        s0, s1 = self.pool_size
        x2_2 = resize_bilinear(
            self._ConvBN_3(F.adaptive_avg_pool2d(x1, (s0, s0))), (h, w), **up)
        x2_3 = resize_bilinear(
            self._ConvBN_4(F.adaptive_avg_pool2d(x1, (s1, s1))), (h, w), **up)
        x2_4 = resize_bilinear(
            self._ConvBN_5(F.adaptive_avg_pool2d(x2, (1, w))), (h, w), **up)
        x2_5 = resize_bilinear(
            self._ConvBN_6(F.adaptive_avg_pool2d(x2, (h, 1))), (h, w), **up)
        y1 = self._ConvBN_7(F.relu(x2_1 + x2_2 + x2_3))
        y2 = self._ConvBN_8(F.relu(x2_5 + x2_4))
        out = self._ConvBN_9(torch.cat([y1, y2], dim=1))
        return F.relu(x + out)


class SPHead(nn.Module):
    """Strip-pooling head: a 1x1 reduction to half the width, two strip
    pooling blocks, then a 3x3 ConvBN and a biased 1x1 conv (``bias``)
    or one 3x3 ConvBN to ``out_features``."""

    def __init__(self, c_in: int, out_features: int,
                 pool_size: tuple[int, int] = (20, 12), bias: bool = True):
        super().__init__()
        inter = c_in // 2
        self.bias = bias
        self._ConvBN_0 = _ConvBN(c_in, inter, relu=True)
        self.StripPooling_0 = StripPooling(inter, pool_size)
        self.StripPooling_1 = StripPooling(inter, pool_size)
        if bias:
            self._ConvBN_1 = _ConvBN(inter, inter // 2, (3, 3), (1, 1),
                                     relu=True)
            self.Conv_0 = conv(inter // 2, out_features, 1)
        else:
            self._ConvBN_1 = _ConvBN(inter, out_features, (3, 3), (1, 1),
                                     relu=True)

    def forward(self, x):
        x = self._ConvBN_0(x)
        x = self.StripPooling_1(self.StripPooling_0(x))
        x = self._ConvBN_1(x)
        return self.Conv_0(x) if self.bias else x


class PSPModule(nn.Module):
    """Pyramid scene parsing: a pooled 1x1 ConvBN prior per size, resized
    back and concatenated with the input, then a 3x3 ConvBN + ReLU."""

    def __init__(self, c_in: int, out_features: int = 512,
                 sizes: Sequence[int] = (1, 2, 3, 6)):
        super().__init__()
        self.sizes = tuple(sizes)
        for i in range(len(self.sizes)):
            setattr(self, f"Conv_{i}", conv(c_in, out_features, 1,
                                            bias=False))
            setattr(self, f"BatchNorm_{i}", batch_norm(out_features))
        n = len(self.sizes)
        setattr(self, f"Conv_{n}", conv(n * out_features + c_in,
                                        out_features, 3, padding=1,
                                        bias=False))
        setattr(self, f"BatchNorm_{n}", batch_norm(out_features))

    def forward(self, x):
        h, w = x.shape[-2:]
        priors = []
        for i, size in enumerate(self.sizes):
            p = F.adaptive_avg_pool2d(x, (size, size))
            p = getattr(self, f"BatchNorm_{i}")(getattr(self, f"Conv_{i}")(p))
            priors.append(resize_bilinear(p, (h, w), align_corners=True))
        priors.append(x)
        n = len(self.sizes)
        y = getattr(self, f"Conv_{n}")(torch.cat(priors, dim=1))
        return F.relu(getattr(self, f"BatchNorm_{n}")(y))


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: the image mean, a 1x1 and one 3x3
    per dilation rate, all five through the one shared ``BatchNorm_0``,
    concatenated, then a 1x1 conv, BN and ReLU."""

    def __init__(self, c_in: int, depth: int = 256,
                 rates: Sequence[int] = (12, 24, 36)):
        super().__init__()
        self.rates = tuple(rates)
        self.BatchNorm_0 = batch_norm(depth)  # shared by the branches
        self.Conv_0 = conv(c_in, depth, 1)
        self.Conv_1 = conv(c_in, depth, 1)
        for i, r in enumerate(self.rates):
            setattr(self, f"Conv_{2 + i}", conv(c_in, depth, 3, padding=r,
                                                dilation=r))
        n = 2 + len(self.rates)
        setattr(self, f"Conv_{n}", conv(n * depth, depth, 1, bias=False))
        self.BatchNorm_1 = batch_norm(depth)

    def forward(self, x):
        h, w = x.shape[-2:]
        bn = self.BatchNorm_0
        gap = bn(self.Conv_0(x.mean(dim=(2, 3), keepdim=True)))
        branches = [resize_bilinear(gap, (h, w), align_corners=False),
                    bn(self.Conv_1(x))]
        for i in range(len(self.rates)):
            branches.append(bn(getattr(self, f"Conv_{2 + i}")(x)))
        y = getattr(self, f"Conv_{2 + len(self.rates)}")(
            torch.cat(branches, dim=1))
        return F.relu(self.BatchNorm_1(y))


class PMSF(nn.Module):
    """Pose multi-scale fusion: the input at each scale through a 1x1
    ConvBN, resized back, concatenated, then a 3x3 ConvBN + ReLU."""

    def __init__(self, c_in: int, out_features: int = 256,
                 sizes: Sequence[float] = (1, 0.5, 0.25, 0.125)):
        super().__init__()
        self.sizes = tuple(sizes)
        for i in range(len(self.sizes)):
            setattr(self, f"Conv_{i}", conv(c_in, out_features, 1,
                                            bias=False))
            setattr(self, f"BatchNorm_{i}", batch_norm(out_features))
        n = len(self.sizes)
        setattr(self, f"Conv_{n}", conv(n * out_features, out_features, 3,
                                        padding=1, bias=False))
        setattr(self, f"BatchNorm_{n}", batch_norm(out_features))

    def forward(self, x):
        h, w = x.shape[-2:]
        priors = []
        for i, size in enumerate(self.sizes):
            p = resize_scale(x, size, align_corners=True) if size != 1 else x
            p = getattr(self, f"BatchNorm_{i}")(getattr(self, f"Conv_{i}")(p))
            priors.append(resize_bilinear(p, (h, w), align_corners=True))
        n = len(self.sizes)
        y = getattr(self, f"Conv_{n}")(torch.cat(priors, dim=1))
        return F.relu(getattr(self, f"BatchNorm_{n}")(y))
