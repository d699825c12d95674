"""Genotype-compiled cells: encoder, decoder upsample, refinement fusion,
and the cross-task injection edges.

Port of ``npp_tpu/models/cells.py``. Tensors are NCHW; channel concat is
on dim 1. Each module takes its input widths at construction, where flax
infers them. The child names (``preprocess0``, ``ops.<i>``, ``sib.<g>``,
``op``, ``proj``) follow the flax tree. Under tensor parallelism (``tp``,
``parallel/tensor.py``) a cell adds its node pairs in one layout, gathers
each node whole before its concatenation, and an injection edge returns
its output whole; with ``tp`` None the code is as it was.

``fuse_siblings`` is npp_tpu's serving layout of a cell
(``cells.py:23-290``): the edges that ``sibling_groups`` puts together
(same op of ``sibling_families``, same input state, same stride) run as
one K-wide group module, computed once per cell call at its group's first
edge, each edge reading its slice of the output; the other edges keep
their ops, renumbered densely. Exact in floating point in both modes: a
conv's output channels and a BN's statistics are per channel.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from npp_tpu_torch.genotypes import Edge
from npp_tpu_torch.ops.primitives import (FactorizedReduce, ReLUConvBN,
                                          _avg_pool_2x2, batch_norm, conv,
                                          make_op)
from npp_tpu_torch.ops.quantize import relu_conv
from npp_tpu_torch.ops.resize import resize_scale

# Sibling-mergeable primitive families (npp_tpu/models/cells.py:23-31):
# DEFAULT is npp_tpu's serving set (std convs and SE); ALL adds the
# dil / sep depthwise chains.
DEFAULT_SIBLING_FAMILIES = ("std_conv_3x3", "std_conv_1x1", "se_connect")
ALL_SIBLING_FAMILIES = DEFAULT_SIBLING_FAMILIES + (
    "dil_conv_3x3_2", "dil_conv_3x3_4", "dil_conv_5x5_4",
    "sep_conv_3x3", "sep_conv_5x5")
# (kernel, padding, dilation) per dil primitive, (kernel, padding) per sep
# primitive, as the OPS table builds them.
_DIL_SPECS = {"dil_conv_3x3_2": (3, 2, 2), "dil_conv_3x3_4": (3, 4, 4),
              "dil_conv_5x5_4": (5, 4, 2)}
_SEP_SPECS = {"sep_conv_3x3": (3, 1), "sep_conv_5x5": (5, 2)}


def sibling_groups(edges, reduction: bool = False,
                   families=DEFAULT_SIBLING_FAMILIES):
    """Edge-index groups of >= 2 edges of one op of ``families`` reading
    the same state with the same stride: ``[((name, state, stride),
    (edge, ...)), ...]`` sorted by first edge. The cells and the state
    transforms (``models/augment.py``) both call this, so their layouts
    agree."""
    byk: dict = {}
    for i, (name, idx) in enumerate(edges):
        if name in families:
            stride = 2 if reduction and idx < 2 else 1
            byk.setdefault((name, idx, stride), []).append(i)
    groups = [(k, tuple(v)) for k, v in byk.items() if len(v) >= 2]
    groups.sort(key=lambda kv: kv[1][0])
    return groups


class SiblingConvGroup(nn.Module):
    """K ReLU - conv - BN edges of one spec on one input as one op of
    K x ``c`` output channels (``Conv_0``, ``BatchNorm_0``, as
    ``ReLUConvBN``'s); the caller slices per edge. Under int8 the K edges
    share one activation scale (npp_tpu's caveat)."""

    def __init__(self, c: int, k: int, kernel: int, stride: int,
                 padding: int):
        super().__init__()
        self.Conv_0 = conv(c, k * c, kernel, stride, padding, bias=False)
        self.BatchNorm_0 = batch_norm(k * c)

    def forward(self, x):
        return self.BatchNorm_0(relu_conv(self.Conv_0, x))


class SiblingSEGroup(nn.Module):
    """K squeeze-excitation edges on one input: the squeeze once, the K
    first 1x1 convs as one (C -> K C/2) conv, the K second ones as one
    grouped conv (groups K, block-diagonal), then the stride-2 tail
    (2x2 average pool, BN) over the K products. Children as ``SEBlock``'s.
    Under int8 the grouped conv stays floating point. On rows of a space
    axis (``space``, ``parallel/spatial.py``) the squeeze is the whole
    image's mean and the pool a window, as ``SEBlock``'s."""

    space = None

    def __init__(self, c: int, k: int, stride: int):
        super().__init__()
        self.k, self.stride = k, stride
        self.Conv_0 = conv(c, k * (c // 2), 1)
        self.Conv_1 = conv(k * (c // 2), k * c, 1, groups=k)
        if stride != 1:
            self.BatchNorm_0 = batch_norm(k * c)

    def forward(self, x):
        c = x.shape[1]
        if self.space is not None:
            w = self.space.mean_hw(x)
        else:
            w = x.mean(dim=(2, 3), keepdim=True)
        w = torch.sigmoid(relu_conv(self.Conv_1, self.Conv_0(w)))
        out = torch.cat([x * w[:, i * c:(i + 1) * c] for i in range(self.k)],
                        dim=1)
        if self.stride == 1:
            return out
        if self.space is not None:
            return self.BatchNorm_0(self.space.window(out, _avg_pool_2x2,
                                                      2, 2, 0))
        return self.BatchNorm_0(F.avg_pool2d(out, 2, 2))


class SiblingDilGroup(nn.Module):
    """K ReLU - depthwise (dilated) - pointwise - BN edges on one input as
    one blocked chain: the input tiled K-fold along channels ([x, x, ...]),
    one depthwise conv of K x ``c_in`` channels, one grouped pointwise conv
    (groups K) and one BN (``Conv_0``, ``Conv_1``, ``BatchNorm_0``, as
    ``DilConvS``'s). ``tiled_input=False`` takes an input already blocked
    K-fold (the second stage of ``SiblingSepGroup``). Under int8 the
    grouped pointwise conv stays floating point."""

    def __init__(self, c_in: int, c_out: int, k: int, kernel: int,
                 stride: int, padding: int, dilation: int,
                 tiled_input: bool = True):
        super().__init__()
        self.k, self.tiled_input = k, tiled_input
        self.Conv_0 = conv(k * c_in, k * c_in, kernel, stride, padding,
                           dilation, groups=k * c_in, bias=False)
        self.Conv_1 = conv(k * c_in, k * c_out, 1, groups=k, bias=False)
        self.BatchNorm_0 = batch_norm(k * c_out)

    def forward(self, x):
        x = F.relu(x)
        if self.tiled_input:
            x = x.repeat(1, self.k, 1, 1)
        return self.BatchNorm_0(self.Conv_1(self.Conv_0(x)))


class SiblingSepGroup(nn.Module):
    """K sep-conv edges on one input: two blocked dil-group stages, the
    input tiled once (``DilConvS_0``, ``DilConvS_1``, as ``SepConv``'s)."""

    def __init__(self, c: int, k: int, kernel: int, stride: int,
                 padding: int):
        super().__init__()
        self.DilConvS_0 = SiblingDilGroup(c, c, k, kernel, stride, padding, 1)
        self.DilConvS_1 = SiblingDilGroup(c, c, k, kernel, 1, padding, 1,
                                          tiled_input=False)

    def forward(self, x):
        return self.DilConvS_1(self.DilConvS_0(x))


def _group_module(name: str, c: int, k: int, stride: int) -> nn.Module:
    if name == "se_connect":
        return SiblingSEGroup(c, k, stride)
    if name in _DIL_SPECS:
        ksz, pad, dil = _DIL_SPECS[name]
        return SiblingDilGroup(c, c, k, ksz, stride, pad, dil)
    if name in _SEP_SPECS:
        ksz, pad = _SEP_SPECS[name]
        return SiblingSepGroup(c, k, ksz, stride, pad)
    ksz, pad = (3, 1) if name == "std_conv_3x3" else (1, 0)
    return SiblingConvGroup(c, k, ksz, stride, pad)


def _build_edge_ops(cell: nn.Module, c: int, strides, fuse_siblings: bool,
                    families, reduction: bool = False) -> None:
    """The cell's ``ops`` (one per edge) or, with ``fuse_siblings``, its
    group modules ``sib`` and the other edges' ``ops`` numbered densely;
    ``_slot[e]`` = (group, slice) of a grouped edge, ``_pos[e]`` the
    index in ``ops`` of another."""
    edges = cell.edges
    groups = (sibling_groups(edges, reduction, families) if fuse_siblings
              else [])
    cell._slot = {e: (g, i) for g, (_, es) in enumerate(groups)
                  for i, e in enumerate(es)}
    cell._group_size = [len(es) for _, es in groups]
    if groups:
        cell.sib = nn.ModuleList(_group_module(name, c, len(es), stride)
                                 for (name, _, stride), es in groups)
    rest = [e for e in range(len(edges)) if e not in cell._slot]
    cell._pos = {e: j for j, e in enumerate(rest)}
    cell.ops = nn.ModuleList(make_op(edges[e][0], c, strides[e])
                             for e in rest)


def _run_steps(cell, states, post=None):
    """DARTS steps: node k+len(inputs) = op(2k)(s) + op(2k+1)(s'), each edge
    optionally post-processed by ``post(edge_index, y)``. A grouped edge
    (``_build_edge_ops``) reads its slice of its group's output, computed
    (and post-processed) once per call, at the group's first edge. With
    ``cell.tp`` the pair is added in one layout of ``cell.channels``
    channels."""
    edges, cache = cell.edges, {}
    for i in range(len(edges) // 2):
        hs = []
        for e in (2 * i, 2 * i + 1):
            x = states[edges[e][1]]
            if e in cell._slot:
                g, j = cell._slot[e]
                if g not in cache:
                    y = cell.sib[g](x)
                    cache[g] = post(e, y) if post is not None else y
                c = cache[g].shape[1] // cell._group_size[g]
                hs.append(cache[g][:, j * c:(j + 1) * c])
                continue
            y = cell.ops[cell._pos[e]](x)
            hs.append(post(e, y) if post is not None else y)
        if cell.tp is not None:
            hs = cell.tp.aligned(hs[0], hs[1], cell.channels)
        states.append(hs[0] + hs[1])
    return states


def _concat(states, tp, width):
    """The channel concatenation of ``width``-channel nodes, each whole."""
    if tp is not None:
        states = [tp.whole(t, width) for t in states]
    return torch.cat(states, dim=1)


class Cell(nn.Module):
    """DARTS encoder cell with a fixed genotype. ``c_pp``/``c_p`` are the
    widths of the two inputs; the output is ``len(concat) * channels``
    wide. ``fuse_siblings``: module docstring."""

    tp = None

    def __init__(self, edges: tuple[Edge, ...], concat: tuple[int, ...],
                 c_pp: int, c_p: int, channels: int, reduction: bool,
                 reduction_prev: bool, fuse_siblings: bool = False,
                 sibling_families=DEFAULT_SIBLING_FAMILIES):
        super().__init__()
        c = channels
        self.edges, self.concat, self.channels = edges, concat, c
        self.preprocess0 = (FactorizedReduce(c_pp, c) if reduction_prev
                            else ReLUConvBN(c_pp, c, 1, 1, 0))
        self.preprocess1 = ReLUConvBN(c_p, c, 1, 1, 0)
        _build_edge_ops(self, c, [2 if reduction and index < 2 else 1
                                  for _, index in edges],
                        fuse_siblings, sibling_families, reduction)

    def forward(self, s0, s1):
        states = _run_steps(self, [self.preprocess0(s0),
                                   self.preprocess1(s1)])
        return _concat([states[i] for i in self.concat], self.tp,
                       self.channels)


class UpsampleCell(nn.Module):
    """Decoder upsample cell. ``s0`` (``c_s0`` wide) is the coarser feature;
    the ops reading state 0 are followed by a 2x bilinear upsample
    (align_corners=True). Node width is ``c_prev // 4``, where ``c_prev``
    is the width of the skip feature ``s1``. A fused group of state-0
    edges is upsampled once, before the per-edge slice."""

    space = None
    tp = None

    def __init__(self, edges: tuple[Edge, ...], concat: tuple[int, ...],
                 c_s0: int, c_prev: int, fuse_siblings: bool = False,
                 sibling_families=DEFAULT_SIBLING_FAMILIES):
        super().__init__()
        c = c_prev // 4
        self.edges, self.concat, self.channels = edges, concat, c
        self.preprocess0 = ReLUConvBN(c_s0, c, 1, 1, 0)
        self.preprocess1 = ReLUConvBN(c_prev, c, 1, 1, 0)
        _build_edge_ops(self, c, [1] * len(edges), fuse_siblings,
                        sibling_families)

    def _post(self, e, y):
        if self.edges[e][1] == 0:
            return resize_scale(y, 2.0, align_corners=True, space=self.space)
        return y

    def forward(self, s0, s1):
        states = _run_steps(self, [self.preprocess0(s0),
                                   self.preprocess1(s1)], self._post)
        return _concat([states[i] for i in self.concat], self.tp,
                       self.channels)


class FusionCell(nn.Module):
    """Refinement cell of the pose / parsing branches (order=1 only). Takes
    three states of widths ``c_ins`` and returns ``(fea1, fea2)``: the
    concat of the three preprocessed inputs and the concat of the
    ``concat`` nodes."""

    tp = None

    def __init__(self, edges: tuple[Edge, ...], concat: tuple[int, ...],
                 c_ins: tuple[int, int, int], channels: int,
                 fuse_siblings: bool = False,
                 sibling_families=DEFAULT_SIBLING_FAMILIES):
        super().__init__()
        c = channels
        self.edges, self.concat, self.channels = edges, concat, c
        self.preprocess0 = ReLUConvBN(c_ins[0], c, 1, 1, 0)
        self.preprocess1 = ReLUConvBN(c_ins[1], c, 1, 1, 0)
        self.preprocess2 = ReLUConvBN(c_ins[2], c, 1, 1, 0)
        _build_edge_ops(self, c, [1] * len(edges), fuse_siblings,
                        sibling_families)

    def forward(self, s0, s1, s2):
        states = _run_steps(self, [self.preprocess0(s0),
                                   self.preprocess1(s1),
                                   self.preprocess2(s2)])
        fea1 = _concat(states[0:3], self.tp, self.channels)
        fea2 = _concat([states[i] for i in self.concat], self.tp,
                       self.channels)
        return fea1, fea2


class InterOp(nn.Module):
    """One compiled cross-task injection edge: the primitive at the source
    scale and width, then, if the edge crosses scales or widths, a
    bilinear resize (align_corners=True) and a 1x1 conv to the
    destination width."""

    space = None
    tp = None

    def __init__(self, op_name: str, src_channels: int, dst_channels: int,
                 scale: float, adapt: bool):
        super().__init__()
        self.scale, self.adapt = scale, adapt
        self.out_channels = dst_channels if adapt else src_channels
        self.op = make_op(op_name, src_channels, 1)
        if adapt:
            self.proj = conv(src_channels, dst_channels, 1, bias=True)

    def forward(self, x):
        y = self.op(x)
        if self.adapt:
            if self.scale != 1:
                y = resize_scale(y, self.scale, align_corners=True,
                                 space=self.space)
            y = self.proj(y)
        if self.tp is not None:
            y = self.tp.whole(y, self.out_channels)
        return y


def compile_encoder_injections(groups, c_list):
    """Encoder-stage injections. ``c_list`` is the width per feature scale
    (index 0 = 1/4 res). Returns the flat op list and the source indices
    of each group."""
    ops, indices = [], []
    for cont, group in enumerate(groups):
        idxs = []
        for name, ind in group:
            scale = 1.0 / (2 ** (cont - ind))
            ops.append(InterOp(name, c_list[ind], c_list[cont], scale,
                               adapt=(ind != cont)))
            idxs.append(ind)
        indices.append(tuple(idxs))
    return ops, tuple(indices)


def compile_decoder_injections(groups, resolutions, c_list):
    """Decoder-stage injections over the 7-slot feature pyramid."""
    ops, indices = [], []
    for cont, group in enumerate(groups):
        idxs = []
        for name, ind in group:
            scale = resolutions[4 + cont] / resolutions[ind]
            ops.append(InterOp(name, c_list[ind], c_list[4 + cont], scale,
                               adapt=(ind != 4 + cont)))
            idxs.append(ind)
        indices.append(tuple(idxs))
    return ops, tuple(indices)
