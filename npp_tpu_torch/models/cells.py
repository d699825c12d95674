"""Genotype-compiled cells: encoder, decoder upsample, refinement fusion,
and the cross-task injection edges.

Port of ``npp_tpu/models/cells.py:293-485`` in its standard (unfused)
layout; the sibling-fusion layout (``cells.py:34-290``) is not ported.
Tensors are NCHW; channel concat is on dim 1. Each module takes its input
widths at construction, where flax infers them. The child names
(``preprocess0``, ``ops.<i>``, ``op``, ``proj``) follow the flax tree.
Under tensor parallelism (``tp``, ``parallel/tensor.py``) a cell adds
its node pairs in one layout, gathers each node whole before its
concatenation, and an injection edge returns its output whole; with
``tp`` None the code is as it was.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from npp_tpu_torch.genotypes import Edge
from npp_tpu_torch.ops.primitives import (FactorizedReduce, ReLUConvBN,
                                          conv, make_op)
from npp_tpu_torch.ops.resize import resize_scale


def _run_steps(edges, ops, states, post=None, tp=None, width=0):
    """DARTS steps: node k+len(inputs) = op(2k)(s) + op(2k+1)(s'), each edge
    optionally post-processed by ``post(edge_index, y)``; with ``tp`` the
    pair is added in one layout of its ``width`` channels."""
    for i in range(len(edges) // 2):
        hs = []
        for e in (2 * i, 2 * i + 1):
            y = ops[e](states[edges[e][1]])
            hs.append(post(e, y) if post is not None else y)
        if tp is not None:
            hs = tp.aligned(hs[0], hs[1], width)
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
    wide."""

    tp = None

    def __init__(self, edges: tuple[Edge, ...], concat: tuple[int, ...],
                 c_pp: int, c_p: int, channels: int, reduction: bool,
                 reduction_prev: bool):
        super().__init__()
        c = channels
        self.edges, self.concat, self.channels = edges, concat, c
        self.preprocess0 = (FactorizedReduce(c_pp, c) if reduction_prev
                            else ReLUConvBN(c_pp, c, 1, 1, 0))
        self.preprocess1 = ReLUConvBN(c_p, c, 1, 1, 0)
        self.ops = nn.ModuleList(
            make_op(name, c, 2 if reduction and index < 2 else 1)
            for name, index in edges)

    def forward(self, s0, s1):
        states = _run_steps(self.edges, self.ops,
                            [self.preprocess0(s0), self.preprocess1(s1)],
                            tp=self.tp, width=self.channels)
        return _concat([states[i] for i in self.concat], self.tp,
                       self.channels)


class UpsampleCell(nn.Module):
    """Decoder upsample cell. ``s0`` (``c_s0`` wide) is the coarser feature;
    the ops reading state 0 are followed by a 2x bilinear upsample
    (align_corners=True). Node width is ``c_prev // 4``, where ``c_prev``
    is the width of the skip feature ``s1``."""

    space = None
    tp = None

    def __init__(self, edges: tuple[Edge, ...], concat: tuple[int, ...],
                 c_s0: int, c_prev: int):
        super().__init__()
        c = c_prev // 4
        self.edges, self.concat, self.channels = edges, concat, c
        self.preprocess0 = ReLUConvBN(c_s0, c, 1, 1, 0)
        self.preprocess1 = ReLUConvBN(c_prev, c, 1, 1, 0)
        self.ops = nn.ModuleList(make_op(name, c, 1) for name, _ in edges)

    def _post(self, e, y):
        if self.edges[e][1] == 0:
            return resize_scale(y, 2.0, align_corners=True, space=self.space)
        return y

    def forward(self, s0, s1):
        states = _run_steps(self.edges, self.ops,
                            [self.preprocess0(s0), self.preprocess1(s1)],
                            self._post, self.tp, self.channels)
        return _concat([states[i] for i in self.concat], self.tp,
                       self.channels)


class FusionCell(nn.Module):
    """Refinement cell of the pose / parsing branches (order=1 only). Takes
    three states of widths ``c_ins`` and returns ``(fea1, fea2)``: the
    concat of the three preprocessed inputs and the concat of the
    ``concat`` nodes."""

    tp = None

    def __init__(self, edges: tuple[Edge, ...], concat: tuple[int, ...],
                 c_ins: tuple[int, int, int], channels: int):
        super().__init__()
        c = channels
        self.edges, self.concat, self.channels = edges, concat, c
        self.preprocess0 = ReLUConvBN(c_ins[0], c, 1, 1, 0)
        self.preprocess1 = ReLUConvBN(c_ins[1], c, 1, 1, 0)
        self.preprocess2 = ReLUConvBN(c_ins[2], c, 1, 1, 0)
        self.ops = nn.ModuleList(make_op(name, c, 1) for name, _ in edges)

    def forward(self, s0, s1, s2):
        states = _run_steps(self.edges, self.ops,
                            [self.preprocess0(s0), self.preprocess1(s1),
                             self.preprocess2(s2)], tp=self.tp,
                            width=self.channels)
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
