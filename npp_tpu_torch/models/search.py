"""The interaction-search supernet: NPPNet with every cross-task injection
and every refinement-cell edge a weighted mix of candidate primitives.

Port of ``npp_tpu/models/search.py`` in its unrolled layout
(``vmap_fusion=False``, ``vmap_injections=False``, ``remat=False``): the
fixed encoder and decoder cells of the released genotypes, 10 + 10
encoder-stage and 18 + 18 decoder-stage injection ``MixedOp``s, the
necks, 3 + 3 ``SearchFusionCell``s of 18 ``MixedOp``s each, the heads,
and the 12 architecture parameters (``alphas*``, ``betas*``, initialised
to 1e-3) as ``nn.Parameter``s under their flax names. Not ported: the
vmapped fusion and injection layouts, the merged encoder streams and
rematerialisation (ways to shrink the TPU program), and the shift-based
pools (torch's pools compute the same values). The weight bridge
(``utils/convert.py``) unrolls a vmapped flax tree on load.

Tensors are NCHW. ``forward`` returns ``(pose_list, par_list)`` as
NPPNet's does. ``dtype=torch.bfloat16`` runs under autocast, as NPPNet;
the weighted sums of the mixed ops, the injections and the fusion steps
accumulate in float32, as the JAX package's do (a float32 softmax weight
times a bfloat16 feature is float32 in JAX, where torch would keep a
0-dim float32 weight times a bfloat16 tensor in bfloat16).

One departure from the unrolled JAX layout, taken from its default
(vmapped) one: a cross-scale ``MixedOp`` resizes the alpha-weighted sum
of its candidates once instead of each candidate before the sum. The
bilinear resize is linear, so the two are equal up to rounding
(``tests/test_torch_search.py`` holds the port against the unrolled JAX
supernet).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from npp_tpu_torch import genotypes as gt
from npp_tpu_torch.models.augment import (_Head, _Neck, _Stem, encoder_plan,
                                          init_weights)
from npp_tpu_torch.models.cells import Cell, UpsampleCell
from npp_tpu_torch.ops.primitives import ReLUConvBN, batch_norm, conv, make_op
from npp_tpu_torch.ops.resize import (resize_nearest, resize_scale,
                                      scale_output_size)

ARCH_PARAM_NAMES = ("alphas1", "alphas2", "alphas3", "alphas4",
                    "alphas_pose", "alphas_par", "betas1", "betas2",
                    "betas3", "betas4", "betas_pose", "betas_par")
ARCH_INIT = 1e-3


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """NCHW channel shuffle: channel ``g * (C / groups) + k`` moves to
    ``k * groups + g``."""
    b, c, h, w = x.shape
    x = x.reshape(b, groups, c // groups, h, w).transpose(1, 2)
    return x.reshape(b, c, h, w)


def weighted_sum(weights: torch.Tensor, terms) -> torch.Tensor:
    """``sum_i weights[i] * terms[i]`` in order, accumulated in float32."""
    out = terms[0].float() * weights[0]
    for i in range(1, len(terms)):
        out = torch.addcmul(out, terms[i], weights[i])
    return out


class MixedOp(nn.Module):
    """Partial-channel mixed op: the candidates run on the first half of
    the ``channels`` (affine-free BNs; a pool gets one more affine-free BN),
    their alpha-weighted sum is resized by ``up_scale`` (bilinear,
    align_corners=True), the second half passes through (nearest-resized,
    and 2x2 max-pooled if it still differs in size), a channel shuffle
    recombines the halves, and with ``extra_features`` a 1x1 ``proj``
    maps to the destination width."""

    def __init__(self, channels: int, up_scale: Optional[float] = None,
                 extra_features: Optional[int] = None):
        super().__init__()
        half = channels // 2
        self.channels, self.up_scale = channels, up_scale
        self.pools = tuple(i for i, p in enumerate(gt.PRIMITIVES_INTER)
                           if "pool" in p)
        self.ops = nn.ModuleList(make_op(p, half, 1, affine=False)
                                 for p in gt.PRIMITIVES_INTER)
        self.extra_bns = nn.ModuleList(batch_norm(half, affine=False)
                                       for _ in self.pools)
        if extra_features is not None:
            self.proj = conv(channels, extra_features, 1, bias=True)
        else:
            self.proj = None

    def forward(self, x, weights):
        half = self.channels // 2
        xt, xt2 = x[:, :half], x[:, half:]
        ys = []
        for i, op in enumerate(self.ops):
            y = op(xt)
            if i in self.pools:
                y = self.extra_bns[self.pools.index(i)](y)
            ys.append(y)
        out = weighted_sum(weights, ys)
        if self.up_scale:
            h = scale_output_size(xt.shape[-2], self.up_scale)
            w = scale_output_size(xt.shape[-1], self.up_scale)
            out = resize_scale(out, self.up_scale, align_corners=True)
            xt2 = resize_nearest(xt2, (h, w))
        if out.shape[-2] != xt2.shape[-2]:
            xt2 = F.max_pool2d(xt2, 2, 2)
        ans = channel_shuffle(torch.cat([out, xt2], dim=1), 2)
        return self.proj(ans) if self.proj is not None else ans


def _run_mixed_steps(ops, states, alpha_w, beta_w, steps: int):
    """Searchable DARTS steps: step i is the beta-weighted sum of one
    ``MixedOp`` over every prior state."""
    offset = 0
    for _ in range(steps):
        n = len(states)
        outs = [ops[offset + j](h, alpha_w[offset + j])
                for j, h in enumerate(states)]
        states.append(weighted_sum(beta_w[offset:offset + n], outs))
        offset += n
    return states


class SearchFusionCell(nn.Module):
    """Searchable refinement cell: 4 steps, step i sums (3 + i) MixedOps
    over all prior states, weighted by per-edge betas. Inputs are
    ``c_ins`` wide; returns (the concat of the three preprocessed inputs,
    the concat of the last ``multiplier`` states)."""

    def __init__(self, c_ins: tuple[int, int, int], channels: int,
                 steps: int = 4, multiplier: int = 4):
        super().__init__()
        c = channels
        self.steps, self.multiplier = steps, multiplier
        self.preprocess0 = ReLUConvBN(c_ins[0], c, 1, 1, 0)
        self.preprocess1 = ReLUConvBN(c_ins[1], c, 1, 1, 0)
        self.preprocess2 = ReLUConvBN(c_ins[2], c, 1, 1, 0)
        self.ops = nn.ModuleList(MixedOp(c) for i in range(steps)
                                 for _ in range(3 + i))

    def forward(self, s0, s1, s2, alpha_w, beta_w):
        states = _run_mixed_steps(
            self.ops, [self.preprocess0(s0), self.preprocess1(s1),
                       self.preprocess2(s2)], alpha_w, beta_w, self.steps)
        fea1 = torch.cat(states[0:3], dim=1)
        fea2 = torch.cat(states[-self.multiplier:], dim=1)
        return fea1, fea2


class SearchUpsampleCell(nn.Module):
    """Searchable decoder upsample cell: the fixed ``UpsampleCell`` with a
    MixedOp on every edge, those reading state 0 (the coarser ``c_s0``-wide
    feature) upscaled 2x. Defined for parity with the JAX package; the
    released search keeps the decoder fixed."""

    def __init__(self, c_s0: int, c_prev: int, steps: int = 4,
                 multiplier: int = 4):
        super().__init__()
        c = c_prev // 4
        self.steps, self.multiplier = steps, multiplier
        self.preprocess0 = ReLUConvBN(c_s0, c, 1, 1, 0)
        self.preprocess1 = ReLUConvBN(c_prev, c, 1, 1, 0)
        self.ops = nn.ModuleList(MixedOp(c, 2.0 if j == 0 else None)
                                 for i in range(steps) for j in range(2 + i))

    def forward(self, s0, s1, alpha_w, beta_w):
        states = _run_mixed_steps(
            self.ops, [self.preprocess0(s0), self.preprocess1(s1)], alpha_w,
            beta_w, self.steps)
        return torch.cat(states[-self.multiplier:], dim=1)


def btw_weights(betas: torch.Tensor, n_input: int,
                steps: int) -> torch.Tensor:
    """Per-step softmax over the growing beta groups (n_input, n_input + 1,
    ... edges)."""
    out, start, n = [], 0, n_input
    for _ in range(steps):
        out.append(torch.softmax(betas[start:start + n], dim=-1))
        start += n
        n += 1
    return torch.cat(out)


class SearchNet(nn.Module):
    """The interaction-search supernet (module docstring)."""

    def __init__(self, num_classes: int = 20, num_joints: int = 16,
                 layers: int = 16, init_channels: int = 32,
                 refine_layers: int = 1, steps: int = 4, multiplier: int = 4,
                 encoder: gt.Genotype = gt.ENCODER,
                 decoder: gt.GenotypeUp2 = gt.DECODER,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        c = init_channels
        self.layers, self.refine_layers, self.dtype = (layers, refine_layers,
                                                       dtype)
        self.steps = steps
        cell_args, self._boundaries, shallow_first = encoder_plan(
            layers, c, encoder, multiplier)

        self.stem0 = _Stem(3, c, 2)
        self.stem1 = _Stem(c, 2 * c, 2)
        self.stem2 = _Stem(2 * c, 2 * c, 1, final_relu=False)
        self.stem3 = _Stem(3, c, 2)
        self.stem4 = _Stem(c, 2 * c, 2)
        self.stem5 = _Stem(2 * c, 2 * c, 1, final_relu=False)
        self.cells1 = nn.ModuleList(Cell(*a) for a in cell_args)
        self.cells2 = nn.ModuleList(Cell(*a) for a in cell_args)
        nc = shallow_first[::-1]  # [16C, 8C, 4C, 2C] at C = c / 2

        # Encoder-stage injections: group i has (1 + i) MixedOps, source j
        # shallow-first; the off-diagonal ones cross scales and widths.
        ops1, ops2 = [], []
        for i in range(4):
            for j in range(1 + i):
                up = 1 / 2 ** (i - j)
                extra = nc[3 - i] if i != j else None
                ops1.append(MixedOp(nc[3 - j], up, extra))
                ops2.append(MixedOp(nc[3 - j], up, extra))
        self.inj_ops1, self.inj_ops2 = nn.ModuleList(ops1), nn.ModuleList(ops2)

        self.upsamples1 = nn.ModuleList(
            UpsampleCell(decoder.upsample1, decoder.upsample_concat1, nc[j],
                         nc[j + 1]) for j in range(3))
        self.upsamples2 = nn.ModuleList(
            UpsampleCell(decoder.upsample2, decoder.upsample_concat2, nc[j],
                         nc[j + 1]) for j in range(3))

        # Decoder-stage injections over the 7-slot pyramid: stage i sums
        # (5 + i) MixedOps, one per slot so far.
        resolution = (1, 1 / 2, 1 / 4, 1 / 8, 1 / 4, 1 / 2, 1)
        channels7 = tuple(int(2 * c / r) for r in resolution)
        uops1, uops2 = [], []
        for i in range(3):
            for j in range(5 + i):
                up = resolution[4 + i] / resolution[j]
                extra = channels7[4 + i] if (4 + i) != j else None
                uops1.append(MixedOp(channels7[j], up, extra))
                uops2.append(MixedOp(channels7[j], up, extra))
        self.up_inj_ops1 = nn.ModuleList(uops1)
        self.up_inj_ops2 = nn.ModuleList(uops2)

        c_cat = 2 * nc[3] + nc[2] + nc[1]
        self.pose_layer = _Neck(c_cat, 4 * nc[3])
        self.pose_auxlayer = _Neck(c_cat, 3 * nc[3])
        self.par_layer = _Neck(c_cat, 4 * nc[3])
        self.edge_layer = _Neck(c_cat, 3 * nc[3])

        c_fuse = (3 * nc[3], 4 * nc[3], 4 * nc[3])
        self.pose_net = nn.ModuleList(
            SearchFusionCell(c_fuse, nc[3], steps, multiplier)
            for _ in range(3))
        self.par_net = nn.ModuleList(
            SearchFusionCell(c_fuse, nc[3], steps, multiplier)
            for _ in range(3))

        n_stages = refine_layers + 1
        self.pose_head = nn.ModuleList(
            _Head(4 * nc[3], 256, num_joints, 1, True)
            for _ in range(n_stages))
        self.pose_auxnet = nn.ModuleList(
            _Head(3 * nc[3], 128, num_joints, 3, True)
            for _ in range(n_stages))
        self.par_head = nn.ModuleList(
            _Head(4 * nc[3], 256, num_classes, 1, True)
            for _ in range(n_stages))
        self.edge_head = nn.ModuleList(
            _Head(3 * nc[3], 6, 2, 3, False) for _ in range(n_stages))

        n_ops = len(gt.PRIMITIVES_INTER)
        k = sum(3 + i for i in range(steps))  # 18
        shapes = {"alphas1": (10, n_ops), "alphas2": (10, n_ops),
                  "alphas3": (18, n_ops), "alphas4": (18, n_ops),
                  "alphas_pose": (k, n_ops), "alphas_par": (k, n_ops),
                  "betas1": (10,), "betas2": (10,), "betas3": (18,),
                  "betas4": (18,), "betas_pose": (k,), "betas_par": (k,)}
        for name in ARCH_PARAM_NAMES:
            self.register_parameter(name, nn.Parameter(
                torch.full(shapes[name], ARCH_INIT)))

    def arch_parameters(self) -> dict:
        """The 12 architecture parameters by name."""
        return {k: getattr(self, k) for k in ARCH_PARAM_NAMES}

    def weight_parameters(self) -> list:
        """Every parameter but the architecture ones."""
        return [p for n, p in self.named_parameters()
                if n not in ARCH_PARAM_NAMES]

    def forward(self, x):
        with torch.autocast(device_type=x.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            return self._forward(x)

    def _forward(self, x):
        s0 = self.stem1(self.stem0(x))
        s1 = self.stem2(s0)
        s2 = self.stem4(self.stem3(x))
        s3 = self.stem5(s2)

        # Row-wise softmax of a whole alpha matrix equals the softmax of
        # each group's rows.
        w1 = torch.softmax(self.alphas1, dim=-1)
        w2 = torch.softmax(self.alphas2, dim=-1)
        features1, features2 = [], []
        offset = 0
        for i in range(self.layers):
            s0, s1 = s1, self.cells1[i](s0, s1)
            s2, s3 = s3, self.cells2[i](s2, s3)
            if i not in self._boundaries:
                continue
            features1.append(s1)
            features2.append(s3)
            n = len(features1)
            b1 = torch.softmax(self.betas1[offset:offset + n], dim=-1)
            b2 = torch.softmax(self.betas2[offset:offset + n], dim=-1)
            z1 = weighted_sum(b1, [self.inj_ops1[offset + j](
                features2[j], w1[offset + j]) for j in range(n)])
            z2 = weighted_sum(b2, [self.inj_ops2[offset + j](
                features1[j], w2[offset + j]) for j in range(n)])
            s1 = s1 + z1
            s3 = s3 + z2
            features1[-1] = s1
            features2[-1] = s3
            offset += n

        w3 = torch.softmax(self.alphas3, dim=-1)
        w4 = torch.softmax(self.alphas4, dim=-1)
        out1, out2 = features1[3], features2[3]
        skip_idx = (2, 1, 0)
        cont = 0
        for stage in range(3):
            out1 = self.upsamples1[stage](out1, features1[skip_idx[stage]])
            out2 = self.upsamples2[stage](out2, features2[skip_idx[stage]])
            features1.append(out1)
            features2.append(out2)
            n = len(features1)
            b1 = torch.softmax(self.betas3[cont:cont + n], dim=-1)
            b2 = torch.softmax(self.betas4[cont:cont + n], dim=-1)
            z1 = weighted_sum(b1, [self.up_inj_ops1[cont + j](
                features2[j], w3[cont + j]) for j in range(n)])
            z2 = weighted_sum(b2, [self.up_inj_ops2[cont + j](
                features1[j], w4[cont + j]) for j in range(n)])
            out1 = out1 + z1
            out2 = out2 + z2
            features1[-1] = out1
            features2[-1] = out2
            cont += n

        x1 = torch.cat([
            features1[0], features1[6],
            resize_scale(features1[5], 2.0, align_corners=True),
            resize_scale(features1[4], 4.0, align_corners=True)], dim=1)
        x2 = torch.cat([
            features2[0], features2[6],
            resize_scale(features2[5], 2.0, align_corners=True),
            resize_scale(features2[4], 4.0, align_corners=True)], dim=1)

        input1 = self.pose_auxlayer(x1)
        input2 = self.edge_layer(x2)
        input3 = self.pose_layer(x1)
        input4 = self.par_layer(x2)

        pose_list = [(self.pose_head[0](input3), self.pose_auxnet[0](input1))]
        par_list = [(self.par_head[0](input4), self.edge_head[0](input2))]

        w_pose = torch.softmax(self.alphas_pose, dim=-1)
        b_pose = btw_weights(self.betas_pose, 3, self.steps)
        w_par = torch.softmax(self.alphas_par, dim=-1)
        b_par = btw_weights(self.betas_par, 3, self.steps)
        for i in range(1, self.refine_layers + 1):
            for j in range(3):
                k = 2 * (i - 1) + j
                input1, tmp = self.pose_net[k](input1, input3, input4,
                                               w_pose, b_pose)
                input2, input4 = self.par_net[k](input2, input3, input4,
                                                 w_par, b_par)
                input3 = tmp
            pose_list.append((self.pose_head[i](input3),
                              self.pose_auxnet[i](input1)))
            par_list.append((self.par_head[i](input4),
                             self.edge_head[i](input2)))
        return pose_list, par_list


def build_search_model(*, device, generator: torch.Generator,
                       train: bool = True, **kw) -> SearchNet:
    """The supernet on ``device`` (train mode by default), weights drawn on
    the CPU from ``generator`` as ``models/augment.build_nppnet`` draws
    them, architecture parameters at 1e-3; channels_last on a card."""
    with torch.device("meta"):
        model = SearchNet(**kw)
    model.to_empty(device="cpu")
    init_weights(model, generator)
    with torch.no_grad():
        for p in model.arch_parameters().values():
            p.fill_(ARCH_INIT)
    model = model.to(device).train(train)
    if torch.device(device).type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model
