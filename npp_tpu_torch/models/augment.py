"""NPPNet, the fixed dual-task network compiled from the released genotypes.

Port of ``npp_tpu/models/augment.py:39-390`` in its standard layout: two
encoder streams (pose / parsing) of DARTS cells with cross-task
injections at four scales, decoder upsample cells with decoder-stage
injections, four projection necks, the chain of refinement cells and the
per-stage heads. The ``merged_streams``, ``fused_necks`` and
``fused_cells`` layouts are not ported.

Tensors are NCHW. ``forward`` returns ``(pose_list, par_list)`` with
``pose_list[s] = (pose_map, pose_aux)`` and ``par_list[s] = (par_map,
edge)`` for each refinement stage ``s``, at 1/4 of the input resolution.
``dtype`` is the compute dtype, as the flax module's: ``torch.bfloat16``
runs the forward under autocast, except the last conv of every head,
which stays in float32 (``npp_tpu/models/augment.py:87-89``).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from npp_tpu_torch import genotypes as gt
from npp_tpu_torch.models.cells import (Cell, FusionCell, UpsampleCell,
                                        compile_decoder_injections,
                                        compile_encoder_injections)
from npp_tpu_torch.ops.primitives import batch_norm, conv
from npp_tpu_torch.ops.resize import resize_scale


class _Stem(nn.Module):
    """conv - BN - relu stem stage."""

    def __init__(self, c_in: int, features: int, stride: int,
                 final_relu: bool = True):
        super().__init__()
        self.final_relu = final_relu
        self.Conv_0 = conv(c_in, features, 3, stride, 1, bias=False)
        self.BatchNorm_0 = batch_norm(features)

    def forward(self, x):
        x = self.BatchNorm_0(self.Conv_0(x))
        return F.relu(x) if self.final_relu else x


class _Neck(nn.Module):
    """ReLU - 1x1 conv - BN projection neck."""

    def __init__(self, c_in: int, features: int):
        super().__init__()
        self.Conv_0 = conv(c_in, features, 1, bias=True)
        self.BatchNorm_0 = batch_norm(features)

    def forward(self, x):
        return self.BatchNorm_0(self.Conv_0(F.relu(x)))


class _Head(nn.Module):
    """ReLU - conv - BN - ReLU - conv output head; the last conv runs in
    its weights' dtype (float32 under bf16 compute) with autocast off."""

    def __init__(self, c_in: int, mid_features: int, out_features: int,
                 mid_kernel: int = 1, mid_bias: bool = True):
        super().__init__()
        k = mid_kernel
        self.Conv_0 = conv(c_in, mid_features, k, 1, k // 2, bias=mid_bias)
        self.BatchNorm_0 = batch_norm(mid_features)
        self.Conv_1 = conv(mid_features, out_features, 1, bias=True)

    def forward(self, x):
        x = F.relu(self.BatchNorm_0(self.Conv_0(F.relu(x))))
        with torch.autocast(device_type=x.device.type, enabled=False):
            return self.Conv_1(x.to(self.Conv_1.weight.dtype))


def encoder_plan(layers: int, init_channels: int, encoder: gt.Genotype,
                 multiplier: int = 4):
    """The encoder's channel schedule, with the L=4 fix: the width recorded
    at a boundary is the one after that cell's reduction doubling
    (npp_tpu/models/augment.py:139-148). Returns (the ``Cell`` arguments
    of each layer, the sorted boundary layers, the widths of the four
    boundary features shallow first)."""
    L, c = layers, init_channels
    boundaries = {L // 4 - 1, 2 * L // 4 - 1, 3 * L // 4 - 1, L - 1}
    reductions = {L // 4, 2 * L // 4, 3 * L // 4}
    c_curr, c_pp, c_p = c // 2, 2 * c, 2 * c
    cell_args, num_inchannels = [], []
    reduction_prev = False
    for i in range(L):
        reduction = i in reductions
        if reduction:
            c_curr *= 2
        cell_args.append((
            encoder.reduce if reduction else encoder.normal,
            encoder.reduce_concat if reduction else encoder.normal_concat,
            c_pp, c_p, c_curr, reduction, reduction_prev))
        reduction_prev = reduction
        c_pp, c_p = c_p, multiplier * c_curr
        if i in boundaries:
            num_inchannels.append(c_curr * multiplier)
    return cell_args, tuple(sorted(boundaries)), tuple(num_inchannels)


class NPPNet(nn.Module):
    """Fixed dual-task network compiled from the released genotypes."""

    def __init__(self, num_classes: int = 20, num_joints: int = 16,
                 layers: int = 16, init_channels: int = 64,
                 refine_layers: int = 1, encoder: gt.Genotype = gt.ENCODER,
                 decoder: gt.GenotypeUp2 = gt.DECODER,
                 inter: gt.GenotypeInter = gt.INTER,
                 fusion: gt.GenotypeFuse = gt.FUSION, multiplier: int = 4,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        c = init_channels
        self.layers, self.refine_layers, self.dtype = (layers, refine_layers,
                                                       dtype)
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
        # Deep-to-shallow widths [16C, 8C, 4C, 2C].
        nc = shallow_first[::-1]

        ops1, self.inj_idx1 = compile_encoder_injections(inter.task1,
                                                         shallow_first)
        ops2, self.inj_idx2 = compile_encoder_injections(inter.task2,
                                                         shallow_first)
        self.inj_ops1, self.inj_ops2 = nn.ModuleList(ops1), nn.ModuleList(ops2)

        # Decoder-stage injections over the 7-slot pyramid.
        resolution = (1, 1 / 2, 1 / 4, 1 / 8, 1 / 4, 1 / 2, 1)
        channels7 = tuple(int(2 * c / r) for r in resolution)
        uops1, self.up_inj_idx1 = compile_decoder_injections(
            inter.task3, resolution, channels7)
        uops2, self.up_inj_idx2 = compile_decoder_injections(
            inter.task4, resolution, channels7)
        self.up_inj_ops1 = nn.ModuleList(uops1)
        self.up_inj_ops2 = nn.ModuleList(uops2)

        # Decoder stage j reads the coarser feature (nc[j] wide) and the
        # skip feature (nc[j+1] wide).
        self.upsamples1 = nn.ModuleList(
            UpsampleCell(decoder.upsample1, decoder.upsample_concat1, nc[j],
                         nc[j + 1]) for j in range(len(nc) - 1))
        self.upsamples2 = nn.ModuleList(
            UpsampleCell(decoder.upsample2, decoder.upsample_concat2, nc[j],
                         nc[j + 1]) for j in range(len(nc) - 1))

        # Necks read the 1/4-res concat [f0, f6, up2(f5), up4(f4)].
        c_cat = 2 * nc[3] + nc[2] + nc[1]
        self.pose_layer = _Neck(c_cat, 4 * nc[3])
        self.pose_auxlayer = _Neck(c_cat, 3 * nc[3])
        self.par_layer = _Neck(c_cat, 4 * nc[3])
        self.edge_layer = _Neck(c_cat, 3 * nc[3])

        # Refinement cells: the count the stage indexing needs
        # (npp_tpu/models/augment.py:232-236). Inputs are (3c, 4c, 4c).
        n_cells = 2 * max(refine_layers - 1, 0) + 3
        c_fuse = (3 * nc[3], 4 * nc[3], 4 * nc[3])
        self.pose_net = nn.ModuleList(
            FusionCell(fusion.pose, fusion.pose_concat, c_fuse, nc[3])
            for _ in range(n_cells))
        self.par_net = nn.ModuleList(
            FusionCell(fusion.par, fusion.par_concat, c_fuse, nc[3])
            for _ in range(n_cells))

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

    @staticmethod
    def _inject(ops, idx_groups, group, sources):
        """Discrete injection: the sum over the group's compiled edges."""
        start = sum(len(g) for g in idx_groups[:group])
        z = 0.0
        for j, src_idx in enumerate(idx_groups[group]):
            z = z + ops[start + j](sources[src_idx])
        return z

    def _encode(self, x):
        """Stems, encoder cells and cross-injections; returns the 4-scale
        feature pyramids of both streams."""
        features1, features2 = [], []
        s0 = self.stem1(self.stem0(x))
        s1 = self.stem2(s0)
        s2 = self.stem4(self.stem3(x))
        s3 = self.stem5(s2)
        group = 0
        for i in range(self.layers):
            s0, s1 = s1, self.cells1[i](s0, s1)
            s2, s3 = s3, self.cells2[i](s2, s3)
            if i in self._boundaries:
                features1.append(s1)
                features2.append(s3)
                z1 = self._inject(self.inj_ops1, self.inj_idx1, group,
                                  features2)
                z2 = self._inject(self.inj_ops2, self.inj_idx2, group,
                                  features1)
                s1 = s1 + z1
                s3 = s3 + z2
                features1[-1] = s1
                features2[-1] = s3
                group += 1
        return features1, features2

    def forward(self, x):
        with torch.autocast(device_type=x.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            return self._forward(x)

    def _forward(self, x):
        features1, features2 = self._encode(x)

        out1, out2 = features1[3], features2[3]
        skip_idx = (2, 1, 0)
        for stage in range(3):
            out1 = self.upsamples1[stage](out1, features1[skip_idx[stage]])
            out2 = self.upsamples2[stage](out2, features2[skip_idx[stage]])
            features1.append(out1)
            features2.append(out2)
            z1 = self._inject(self.up_inj_ops1, self.up_inj_idx1, stage,
                              features2)
            z2 = self._inject(self.up_inj_ops2, self.up_inj_idx2, stage,
                              features1)
            out1 = out1 + z1
            out2 = out2 + z2
            features1[-1] = out1
            features2[-1] = out2

        # Multi-scale concat at 1/4 resolution.
        x1 = torch.cat([
            features1[0], features1[6],
            resize_scale(features1[5], 2.0, align_corners=True),
            resize_scale(features1[4], 4.0, align_corners=True),
        ], dim=1)
        x2 = torch.cat([
            features2[0], features2[6],
            resize_scale(features2[5], 2.0, align_corners=True),
            resize_scale(features2[4], 4.0, align_corners=True),
        ], dim=1)

        input1 = self.pose_auxlayer(x1)
        input2 = self.edge_layer(x2)
        input3 = self.pose_layer(x1)
        input4 = self.par_layer(x2)

        pose_list = [(self.pose_head[0](input3), self.pose_auxnet[0](input1))]
        par_list = [(self.par_head[0](input4), self.edge_head[0](input2))]
        for i in range(1, self.refine_layers + 1):
            for j in range(3):
                k = 2 * (i - 1) + j
                input1, tmp = self.pose_net[k](input1, input3, input4)
                input2, input4 = self.par_net[k](input2, input3, input4)
                input3 = tmp
            pose_list.append((self.pose_head[i](input3),
                              self.pose_auxnet[i](input1)))
            par_list.append((self.par_head[i](input4),
                             self.edge_head[i](input2)))
        return pose_list, par_list


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every parameter and buffer from ``generator`` alone: conv
    kernels xavier-normal and conv biases zero, as the flax init; BN
    weight 1, bias 0, running mean 0, running var 1."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.xavier_normal_(m.weight, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return model


def build_nppnet(*, device, generator: torch.Generator, train: bool = False,
                 **kw) -> NPPNet:
    """NPPNet on ``device``, in eval mode or, with ``train=True``, in train
    mode (BN normalises with the biased batch variance and updates its
    running stats with the unbiased one, momentum 0.1, as the JAX BN; the
    network has no dropout, so train mode is deterministic). Weights are
    drawn on the CPU from the CPU ``generator`` (so a seed gives the same
    weights on every device). The modules are built on the meta device
    first, so construction draws nothing from the global RNG."""
    with torch.device("meta"):
        model = NPPNet(**kw)
    model.to_empty(device="cpu")
    init_weights(model, generator)
    return model.to(device).train(train)
