"""Tensor (channel) parallelism: conv channels split over a grid's
``model`` axis.

Port of ``npp_tpu/parallel/tensor.py``. npp_tpu only places data: every
conv kernel whose output channels ``n_model`` divides is sharded on them,
every per-channel vector of that width (conv bias, BN scale and bias,
running mean and variance, their Adam moments) likewise, and XLA's SPMD
partitioner inserts the collectives. PyTorch has no partitioner, so the
port decides op by op where a channel-split activation becomes whole
again. On a ``data x space x model`` grid (``mesh.make_grid``) rank (d,
s, m) holds block m of ``n_model`` contiguous blocks of each sharded
leaf, and ``convert_tensor_parallel(model, grid)`` makes NPPNet compute
only its own output channels of each sharded conv.

The shard rule (``tp_shards``) is ``tp_spec``'s leaf for leaf: a conv
weight is sharded on its output-channel dim (torch OIHW dim 0) where
``n_model`` divides it, the depthwise weights of ``DilConvS.Conv_0``
included; a 1-D per-channel leaf of that width likewise; everything else
is whole on every rank of the model group. Two departures: the loss
lambdas stay whole (``tp_spec`` would shard their (2,) at ``n_model`` 2,
but they are not model leaves and the loss reads them whole), and so
does BN's ``num_batches_tracked``.

Two autograd functions over the model group do the work (Megatron's
pair):

- ``gather_channels``: forward, all channel blocks in rank order;
  backward, this rank's block of the gradient (every consumer after it
  holds the whole gradient);
- ``copy_to_model``: forward, the identity; backward, the sum of the
  ranks' gradients (each rank's output-sharded conv gave only its share).

``copy_to_model`` comes in front of each output-sharded conv that reads a
whole input, and ``gather_channels`` wherever a channel-split tensor
meets an op that reads every channel; together they are a reduce-scatter
in the backward. A gather in front of a replicated consumer keeps its own
block: every rank then computes the same whole gradient, and a
reduce-scatter would multiply it by ``n_model``.

A module knows whether its input is split by comparing ``x.shape[1]``
with its own global width (``in_channels``, ``num_features``, a cell's
node width), never by guessing: ``ChannelSharding.whole`` and ``block``
raise on any other width. The places that need it:

- every conv (``spatial.ShardedConv2d``): an output-sharded dense conv
  takes ``copy_to_model(whole(x))``; a replicated dense conv takes
  ``whole(x)`` (the heads' last conv where ``n_model`` does not divide
  the classes, joints or the edge head's 2); a sharded depthwise conv
  (``DilConvS.Conv_0``, ``primitives.py``) takes this rank's block, so
  ``DilConvS.Conv_1`` (1x1, dense) gathers again, and ``SepConv`` stacks
  two of these;
- every BN (``sync_bn.SyncBatchNorm``): its block, or the whole input if
  replicated; sharded and replicated BNs alike take their moments over
  the grid's replica group, and a row-replicated level under sp keeps
  its count-once rule;
- ``SEBlock``: its ``Conv_0`` reads the whole squeezed (B, C, 1, 1)
  mean (under sp the space group's ``mean_hw``), and ``x * w`` is per
  channel, so ``x`` is brought to ``w``'s layout;
- ``FactorizedReduce``: its two convs of ``c_out // 2`` are sharded, but
  the BN over ``c_out`` takes contiguous blocks of ``c_out``: the local
  concatenation of the two conv blocks is not this rank's BN block, so
  each conv output is gathered and the BN takes its block (its
  ``_branches`` under sp likewise);
- the concatenations of ``cells.Cell``, ``UpsampleCell``, ``FusionCell``
  (``fea1``, ``fea2``) and NPPNet's multi-scale ``x1`` / ``x2``: a
  concatenation of blocks is a permutation of the whole, so each piece
  is gathered first (every consumer is a dense conv or a head);
- the DARTS sums ``hs[0] + hs[1]`` (``cells._run_steps``) and the
  injections ``s1 + z1``: both operands in one layout (``aligned``);
  ``InterOp`` returns its output whole; ``Identity`` and ``Zero`` pass
  their input's layout through;
- ``_Head``: its output is gathered whole, for the criterion.

Every collective is an all-reduce of a zeroed buffer with a slot per rank
(``mesh.all_slots``): gloo has no all-gather or reduce-scatter of CUDA
tensors, and adding zeros is exact; bf16 and fp16 travel as float32.

The leaves the model axis keeps whole (the replicated convs and BNs, the
lambdas) are computed from the same whole tensors on every model rank,
but a card's kernels are not bit-stable; ``share_replicated`` gives every
model rank rank m = 0's gradients of them and running stats, one
broadcast a train step, so the copies cannot drift apart over a run.
A converted model's state_dict keeps every key with this rank's blocks;
``whole_state_dict`` gathers them over the model group (a collective:
every rank calls it) and ``load_whole_state_dict`` takes a whole one and
keeps the blocks, so a checkpoint holds whole tensors and restores in one
process and in a TP run alike.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn as nn

from npp_tpu_torch.parallel.mesh import (all_concat, all_slots, multi_rank,
                                         wire)
from npp_tpu_torch.parallel.sync_bn import SyncBatchNorm, convert_sync_bn

_DEPTHWISE = "depthwise"


def _memory_format(x: torch.Tensor):
    return (torch.channels_last if x.dim() == 4 and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last)
            else torch.contiguous_format)


class _GatherChannels(torch.autograd.Function):
    """Every model rank's channel block (dim 1), in rank order; the
    backward keeps this rank's block of the gradient."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, ctx.c = tp, x.shape[1]
        tp.counts["gather"] += 1
        out = all_slots(x, tp.model_group).movedim(0, 1).flatten(1, 2)
        return out.to(x.dtype).contiguous(memory_format=_memory_format(x))

    @staticmethod
    def backward(ctx, g):
        return g.narrow(1, ctx.tp.m * ctx.c, ctx.c), None


class _CopyToModel(torch.autograd.Function):
    """The identity; the backward sums the model ranks' gradients."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        tp.counts["copy"] += 1
        t = wire(g).clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, group=tp.model_group)
        return t.to(g.dtype).contiguous(memory_format=_memory_format(g)), \
            None


def gather_channels(x: torch.Tensor, tp) -> torch.Tensor:
    return _GatherChannels.apply(x, tp)


def copy_to_model(x: torch.Tensor, tp) -> torch.Tensor:
    return _CopyToModel.apply(x, tp)


def _sharded(width: int, n_model: int) -> bool:
    return width % n_model == 0


def tp_shards(module: nn.Module, n_model: int) -> dict[str, int]:
    """The shard rule: state_dict key -> global length of its dim 0, for
    every leaf of ``module`` that a rank holds a block of at ``n_model``
    (module docstring). It reads widths only, so it gives the same keys
    before and after the conversion."""
    out = {}
    for name, m in module.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(m, nn.Conv2d) and _sharded(m.out_channels, n_model):
            keys, width = ["weight"], m.out_channels
            if m.bias is not None:
                keys.append("bias")
        elif isinstance(m, nn.BatchNorm2d) and _sharded(m.num_features,
                                                        n_model):
            keys = (["weight", "bias"] if m.affine else []) + [
                "running_mean", "running_var"]
            width = m.num_features
        else:
            continue
        out.update({pre + k: width for k in keys})
    return out


class ChannelSharding:
    """The model axis as a converted model's modules see it: the grid,
    ``n`` = n_model, this rank's ``m``, the model group, the shard rule's
    keys (``sharded``) and the count of gathers (forward) and copies'
    all-reduces (backward) since ``counts`` was last zeroed. Modules reach
    it through their ``tp`` attribute."""

    def __init__(self, grid, sharded: dict[str, int]):
        self.grid = grid
        self.n, self.m = grid.n_model, grid.m
        self.model_group = grid.model_group
        self.sharded = sharded
        self.counts = {"gather": 0, "copy": 0}

    def whole(self, x: torch.Tensor, width: int) -> torch.Tensor:
        """``x`` whole on dim 1: gathered if it holds this rank's block of
        ``width`` channels, as it is if it holds all ``width``."""
        c = x.shape[1]
        if c == width:
            return x
        if c * self.n == width:
            return gather_channels(x, self)
        raise RuntimeError(f"a {c}-channel input where the module reads "
                           f"{width} channels or a block of them")

    def block(self, x: torch.Tensor, width: int) -> torch.Tensor:
        """This rank's block of ``x`` on dim 1: ``x`` itself if it is the
        block, else the block of the whole ``x`` after ``copy_to_model``
        (every rank's block gets its gradient back)."""
        if width % self.n:
            raise RuntimeError(f"{width} channels do not split into "
                               f"{self.n} blocks")
        c, b = x.shape[1], width // self.n
        if c == b:
            return x
        if c == width:
            return copy_to_model(x, self).narrow(1, self.m * b, b)
        raise RuntimeError(f"a {c}-channel input where the module reads "
                           f"a block of {width} channels")

    def aligned(self, a: torch.Tensor, b: torch.Tensor, width: int):
        """(a, b) in one layout for an elementwise op on ``width``
        channels: as they are if their widths agree, else both as this
        rank's block."""
        if a.shape[1] == b.shape[1]:
            return a, b
        return self.block(a, width), self.block(b, width)

    def conv_input(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        """What ``conv`` reads of ``x``: its block for a sharded depthwise
        conv, else the whole input, through ``copy_to_model`` if the conv
        computes only its own output channels."""
        width = conv.in_channels
        if conv.tp_kind == _DEPTHWISE:
            return self.block(x, width)
        x = self.whole(x, width)
        return copy_to_model(x, self) if conv.tp_kind else x

    def bn_input(self, bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
        if _sharded(bn.num_features, self.n):
            return self.block(x, bn.num_features)
        return self.whole(x, bn.num_features)

    def own(self, t: torch.Tensor, width: int) -> torch.Tensor:
        """This rank's block of a whole leaf ``t`` (dim 0)."""
        b = width // self.n
        return t.narrow(0, self.m * b, b)


def sharding_of(model) -> ChannelSharding | None:
    """The ``ChannelSharding`` ``model`` was converted with, or None."""
    return getattr(model, "_tp", None)


def _slice_param(module: nn.Module, name: str, tp: ChannelSharding,
                 width: int) -> None:
    t = getattr(module, name)
    if t is None:
        return
    piece = tp.own(t.detach(), width).clone()
    if isinstance(t, nn.Parameter):
        setattr(module, name, nn.Parameter(piece,
                                           requires_grad=t.requires_grad))
    else:
        setattr(module, name, piece)  # a buffer


def convert_tensor_parallel(model: nn.Module, grid) -> nn.Module:
    """Make ``model`` (NPPNet, or one of its ops) compute only this rank's
    channel blocks, in place: every conv becomes a ``ShardedConv2d`` and
    every BN a ``SyncBatchNorm`` over the grid's replica group (one of a
    single rank normalises alone), each sharded leaf is sliced to block
    ``grid.m`` (state_dict keys unchanged), and every module that reads
    channels gets the ``ChannelSharding`` (its ``tp``). It composes with
    ``spatial.convert_spatial`` in either order. With ``grid.n_model`` 1
    the model is returned as it is. A module the conversion does not
    know raises (the supernet: no npp_tpu path runs it under ``model``).
    Convert before building the optimizer: the sliced leaves are new
    parameters."""
    if grid is None or grid.n_model == 1:
        return model
    tp = sharding_of(model)
    if tp is not None:
        if tp.grid is not grid:
            raise ValueError("the model is converted for another grid")
        return model
    from npp_tpu_torch.ops.quantize import is_int8
    from npp_tpu_torch.parallel.spatial import (ShardedConv2d, _known_modules,
                                                sharded_conv)
    # npp_tpu has no serving path over a model axis.
    if is_int8(model):
        raise ValueError("convert_tensor_parallel: the int8 serving layout "
                         "does not split over a model axis; split the fp "
                         "model, not a prepared one")
    if getattr(model, "fused_cells", False) or getattr(model, "fused_necks",
                                                       False):
        raise ValueError("convert_tensor_parallel: the fused serving layout "
                         "does not split over a model axis; serve the "
                         "standard layout")
    known = _known_modules()
    for mod in model.modules():
        if not isinstance(mod, known):
            raise TypeError(f"convert_tensor_parallel does not know "
                            f"{type(mod).__name__}")
    tp = ChannelSharding(grid, tp_shards(model, grid.n_model))
    convert_sync_bn(model, multi_rank(grid.replica_group))

    def convert(module):
        for name, child in module.named_children():
            if type(child) is nn.Conv2d:
                setattr(module, name, sharded_conv(child))
            else:
                convert(child)

    convert(model)
    n = grid.n_model
    for mod in model.modules():
        if isinstance(mod, ShardedConv2d):
            mod.tp_kind = None
            if _sharded(mod.out_channels, n):
                depthwise = (mod.groups > 1 and mod.groups == mod.in_channels
                             == mod.out_channels)
                mod.tp_kind = _DEPTHWISE if depthwise else "dense"
                _slice_param(mod, "weight", tp, mod.out_channels)
                _slice_param(mod, "bias", tp, mod.out_channels)
                if depthwise:
                    mod.groups = mod.out_channels // n
        elif isinstance(mod, SyncBatchNorm) and _sharded(mod.num_features,
                                                         n):
            for name in ("weight", "bias", "running_mean", "running_var"):
                _slice_param(mod, name, tp, mod.num_features)
        if hasattr(type(mod), "tp"):
            mod.tp = tp
    model._tp = tp
    return model


def share_replicated(model: nn.Module, extra=()) -> None:
    """Give every rank of the model group the values of its rank m = 0, by
    one broadcast, for the leaves the model axis keeps whole: the
    gradients of the whole parameters (and of ``extra``, the loss
    lambdas) and the running stats of the whole BNs. Each model rank
    computes them from the same whole tensors, but a card's kernels are
    not bit-stable, so each rank's copy could drift from the others' over
    a run. The train step calls it after the backward, before the
    update; without a model axis it does nothing."""
    tp = sharding_of(model)
    if tp is None:
        return
    ts = [p.grad for k, p in model.named_parameters()
          if k not in tp.sharded and p.grad is not None]
    ts += [p.grad for p in extra if p.grad is not None]
    ts += [b for k, b in model.named_buffers()
           if k not in tp.sharded and b.is_floating_point()]
    if not ts:
        return
    flat = torch.cat([wire(t).reshape(-1) for t in ts])
    dist.broadcast(flat, src=dist.get_global_rank(tp.model_group, 0),
                   group=tp.model_group)
    for t, piece in zip(ts, flat.split([t.numel() for t in ts])):
        t.copy_(piece.view_as(t))


# -- whole tensors for checkpoints -------------------------------------------


def whole_state_dict(model: nn.Module) -> dict:
    """``model.state_dict()`` with every sharded leaf gathered over the
    model group (a collective: every rank of the group calls it); the
    model's own state_dict if it is not converted."""
    sd = model.state_dict()
    tp = sharding_of(model)
    if tp is None:
        return sd
    return {k: (all_concat(v, tp.model_group) if k in tp.sharded else v)
            for k, v in sd.items()}


def load_whole_state_dict(model: nn.Module, sd: dict) -> None:
    """Load a whole state_dict (of the unconverted model) into ``model``,
    keeping this rank's block of every sharded leaf."""
    tp = sharding_of(model)
    if tp is not None:
        sd = {k: (tp.own(v, tp.sharded[k]) if k in tp.sharded else v)
              for k, v in sd.items()}
    model.load_state_dict(sd)


def _moment_widths(optimizer, model, tp) -> dict[int, int]:
    """Optimizer state index -> the global width of its parameter, for
    the sharded parameters (the index of ``state_dict()['state']``)."""
    name_of = {id(p): k for k, p in model.named_parameters()}
    params = [p for g in optimizer.param_groups for p in g["params"]]
    return {i: tp.sharded[name_of[id(p)]] for i, p in enumerate(params)
            if name_of.get(id(p)) in tp.sharded}


def gather_optimizer_state(state: dict, optimizer, model) -> dict:
    """An optimizer state_dict with the moments of every sharded parameter
    gathered over the model group (a collective of the group), on the CPU
    as the optimizer's own ``state_dict`` gives them."""
    tp = sharding_of(model)
    device = next(model.parameters()).device
    state = dict(state, state=dict(state["state"]))
    for i, width in _moment_widths(optimizer, model, tp).items():
        entry = dict(state["state"][i])
        for k, v in entry.items():
            if torch.is_tensor(v) and v.dim() > 0:
                entry[k] = all_concat(v.to(device), tp.model_group).to(
                    v.device)
        state["state"][i] = entry
    return state


def shard_optimizer_state(state: dict, optimizer, model) -> dict:
    """A whole optimizer state_dict with this rank's blocks of the
    moments of every sharded parameter, to load into ``optimizer``."""
    tp = sharding_of(model)
    if tp is None:
        return state
    state = dict(state, state=dict(state["state"]))
    for i, width in _moment_widths(optimizer, model, tp).items():
        if i in state["state"]:
            state["state"][i] = {
                k: (tp.own(v, width) if torch.is_tensor(v) and v.dim() > 0
                    else v) for k, v in state["state"][i].items()}
    return state
