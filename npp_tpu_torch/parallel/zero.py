"""ZeRO-1: each rank keeps the Adam moments of its share of the
parameters.

Port of ``npp_tpu/parallel/zero.py:41-98, 142-169`` (``--zero`` on the
train and search CLIs) with ``torch.distributed.optim.
ZeroRedundancyOptimizer`` over Adam: the parameters are partitioned over
the ranks group by group (the train optimizer's ``weights``,
``backbone`` and ``criterion`` groups, the search's weight and arch
optimizers keep their groups, learning rates and schedules), each rank
runs Adam on its partition with DDP's averaged gradients, and the
updated parameters are broadcast from their owners. Adam is elementwise,
so a ZeRO step equals the replicated one. npp_tpu's note that its
parameters may drift by ~2 lr is a fact of XLA's reduce-scatter order and
does not apply here. A checkpoint holds the consolidated optimizer state,
which loads into a plain Adam and back.

The hybrid ZeRO x tensor-parallel layout (``zero.py:101-139``, ``adam(
..., zero=True, grid=)`` on a grid with a model axis): ZeRO-1 runs over
this rank's ``data_group``, the ranks of the same space and model index,
so it covers this rank's channel blocks and the leaves the model axis
keeps whole. npp_tpu's ``hybrid_zero_spec`` keeps each conv moment's
output channels on ``model`` beside its parameter and shards its
input-channel dim over ``data``; the port partitions by parameter, as its
ZeRO-1 does: each data rank keeps whole moments of a share of the
parameters (of its blocks). Adam is elementwise, so the update is the
same; only which rank holds which moment elements differs.
``optimizer_state_dict`` consolidates over the data group, then gathers
the blocks over the model group, so the state loads into a plain
one-process Adam.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.optim import ZeroRedundancyOptimizer

from npp_tpu_torch.parallel import mesh, tensor


def adam(param_groups: list, *, zero: bool = False, grid=None,
         **kw) -> torch.optim.Optimizer:
    """Adam over ``param_groups``; with ``zero`` its state sharded over
    the ranks of the process group (ZeRO-1), which must be up, or on a
    ``grid`` with a model axis over its data group (the hybrid layout)."""
    if not zero:
        return torch.optim.Adam(param_groups, **kw)
    if mesh.data_group() is None:
        raise RuntimeError("ZeRO shards the optimizer over the ranks of a "
                           "process group; launch with python -m "
                           "torch.distributed.run")
    if grid is not None and grid.n_model > 1:
        kw["process_group"] = grid.data_group
    return ZeroRedundancyOptimizer(param_groups,
                                   optimizer_class=torch.optim.Adam, **kw)


def optimizer_state_dict(optimizer: torch.optim.Optimizer, model=None):
    """The optimizer's whole state_dict: under ZeRO it is consolidated on
    rank 0 (a collective: every rank calls) and None elsewhere. For a
    ``model`` converted by ``tensor.convert_tensor_parallel`` the moments
    of its sharded parameters are gathered over the model group too."""
    tp = tensor.sharding_of(model)
    if isinstance(optimizer, ZeroRedundancyOptimizer):
        optimizer.consolidate_state_dict(to=0)
        if tp is None:
            return optimizer.state_dict() if mesh.is_primary() else None
        if dist.get_rank(optimizer.process_group) != 0:
            return None
        state = tensor.gather_optimizer_state(optimizer.state_dict(),
                                              optimizer, model)
        return state if mesh.is_primary() else None
    if tp is None:
        return optimizer.state_dict()
    return tensor.gather_optimizer_state(optimizer.state_dict(), optimizer,
                                         model)


def load_optimizer_state_dict(optimizer: torch.optim.Optimizer, state: dict,
                              model=None) -> None:
    """Load a whole optimizer state_dict (``optimizer_state_dict``'s) into
    ``optimizer``, keeping this rank's blocks of the moments of ``model``'s
    sharded parameters."""
    optimizer.load_state_dict(tensor.shard_optimizer_state(state, optimizer,
                                                           model))
