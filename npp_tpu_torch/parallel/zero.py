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

Not ported: the hybrid ZeRO x tensor-parallel layout
(``zero.py:101-139``), which comes with tensor parallelism.
"""
from __future__ import annotations

import torch
from torch.distributed.optim import ZeroRedundancyOptimizer

from npp_tpu_torch.parallel import mesh


def adam(param_groups: list, *, zero: bool = False,
         **kw) -> torch.optim.Optimizer:
    """Adam over ``param_groups``; with ``zero`` its state sharded over
    the ranks of the process group (ZeRO-1), which must be up."""
    if not zero:
        return torch.optim.Adam(param_groups, **kw)
    if mesh.data_group() is None:
        raise RuntimeError("ZeRO shards the optimizer over the ranks of a "
                           "process group; launch with python -m "
                           "torch.distributed.run")
    return ZeroRedundancyOptimizer(param_groups,
                                   optimizer_class=torch.optim.Adam, **kw)


def optimizer_state_dict(optimizer: torch.optim.Optimizer):
    """The optimizer's whole state_dict: under ZeRO it is consolidated on
    rank 0 (a collective: every rank calls) and None elsewhere."""
    if isinstance(optimizer, ZeroRedundancyOptimizer):
        optimizer.consolidate_state_dict(to=0)
        return optimizer.state_dict() if mesh.is_primary() else None
    return optimizer.state_dict()
