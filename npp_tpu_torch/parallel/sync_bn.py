"""Cross-rank BatchNorm: the moments of the whole batch over every rank.

The counterpart of npp_tpu's BN under the sharded jit, whose moment
reductions span the ``data`` mesh (``npp_tpu/ops/primitives.py:23-80``,
PARITY.md:101). The moments are npp_tpu's one-pass E[x^2] - E[x]^2 in
float32 (floored at 0); the output is x * s + (b - mean * s) with
s = w / sqrt(var + eps), cast back to the input's dtype; ``running_var``
takes the unbiased global variance, momentum 0.1, eps 1e-5. The forward
all-reduces one float32 vector [sum x, sum x^2, count] per BN, the
backward one of [sum dy, sum dy * xhat]; the weight and bias gradients
are the rank's own sums, which DDP then averages. In eval mode it is
``nn.BatchNorm2d``.

Not ``nn.SyncBatchNorm``: it refuses CPU tensors under a group of more
than one rank, so no CPU test could run it, and it all-gathers its
statistics, which gloo cannot do for CUDA tensors (the shared-card ranks
of ``chip_smoke.py``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn as nn

_DIMS = (0, 2, 3)


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


class _SyncBatchNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps,
                momentum, group, replicas):
        c = x.shape[1]
        xf = x.float()
        stats = torch.cat([xf.sum(_DIMS), (xf * xf).sum(_DIMS),
                           xf.new_full((1,), x.numel() // c)])
        dist.all_reduce(stats, group=group)
        count = stats[2 * c]
        mean = stats[:c] / count
        var = torch.clamp(stats[c:2 * c] / count - mean * mean, min=0.0)
        invstd = torch.rsqrt(var + eps)
        with torch.no_grad():
            n = count / replicas  # each value once
            running_mean.copy_((1.0 - momentum) * running_mean
                               + momentum * mean)
            running_var.copy_((1.0 - momentum) * running_var
                              + momentum * (var * (n / (n - 1))))
        scale = invstd if weight is None else invstd * weight
        shift = -mean * scale if bias is None else bias - mean * scale
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.count, ctx.group = count, group
        return (xf * _per_channel(scale) + _per_channel(shift)).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd = ctx.saved_tensors
        c = x.shape[1]
        dyf = dy.float()
        xhat = (x.float() - _per_channel(mean)) * _per_channel(invstd)
        local = torch.cat([dyf.sum(_DIMS), (dyf * xhat).sum(_DIMS)])
        total = local.clone()
        dist.all_reduce(total, group=ctx.group)
        mean_dy = total[:c] / ctx.count
        mean_dy_xhat = total[c:] / ctx.count
        scale = invstd if weight is None else invstd * weight
        dx = ((dyf - _per_channel(mean_dy) - xhat * _per_channel(mean_dy_xhat))
              * _per_channel(scale)).to(x.dtype)
        dw = local[c:] if weight is not None and ctx.needs_input_grad[1] \
            else None
        db = local[:c] if ctx.needs_input_grad[2] else None
        return dx, dw, db, None, None, None, None, None, None


class SyncBatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode moments span ``group``; its
    state_dict keys are BatchNorm2d's.

    Under spatial partitioning (``space``, ``parallel/spatial.py``) each
    rank of a space group holds its rows of the level, so the same sums
    give the moments of the whole images; the count is each rank's
    B * h_local * W, summed. A level held whole on every rank of a space
    group of n ranks (``replicas`` n) enters the sums n times: the mean
    and variance are the same, the running variance's unbiased factor
    takes the count of distinct values, and the backward's sums of the
    ranks' partial gradients over n times the count give each rank 1 / n
    of the mean terms, which add up to the whole level's over the ranks.


    Under tensor parallelism (``tp``, ``parallel/tensor.py``) it holds
    this rank's block of its channels (or all of them where the model
    axis does not divide them), takes its input in that layout, and
    ``group`` is the grid's replica group; a ``group`` of None (a replica
    group of one rank) normalises alone, as ``nn.BatchNorm2d``.
    """

    space = None
    tp = None

    def __init__(self, num_features: int, *, eps: float, momentum: float,
                 affine: bool, group, device=None):
        super().__init__(num_features, eps=eps, momentum=momentum,
                         affine=affine, device=device)
        self.group = group

    def forward(self, x):
        if self.tp is not None:
            x = self.tp.bn_input(self, x)
        replicas = 1
        if self.space is not None:
            height = self.space.height(x)
            if height is not None and not self.space.is_sharded(height):
                replicas = self.space.n
        if not self.training or self.group is None:
            return super().forward(x)
        self.num_batches_tracked.add_(1)
        return _SyncBatchNormFn.apply(x, self.weight, self.bias,
                                      self.running_mean, self.running_var,
                                      self.eps, self.momentum, self.group,
                                      replicas)


def convert_sync_bn(module: nn.Module, group) -> nn.Module:
    """Swap every ``nn.BatchNorm2d`` of ``module`` (affine or not) for a
    ``SyncBatchNorm`` over ``group`` (None: normalising alone) that holds
    the same parameter and buffer tensors, in place; returns ``module``."""
    for name, child in module.named_children():
        if isinstance(child, nn.BatchNorm2d) and \
                not isinstance(child, SyncBatchNorm):
            new = SyncBatchNorm(child.num_features, eps=child.eps,
                                momentum=child.momentum, affine=child.affine,
                                group=group, device=child.running_mean.device)
            if child.affine:
                new.weight, new.bias = child.weight, child.bias
            new.running_mean = child.running_mean
            new.running_var = child.running_var
            new.num_batches_tracked = child.num_batches_tracked
            new.train(child.training)
            setattr(module, name, new)
        else:
            convert_sync_bn(child, group)
    return module
