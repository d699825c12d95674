"""Dual-task losses with learned homoscedastic uncertainty weighting.

Port of ``npp_tpu/core/criterion.py:30-242``. Tensors are NCHW. The
JAX package's TPU workarounds are replaced by their native torch ops:
the one-hot contractions by ``gather`` / indexing, and the bit-pattern
bisection for OHEM's k-th smallest probability by an exact
``torch.sort`` on the device (the host never reads the k-th value).
Gradients come from autograd. The k-th value is taken from detached
probabilities: the JAX bisection carries no gradient either, and a sort
that autograd records would keep its indices (one int64 per pixel and
stage) alive until the backward.

Under a process group of N > 1 ranks (``group=``, ``parallel/mesh.py``)
the parsing losses are losses of the global batch, the ranks' batches
concatenated in rank order: OHEM's k-th value is taken over every rank's
valid gt-probabilities, and the counts (valid and kept pixels, edge and
non-edge pixels) and the weighted CE's sum of weights are summed over the
ranks. Each rank returns N * (its numerator) / (the global denominator),
so the mean of the ranks' losses is the global loss and DDP's mean of
their gradients is its gradient. No gradient flows through the threshold
or the counts. The pose MSE takes no group: every rank's batch has the
same size, so the mean of the ranks' means is the global mean.

Under spatial partitioning (``grid=``, ``parallel/spatial.py``) the
group spans the ``data x space`` grid and each rank holds its rows of
its data shard's maps and labels. The parsing counts and OHEM's values
are then every rank's pixels, as before. The pose MSE still takes no
group: every rank holds the same number of rows, so the mean of the
ranks' means is the global mean again. The logits are resized to the
label size from the whole maps (``spatial.resize_sharded``).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from npp_tpu_torch.core.graphs import constant
from npp_tpu_torch.ops.resize import resize_bilinear
from npp_tpu_torch.parallel.mesh import all_concat, all_sum
from npp_tpu_torch.parallel.spatial import resize_sharded

# Per-class CE weights (npp_tpu/core/criterion.py:30-39).
PASCAL_CLASS_WEIGHTS = (
    0.82877791, 0.95688253, 0.94921949, 1.00538108, 1.0201687, 1.01665831,
    1.05470914,
)
LIP_CLASS_WEIGHTS = (
    0.7602572, 0.94236198, 0.85644457, 1.04346266, 1.10627293, 0.80980162,
    0.95168713, 0.8403769, 1.05798412, 0.85746254, 1.01274366, 1.05854692,
    1.03430773, 0.84867818, 0.88027721, 0.87580925, 0.98747462, 0.9876475,
    1.00016535, 1.00108882,
)


def init_pose_lamda(num_stages: int, device=None) -> torch.Tensor:
    return torch.full((num_stages,), -2.5, dtype=torch.float32, device=device)


def init_par_lamda(num_stages: int, device=None) -> torch.Tensor:
    return torch.full((num_stages,), 2.3, dtype=torch.float32, device=device)


def init_criterion_params(num_stages: int, device=None) -> dict:
    """The learned stage weights (``npp_tpu/core/train.py:95-99``)."""
    return {"lamda_pose": init_pose_lamda(num_stages, device),
            "lamda_par": init_par_lamda(num_stages, device)}


def _mse(a, b):
    return torch.mean(torch.square(a.float() - b.float()))


def _resize(x: torch.Tensor, like: torch.Tensor, align_corners: bool,
            grid=None) -> torch.Tensor:
    """``x`` (B, C, h, w) at the size of ``like`` (..., H, W); with
    ``grid`` both are this rank's rows of the space axis."""
    h, w = like.shape[-2], like.shape[-1]
    if grid is None or grid.n_space == 1 or tuple(x.shape[-2:]) == (h, w):
        return resize_bilinear(x, (h, w), align_corners=align_corners)
    return resize_sharded(x, grid, (h * grid.n_space, w),
                          align_corners=align_corners)


def joint_mse_loss(output: torch.Tensor, target: torch.Tensor,
                   output_aux: torch.Tensor, target_aux: torch.Tensor,
                   target_weight: torch.Tensor | None = None,
                   grid=None) -> torch.Tensor:
    """Per-joint heatmap MSE over (B, J, H, W) maps plus the aux head's.
    An optional ``target_weight`` (B, J) masks joints before the MSE."""
    w = (None if target_weight is None
         else target_weight.float()[:, :, None, None])

    def one(out, tgt_):
        out = _resize(out, tgt_, False, grid)
        if w is None:
            return _mse(out, tgt_)
        return _mse(out.float() * w, tgt_.float() * w)

    return one(output, target) + one(output_aux, target_aux)


def pose_loss(outputs: Sequence[tuple[torch.Tensor, torch.Tensor]],
              target: torch.Tensor, target_aux: torch.Tensor,
              lamda: torch.Tensor,
              target_weight: torch.Tensor | None = None,
              grid=None) -> torch.Tensor:
    """Deep-supervised pose loss over stages, weighted exp(-lam)*L + lam."""
    total = 0.0
    for i, (out, out_aux) in enumerate(outputs):
        li = joint_mse_loss(out, target, out_aux, target_aux, target_weight,
                            grid)
        total = total + li * torch.exp(-lamda[i]) + lamda[i]
    return total


def _world(group) -> int:
    return torch.distributed.get_world_size(group)


def _gt_log_prob(logits: torch.Tensor, target: torch.Tensor,
                 ignore_index: int):
    """log p(gt class) per pixel of (B, C, H, W) logits, the valid mask
    and the gt labels with ignored pixels set to class 0."""
    valid = target != ignore_index
    tgt = torch.where(valid, target, 0).long()
    logp = F.log_softmax(logits.float(), dim=1)
    return logp.gather(1, tgt[:, None])[:, 0], valid, tgt


def ohem_cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                       class_weights: Sequence[float],
                       ignore_index: int = 255, thres: float = 0.9,
                       min_kept: int = 131072, group=None) -> torch.Tensor:
    """Online hard-example-mining CE. ``logits``: (B, C, H, W) at target
    resolution; ``target``: (B, H, W) labels. Keeps the valid pixels whose
    gt probability is strictly below max(thres, k-th smallest gt
    probability among valid pixels), k = min(min_kept + 1, n_valid); the
    loss is the plain mean of the kept weighted pixel losses. With
    ``group``, of the global batch (module docstring)."""
    gt_logp, valid, tgt = _gt_log_prob(logits, target, ignore_index)
    cw = constant(tuple(float(w) for w in class_weights), torch.float32,
                  logits.device)
    pixel_losses = -gt_logp * cw[tgt]
    gt_prob = torch.exp(gt_logp.detach())  # selects pixels; no gradient

    flat_valid = valid.reshape(-1)
    flat_prob = gt_prob.reshape(-1)
    # Ignored pixels sort after every probability; k <= n_valid (or k = 1
    # with nothing valid) so the k-th value is exact and valid-only.
    masked = torch.where(flat_valid, flat_prob, 3.0)
    n_valid = flat_valid.sum()
    if group is not None:
        masked, n_valid = all_concat(masked, group), all_sum(n_valid, group)
    ranked = torch.sort(masked).values
    k = torch.clamp(n_valid, min=1).clamp(max=min_kept + 1)
    min_value = ranked.index_select(0, (k - 1).reshape(1)).squeeze(0)
    threshold = torch.clamp(min_value, min=thres)

    keep = flat_valid & (flat_prob < threshold)
    kept = torch.where(keep, pixel_losses.reshape(-1), 0.0).sum()
    n_kept = keep.float().sum()
    if group is None:
        return kept / torch.clamp(n_kept, min=1.0)
    n_kept = all_sum(n_kept, group)
    return _world(group) * kept / torch.clamp(n_kept, min=1.0)


def weighted_cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                           weights: torch.Tensor,
                           ignore_index: int = 255,
                           group=None) -> torch.Tensor:
    """``F.cross_entropy(weight=..., ignore_index=...)``: sum(w_t * nll_t) /
    sum(w_t) over non-ignored pixels, with the sum of weights floored at
    1e-12 as in the JAX package; with ``group``, of the global batch."""
    gt_logp, valid, tgt = _gt_log_prob(logits, target, ignore_index)
    w = weights.float()[tgt] * valid.float()
    num, den = torch.sum(-gt_logp * w), w.sum()
    if group is None:
        return num / torch.clamp(den, min=1e-12)
    den = all_sum(den, group)
    return _world(group) * num / torch.clamp(den, min=1e-12)


def single_parsing_loss(par_logits: torch.Tensor, edge_logits: torch.Tensor,
                        target_par: torch.Tensor, target_edge: torch.Tensor,
                        class_weights: Sequence[float],
                        ignore_index: int = 255, thres: float = 0.9,
                        min_kept: int = 131072, group=None,
                        grid=None) -> torch.Tensor:
    """One refinement stage's parsing (OHEM) + edge loss; the edge class
    weights are the batch's edge / non-edge balance (with ``group``, the
    global batch's; with ``grid``, of every rank's rows)."""
    par_logits = _resize(par_logits.float(), target_par, True, grid)
    edge_logits = _resize(edge_logits.float(), target_par, True, grid)
    loss = ohem_cross_entropy(par_logits, target_par, class_weights,
                              ignore_index, thres, min_kept, group)
    counts = torch.stack([(target_edge == 1).float().sum(),
                          (target_edge == 0).float().sum()])
    if group is not None:
        counts = all_sum(counts, group)
    pos, neg = counts[0], counts[1]
    tot = pos + neg
    edge_w = torch.stack([pos / tot, neg / tot])  # by class id 0, 1
    return loss + weighted_cross_entropy(edge_logits, target_edge, edge_w,
                                         ignore_index, group)


def parsing_loss(outputs: Sequence[tuple[torch.Tensor, torch.Tensor]],
                 target_par: torch.Tensor, target_edge: torch.Tensor,
                 lamda: torch.Tensor,
                 class_weights: Sequence[float] = LIP_CLASS_WEIGHTS,
                 ignore_index: int = 255, thres: float = 0.9,
                 min_kept: int = 131072, group=None,
                 grid=None) -> torch.Tensor:
    """Deep-supervised parsing loss over stages (with ``group``, of the
    global batch; the ``+ lamda`` terms are not scaled)."""
    total = 0.0
    for i, (par_logits, edge_logits) in enumerate(outputs):
        li = single_parsing_loss(par_logits, edge_logits, target_par,
                                 target_edge, class_weights, ignore_index,
                                 thres, min_kept, group, grid)
        total = total + li * torch.exp(-lamda[i]) + lamda[i]
    return total
