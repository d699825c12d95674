"""Epoch-level training and search loops shared by the CLIs.

Port of ``npp_tpu/engine.py:15-49, 99-141`` (the reference's
``core/function.py`` ``train`` and ``train_with_alpha`` loops and the
best-model rule of its entry scripts), with ``train_epoch_scanned``
(``engine.py:52-103``, K steps a dispatch). Under a process group the
loss read at each ``print_freq`` is the mean over the ranks (one
all-reduce there, none per step), so every rank returns the same mean.
The logger and the metric writer are quiet off rank 0
(``utils/logging_utils.py``).
"""
from __future__ import annotations

import time

from npp_tpu_torch.core.graphs import stack
from npp_tpu_torch.parallel import mesh
from npp_tpu_torch.utils.logging_utils import AverageMeter


def _read_mean(loss_sum, n: int) -> float:
    """The mean of ``n`` summed step losses (a device scalar), over every
    rank of the process group."""
    if mesh.world_size() > 1:
        loss_sum = mesh.all_sum(loss_sum) / mesh.world_size()
    return float(loss_sum) / n


def train_epoch(train_step, state, loader, *, epoch: int, logger=None,
                writer=None, print_freq: int = 100, global_step: int = 0):
    """One weight-training epoch; returns (mean loss, global_step).

    The loss is summed on the device and read by the host only every
    ``print_freq`` steps (and once at the end): a read each step would
    wait for the device every iteration and stop the host from queueing
    the next step's kernels."""
    ave_loss = AverageMeter()
    tic = time.time()
    loss_sum = None
    n_pending = 0
    for i_iter, batch in enumerate(loader):
        metrics = train_step(state, batch)
        loss_sum = (metrics["loss"] if loss_sum is None
                    else loss_sum + metrics["loss"])
        n_pending += 1
        if i_iter % print_freq == 0:
            ave_loss.update(_read_mean(loss_sum, n_pending), n=n_pending)
            loss_sum, n_pending = None, 0
            if logger:
                logger.info(
                    f"Epoch: [{epoch}][{i_iter}/{len(loader)}] "
                    f"Loss: {ave_loss.average():.6f} "
                    f"(pose {float(metrics['loss_pose']):.4f} "
                    f"par {float(metrics['loss_par']):.4f}) "
                    f"{time.time() - tic:.2f}s")
                tic = time.time()
            if writer is not None:
                writer.scalar("train_loss", ave_loss.average(), global_step)
                global_step += 1
    if n_pending:
        ave_loss.update(_read_mean(loss_sum, n_pending), n=n_pending)
    return ave_loss.average(), global_step


def train_epoch_scanned(multi_step, state, loader, *, epoch: int,
                        steps_per_dispatch: int = 8, logger=None,
                        writer=None, global_step: int = 0):
    """``train_epoch`` with K = ``steps_per_dispatch`` steps a dispatch:
    K loader batches stacked on a leading axis (``graphs.stack``), one
    call of ``multi_step`` (``core/train.make_train_step_scanned``: one
    CUDA graph replay on a card). A short tail chunk runs at its own size
    (one more graph for each tail size). One loss read and one log line a
    dispatch. Returns (mean loss, global_step)."""
    ave_loss = AverageMeter()
    tic = time.time()
    chunk: list = []
    i_iter = 0

    def dispatch(chunk, i_iter, global_step):
        stacked = {k: stack([b[k] for b in chunk])
                   for k in chunk[0] if k not in ("names", "index")}
        metrics = multi_step(state, stacked)
        ave_loss.update(float(metrics["loss"].mean()), n=len(chunk))
        if logger:
            logger.info(
                f"Epoch: [{epoch}][{i_iter}/{len(loader)}] "
                f"Loss: {ave_loss.average():.6f} "
                f"({len(chunk)} steps/dispatch) "
                f"{time.time() - tic:.2f}s")
        if writer is not None:
            writer.scalar("train_loss", ave_loss.average(), global_step)
            global_step += 1
        return global_step

    for batch in loader:
        chunk.append(batch)
        i_iter += 1
        if len(chunk) == steps_per_dispatch:
            global_step = dispatch(chunk, i_iter, global_step)
            chunk = []
            tic = time.time()
    if chunk:
        global_step = dispatch(chunk, i_iter, global_step)
    return ave_loss.average(), global_step


def search_epoch(weight_step, arch_step, state, train_loader, mini_loader,
                 *, epoch: int, entropy_epoch: int = 70, logger=None,
                 writer=None, print_freq: int = 100, global_step: int = 0):
    """One bi-level epoch over the zipped loaders: a weight step on the
    train batch, then an arch step on the mini batch (with the entropy
    term after ``entropy_epoch``). Returns (mean weight-step loss,
    global_step). The losses stay on the device between ``print_freq``
    boundaries, as in ``train_epoch``."""
    ave_loss = AverageMeter()
    entropy_coef = 1.0 if epoch > entropy_epoch else 0.0
    n = min(len(train_loader), len(mini_loader))
    loss_sum = None
    n_pending = 0
    for i_iter, (b1, b2) in enumerate(zip(train_loader, mini_loader)):
        m1 = weight_step(state, b1)
        m2 = arch_step(state, b2, entropy_coef)
        loss_sum = m1["loss"] if loss_sum is None else loss_sum + m1["loss"]
        n_pending += 1
        if i_iter % print_freq == 0:
            ave_loss.update(_read_mean(loss_sum, n_pending), n=n_pending)
            loss_sum, n_pending = None, 0
            if logger:
                logger.info(
                    f"Search epoch [{epoch}][{i_iter}/{n}] "
                    f"w-loss {float(m1['loss']):.4f} "
                    f"a-loss {float(m2['loss']):.4f} "
                    f"entropy {float(m2['entropy']):.4f}")
            if writer is not None:
                writer.scalar("train_loss", ave_loss.average(), global_step)
                global_step += 1
    if n_pending:
        ave_loss.update(_read_mean(loss_sum, n_pending), n=n_pending)
    return ave_loss.average(), global_step


def is_best_checkpoint(mean_iou: float, pck_avg: float, best_iou: float,
                       best_pck: float) -> bool:
    """Coupled best-model criterion (search_lip_sync.py:338-353 in the
    reference)."""
    if best_iou < mean_iou:
        return best_pck - 1 < pck_avg
    return best_pck + 1 < pck_avg
