"""Epoch-level training loop shared by the CLIs.

Port of ``npp_tpu/engine.py:15-49, 136-141`` (the reference's
``core/function.py`` ``train`` loop and the best-model rule of its entry
scripts). The scanned-dispatch and search epochs are not ported.
"""
from __future__ import annotations

import time

from npp_tpu_torch.utils.logging_utils import AverageMeter


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
            ave_loss.update(float(loss_sum) / n_pending, n=n_pending)
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
        ave_loss.update(float(loss_sum) / n_pending, n=n_pending)
    return ave_loss.average(), global_step


def is_best_checkpoint(mean_iou: float, pck_avg: float, best_iou: float,
                       best_pck: float) -> bool:
    """Coupled best-model criterion (search_lip_sync.py:338-353 in the
    reference)."""
    if best_iou < mean_iou:
        return best_pck - 1 < pck_avg
    return best_pck + 1 < pck_avg
