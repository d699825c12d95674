"""Segmentation metrics: the confusion matrix on the device, mIoU and the
per-class table on the host.

Port of ``npp_tpu/utils/metrics.py:22-85, 173-192``. The confusion matrix
is a ``torch.bincount``; the JAX package's one-hot matmul
(``metrics.py:38-60``) worked around a slow scatter on the TPU.
"""
from __future__ import annotations

import numpy as np
import torch

LIP_CLASS_NAMES = (
    "background", "hat", "hair", "glove", "sunglasses", "upperclothes",
    "dress", "coat", "socks", "pants", "jumpsuits", "scarf", "skirt",
    "face", "leftArm", "rightArm", "leftLeg", "rightLeg", "leftShoe",
    "rightShoe",
)


def confusion_matrix(label: torch.Tensor, pred: torch.Tensor,
                     num_classes: int, ignore: int = 255) -> torch.Tensor:
    """(num_classes, num_classes) int64 counts of (B, H, W) labels against
    predictions; rows are the ground truth. Pixels labelled ``ignore`` or
    outside [0, num_classes) are not counted, as in the JAX package."""
    c = num_classes
    label = label.long()
    valid = (label != ignore) & (label >= 0) & (label < c)
    idx = torch.where(valid, label * c + pred.long(), c * c)
    counts = torch.bincount(idx.reshape(-1), minlength=c * c + 1)
    return counts[:c * c].reshape(c, c)


def seg_metrics(cm: np.ndarray) -> dict:
    """Reductions of the confusion matrix (a copy of
    ``npp_tpu/utils/metrics.py:63-85``)."""
    cm = np.asarray(cm, np.float64)
    pos = cm.sum(1)
    res = cm.sum(0)
    tp = np.diag(cm)
    iou_array = tp / np.maximum(1.0, pos + res - tp)
    with np.errstate(divide="ignore", invalid="ignore"):
        per_class_acc = tp / pos
        freq = pos / cm.sum()
        union = pos + res - tp
        per_class_iou = np.where(union > 0, tp / union, np.nan)
    return {
        "pixel_acc": tp.sum() / max(cm.sum(), 1.0),
        "mean_acc": np.nanmean(per_class_acc),
        "per_class_acc": per_class_acc,
        "mean_iou": float(iou_array.mean()),
        "iou_array": iou_array,
        "per_class_iou": per_class_iou,
        "fw_iou": float(np.nansum(freq[freq > 0]
                                  * per_class_iou[freq > 0])),
    }


def per_class_table(per_class_iou: np.ndarray,
                    per_class_acc: np.ndarray | None = None) -> str:
    """Per-class IoU (+acc) table; LIP class names when the count
    matches, else class indices."""
    n = len(per_class_iou)
    class_names = (LIP_CLASS_NAMES if n == len(LIP_CLASS_NAMES)
                   else tuple(f"class_{i}" for i in range(n)))
    lines = [f"{'class':>14} {'IoU':>7}"
             + ("" if per_class_acc is None else f" {'acc':>7}")]
    for i, name in enumerate(class_names):
        row = f"{name:>14} {per_class_iou[i]:7.4f}"
        if per_class_acc is not None:
            row += f" {per_class_acc[i]:7.4f}"
        lines.append(row)
    lines.append(f"{'mean':>14} {np.nanmean(per_class_iou):7.4f}"
                 + ("" if per_class_acc is None
                    else f" {np.nanmean(per_class_acc):7.4f}"))
    return "\n".join(lines)
