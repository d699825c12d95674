"""Metrics: the confusion matrix on the device; mIoU, the per-class table
and the LIP PCKh protocol on the host.

Port of ``npp_tpu/utils/metrics.py:22-220``. The confusion matrix is a
``torch.bincount``; the JAX package's one-hot matmul (``metrics.py:38-60``)
worked around a slow scatter on the TPU. The PCKh side (the LIP CSV
files, head-size normalisation, the PCK table) is a numpy copy.
"""
from __future__ import annotations

import csv

import numpy as np
import torch

LIP_CLASS_NAMES = (
    "background", "hat", "hair", "glove", "sunglasses", "upperclothes",
    "dress", "coat", "socks", "pants", "jumpsuits", "scarf", "skirt",
    "face", "leftArm", "rightArm", "leftLeg", "rightLeg", "leftShoe",
    "rightShoe",
)

# Internal joint order -> LIP CSV order (npp_tpu/utils/metrics.py:30).
IDX_MAP_TO_LIP = (10, 9, 8, 11, 12, 13, 15, 14, 1, 0, 4, 3, 2, 5, 6, 7)


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


def read_pose_csv(path: str, has_vis_dim: bool):
    """A LIP pose CSV (name, then x, y[, vis] per joint; 'nan' read as -1)
    -> (coords (N, J, 2), visibility (N, J))."""
    labels = []
    with open(path) as f:
        for row in csv.reader(f, delimiter=","):
            labels.append([-1.0 if v == "nan" else float(v)
                           for v in row[1:]])
    data = np.array(labels)
    dim = 3 if has_vis_dim else 2
    data = data.reshape(data.shape[0], data.shape[1] // dim, dim)
    if has_vis_dim:
        vis = data[:, :, 2].copy()
        data = data[:, :, 0:2]
    else:
        vis = np.ones(data.shape[:2])
        data[data < 0] = 1
    return data, vis


def get_head_size(gt: np.ndarray) -> np.ndarray:
    """Head-segment length from joints 8 (neck) and 9 (head top) in CSV
    order; 0 where either is missing."""
    head = np.linalg.norm(gt[:, 9, :] - gt[:, 8, :], axis=1)
    head[(gt[:, 8, 0] < 0) | (gt[:, 9, 0] < 0)] = 0
    return head


def norm_dist(pred: np.ndarray, gt: np.ndarray,
              ref_dist: np.ndarray) -> np.ndarray:
    """Distances over the head size; -1 where there is no head size or no
    ground-truth joint."""
    n, p = pred.shape[:2]
    dist = np.full((n, p), -1.0)
    ok = ref_dist > 0
    d = np.linalg.norm(gt - pred, axis=2)
    dist[ok] = d[ok] / ref_dist[ok, None]
    dist[(gt[:, :, 0] < 0) | (gt[:, :, 1] < 0)] = -1
    return dist


def compute_pck(dist: np.ndarray, thresholds=(0.5,)) -> np.ndarray:
    """(len(thresholds), J + 2): PCK per joint, then the upper body (CSV
    joints 8-15) and all joints but the pelvis and thorax (6, 7)."""
    p = dist.shape[1]
    pck = np.zeros((len(thresholds), p + 2))
    for ti, th in enumerate(thresholds):
        for j in range(p):
            d = dist[:, j]
            valid = d >= 0
            pck[ti, j] = 100 * np.mean(d[valid] <= th) if valid.any() else 0
        ub = dist[:, 8:16]
        pck[ti, p] = 100 * np.mean(ub[ub >= 0] <= th)
        allj = dist[:, list(range(0, 6)) + list(range(8, 16))]
        pck[ti, p + 1] = 100 * np.mean(allj[allj >= 0] <= th)
    return pck


def pckh_from_arrays(pred: np.ndarray, gt: np.ndarray,
                     gt_vis: np.ndarray | None = None,
                     thresholds=(0.5,)) -> np.ndarray:
    """PCKh of (N, 16, 2) predictions against ground truth, both in LIP
    CSV joint order (``gt_vis`` is accepted and unused, as in the JAX
    package)."""
    ref = get_head_size(gt)
    dist = norm_dist(pred, gt, ref)
    return compute_pck(dist, thresholds)


def calc_pck_lip(gt_path: str, pred_path: str, eval_num: int = 5000):
    """PCKh of a prediction CSV against a ground-truth CSV (with
    visibility), over their first ``eval_num`` rows."""
    pred, _ = read_pose_csv(pred_path, has_vis_dim=False)
    gt, gt_vis = read_pose_csv(gt_path, has_vis_dim=True)
    pred, gt = pred[:eval_num], gt[:eval_num]
    if gt.shape != pred.shape:
        raise ValueError(f"{pred_path} holds {pred.shape} predictions, "
                         f"{gt_path} {gt.shape} ground truth")
    return pckh_from_arrays(pred, gt, gt_vis)


def pckh_table(pck_row: np.ndarray, method_name: str = "Ours") -> str:
    """The LIP PCKh table (left/right pairs averaged) of one row of
    ``compute_pck``."""
    p = pck_row
    cells = [
        ("Head", (p[8] + p[9]) / 2), ("Sho.", (p[12] + p[13]) / 2),
        ("Elb.", (p[11] + p[14]) / 2), ("Wri.", (p[10] + p[15]) / 2),
        ("Hip", (p[2] + p[3]) / 2), ("Knee", (p[1] + p[4]) / 2),
        ("Ank.", (p[0] + p[5]) / 2), ("U.Body", p[-2]), ("Avg.", p[-1]),
    ]
    head = "PCKh@0.5   " + " ".join(f"{n:>7}" for n, _ in cells)
    vals = f"{method_name:10} " + " ".join(f"{v:7.1f}" for _, v in cells)
    return head + "\n" + vals


def save_pose_csv(im_names, pose_xy: np.ndarray, path: str) -> None:
    """Write (N, 16, 2) predictions in the LIP CSV format: one row per
    image, the name then integer x, y per joint in LIP order."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter=",")
        for i, name in enumerate(im_names):
            row = [name]
            for j in IDX_MAP_TO_LIP:
                row.append(str(int(pose_xy[i, j, 0])))
                row.append(str(int(pose_xy[i, j, 1])))
            w.writerow(row)
