"""Metrics: the confusion matrix on the device; mIoU, the per-class table,
the LIP PCKh protocol, the heatmap PCK and the Pascal-Person-Part OKS mAP
on the host.

Port of ``npp_tpu/utils/metrics.py``. The confusion matrix is a
``torch.bincount``; the JAX package's one-hot matmul (``metrics.py:38-60``)
worked around a slow scatter on the TPU. The PCKh side (the LIP CSV
files, head-size normalisation, the PCK table), the heatmap PCK, the PPP
PCK table and the OKS mAP (``metrics.py:226-359``) are numpy copies, in
float64 where the JAX package computes in it.
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
    idx = torch.where(valid, label * c + pred.long(), c * c).reshape(-1)
    # A scatter-add, not torch.bincount: on a card bincount reads the
    # largest index on the host, which a CUDA graph cannot capture.
    counts = torch.zeros(c * c + 1, dtype=torch.int64, device=idx.device)
    counts.scatter_add_(0, idx, torch.ones_like(idx))
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
    return pckh_against_csv(gt_path, pred, eval_num)


def pckh_against_csv(gt_path: str, pred: np.ndarray,
                     eval_num: int = 5000) -> np.ndarray:
    """PCKh of (N, 16, 2) predictions in LIP CSV joint order against a
    ground-truth CSV (with visibility), over their first ``eval_num``
    rows."""
    gt, gt_vis = read_pose_csv(gt_path, has_vis_dim=True)
    pred, gt = pred[:eval_num], gt[:eval_num]
    if gt.shape != pred.shape:
        raise ValueError(f"{pred.shape} predictions against {gt_path}'s "
                         f"{gt.shape} ground truth")
    return pckh_from_arrays(pred, gt, gt_vis)


def as_pose_csv_reads(pose_xy: np.ndarray) -> np.ndarray:
    """(N, 16, 2+) predictions as ``read_pose_csv`` reads back the file
    that ``save_pose_csv`` writes of them: the integer x, y in LIP joint
    order, a negative one read as 1."""
    xy = np.trunc(np.asarray(pose_xy)[:, IDX_MAP_TO_LIP, :2])
    xy = xy.astype(np.float64)
    xy[xy < 0] = 1
    return xy


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


# --------------------------------------------------------------------------
# Heatmap-space PCK (npp_tpu/utils/metrics.py:226-266)
# --------------------------------------------------------------------------

def _np_max_preds(heatmaps: np.ndarray):
    """(B, J, H, W) -> preds (B, J, 2) in (x, y) as float32 and maxvals
    (B, J, 1): the first maximum in row-major order wins, and a map whose
    maximum is not positive (an invisible joint's all-zero map) gives
    (0, 0)."""
    b, j, h, w = heatmaps.shape
    flat = heatmaps.reshape(b, j, -1)
    idx = np.argmax(flat, 2)
    maxvals = np.max(flat, 2)[..., None]
    preds = np.stack([idx % w, idx // w], axis=-1).astype(np.float32)
    preds *= (maxvals > 0).astype(np.float32)
    return preds, maxvals


def heatmap_pck_accuracy(output: np.ndarray, target: np.ndarray,
                         thr: float = 0.5):
    """Train-time heatmap PCK of (B, J, H, W) maps against target maps:
    per joint, the share of images whose argmax distance over (H, W) / 10
    is under ``thr``, over the images where the target's argmax is not at
    (0, 0) (the invisible joints). Returns (acc (J + 1,) with the average
    of the joints whose share is positive first, that average, their
    count, the predicted positions)."""
    pred, _ = _np_max_preds(output)
    gt, _ = _np_max_preds(target)
    h, w = output.shape[2], output.shape[3]
    norm = np.array([h, w]) / 10.0
    nj = output.shape[1]
    acc = np.zeros(nj + 1)
    cnt = 0
    avg = 0.0
    for j in range(nj):
        valid = ~((gt[:, j, 0] < 1) & (gt[:, j, 1] < 1))
        if valid.sum() == 0:
            acc[j + 1] = 0
            continue
        d = np.linalg.norm((pred[valid, j] - gt[valid, j]) / norm, axis=1)
        acc[j + 1] = np.mean(d < thr)
        if acc[j + 1] > 0:
            avg += acc[j + 1]
            cnt += 1
    avg = avg / cnt if cnt else 0
    acc[0] = avg
    return acc, avg, cnt, pred


class MulAverageMeter:
    """A vector of running averages."""

    def __init__(self, length: int):
        self.sum = np.zeros(length)
        self.count = np.zeros(length)

    def update(self, val, n: int = 1) -> None:
        self.sum += np.asarray(val) * n
        self.count += n

    def val(self) -> np.ndarray:
        return np.where(self.count > 0, self.sum / np.maximum(self.count, 1),
                        0.0)


def ppp_pck_table(pck: np.ndarray, method_name: str = "Ours") -> str:
    """The PPP PCK table in the 14-joint order; ``pck[0]`` is the average,
    ``pck[1:]`` the joints (left and right averaged)."""
    p = pck
    cells = [
        ("fore", p[1]), ("neck", p[2]), ("sho.", (p[3] + p[9]) / 2),
        ("elb.", (p[4] + p[10]) / 2), ("wri.", (p[5] + p[11]) / 2),
        ("hip", (p[6] + p[12]) / 2), ("knee", (p[7] + p[13]) / 2),
        ("ank.", (p[8] + p[14]) / 2), ("Avg.", p[0]),
    ]
    head = "PCK@0.5    " + " ".join(f"{n:>7}" for n, _ in cells)
    vals = f"{method_name:10} " + " ".join(f"{v:7.1f}" for _, v in cells)
    return head + "\n" + vals


# --------------------------------------------------------------------------
# OKS mAP for Pascal-Person-Part pose (npp_tpu/utils/metrics.py:269-341)
# --------------------------------------------------------------------------

PPP_SIGMAS = np.array([1., 1., 1., .8, .8, .6, .6, .6, 1., .8, .8, .6, .6,
                       .6]) / 10


def cal_oks(p_gt: np.ndarray, p_pred: np.ndarray, box: np.ndarray) -> float:
    """OKS of one person's (J, 2) prediction, relative to its box's
    corner, against its (J, 3) ground truth, normalised by the (1, 4)
    box's area; only joints visible in the ground truth count."""
    var = (box[0, 2] - box[0, 0]) * (box[0, 3] - box[0, 1]) + np.spacing(1)
    var = 0.06 * var
    vis = p_gt[:, 2]
    dx = p_gt[:, 0] - (p_pred[:, 0] + box[0, 0])
    dy = p_gt[:, 1] - (p_pred[:, 1] + box[0, 1])
    e = (dx ** 2 + dy ** 2) / var / 2
    oks = np.exp(-e)[vis > 0].sum()
    return oks / max((vis > 0).sum(), 1)


def cal_map_image(preds, gt_joints, gt_boxes, hits, counts, thr=0.5):
    """One image: each ground-truth person takes the prediction of the
    highest OKS; its visible joints count, and where that OKS reaches
    ``thr``, each joint whose keypoint similarity reaches it is a hit.
    ``preds``: list of (J, 2); ``gt_joints``: list of (J, 3);
    ``gt_boxes``: list of (1, 4). Returns the updated (hits, counts)."""
    n_gt = len(gt_joints)
    oks_m = np.zeros((n_gt, len(preds)))
    for i in range(n_gt):
        for j, p in enumerate(preds):
            oks_m[i, j] = cal_oks(gt_joints[i], p, gt_boxes[i])
    match = np.argmax(oks_m, axis=1)
    for i in range(n_gt):
        box = gt_boxes[i]
        var = ((box[0, 2] - box[0, 0]) * (box[0, 3] - box[0, 1])
               + np.spacing(1)) * PPP_SIGMAS ** 2
        p = preds[match[i]]
        dx = gt_joints[i][:, 0] - (p[:, 0] + box[0, 0])
        dy = gt_joints[i][:, 1] - (p[:, 1] + box[0, 1])
        dist = np.exp(-(dx ** 2 + dy ** 2) / var / 2)
        vis = (gt_joints[i][:, 2] > 0).astype(np.float64)
        counts += vis
        if oks_m[i, match[i]] >= thr:
            hits += ((dist >= thr) & (vis > 0)).astype(np.float64)
    return hits, counts


def oks_map(per_image_preds: dict, per_image_gt: dict,
            thresholds=np.arange(0.5, 1.0, 0.05)) -> np.ndarray:
    """Per-joint AP, then their mean, averaged over the OKS thresholds
    0.5:0.05:0.95. ``per_image_preds[name]``: list of (J, 2) person
    predictions; ``per_image_gt[name]``: (list of (J, 3) joints, list of
    (1, 4) boxes). Images without ground truth are skipped."""
    n_joints = len(PPP_SIGMAS)
    aps = []
    for t in thresholds:
        hits = np.zeros(n_joints)
        counts = np.zeros(n_joints)
        for name, preds in per_image_preds.items():
            if name not in per_image_gt:
                continue
            gj, gb = per_image_gt[name]
            hits, counts = cal_map_image(preds, gj, gb, hits, counts, thr=t)
        ap = hits / np.maximum(counts, 1)
        aps.append(np.concatenate([ap, [ap.mean()]]))
    return np.mean(np.stack(aps), axis=0)
