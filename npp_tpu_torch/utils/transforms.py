"""Keypoint and affine transform helpers, without cv2.

Port of ``npp_tpu/utils/transforms.py:15-124``: ``flip_back``,
``fliplr_joints``, ``get_affine_transform`` (the 200 px-scale MPII
convention; ``pixel_std=1`` gives the raw-scale variant),
``affine_transform``, ``transform_preds``, ``crop`` and the affine
decode ``get_final_preds`` with its quarter-pixel offset. These serve
the alternative affine decode path; the port's main decode is
``core/inference.py``.

cv2 is replaced by the port's own rules: ``cv2.getAffineTransform`` by
OpenCV's own float64 elimination (``solve_affine``), ``cv2.warpAffine(...,
INTER_LINEAR)`` by the host library's linear warp
(``data/imgproc.warp_affine``).
"""
from __future__ import annotations

import numpy as np

from npp_tpu_torch.data import imgproc
from npp_tpu_torch.utils.metrics import _np_max_preds


def flip_back(output_flipped: np.ndarray, matched_parts) -> np.ndarray:
    """Unflip (B, J, H, W) heatmaps along W and swap the matched joints'
    channels."""
    out = output_flipped[:, :, :, ::-1].copy()
    for a, b in matched_parts:
        out[:, [a, b]] = out[:, [b, a]]
    return out


def fliplr_joints(joints: np.ndarray, joints_vis: np.ndarray, width: int,
                  matched_parts):
    """Mirror (J, D) joints in an image ``width`` wide, swap the matched
    pairs and zero the invisible ones; returns (joints, visibility)."""
    joints = joints.copy()
    joints_vis = joints_vis.copy()
    joints[:, 0] = width - joints[:, 0] - 1
    for a, b in matched_parts:
        joints[[a, b]] = joints[[b, a]]
        joints_vis[[a, b]] = joints_vis[[b, a]]
    return joints * joints_vis, joints_vis


def get_dir(src_point, rot_rad):
    """``src_point`` turned by ``rot_rad``."""
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    return [src_point[0] * cs - src_point[1] * sn,
            src_point[0] * sn + src_point[1] * cs]


def get_3rd_point(a, b):
    """The point that makes a right angle at ``b`` with ``a``."""
    direct = a - b
    return b + np.array([-direct[1], direct[0]], dtype=np.float32)


def solve_affine(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """``cv2.getAffineTransform(src, dst)``: the 2x3 float64 matrix that
    maps the three (x, y) points of ``src`` onto ``dst``. It solves the
    6x6 float64 system cv2 builds (rows x then y of each point) by
    Gaussian elimination with partial pivoting in OpenCV's operation
    order, so it gives cv2's bits."""
    src = np.asarray(src, np.float32)
    dst = np.asarray(dst, np.float32)
    a = [[0.0] * 6 for _ in range(6)]
    b = [0.0] * 6
    for i in range(3):
        x, y = float(src[i, 0]), float(src[i, 1])
        a[2 * i][0:3] = [x, y, 1.0]
        a[2 * i + 1][3:6] = [x, y, 1.0]
        b[2 * i], b[2 * i + 1] = float(dst[i, 0]), float(dst[i, 1])
    for i in range(6):
        k = max(range(i, 6), key=lambda r: (abs(a[r][i]), -r))
        if abs(a[k][i]) < 100 * np.finfo(np.float64).eps:
            raise ValueError("solve_affine: the source points are collinear")
        a[i], a[k], b[i], b[k] = a[k], a[i], b[k], b[i]
        d = -1 / a[i][i]
        for j in range(i + 1, 6):
            alpha = a[j][i] * d
            for c in range(i + 1, 6):
                a[j][c] += alpha * a[i][c]
            b[j] += alpha * b[i]
    for i in range(5, -1, -1):
        s = b[i]
        for c in range(i + 1, 6):
            s -= a[i][c] * b[c]
        b[i] = s / a[i][i]
    return np.array(b).reshape(2, 3)


def get_affine_transform(center, scale, rot, output_size,
                         shift=np.array([0, 0], dtype=np.float32),
                         inv: int = 0, pixel_std: float = 200.0
                         ) -> np.ndarray:
    """The 2x3 affine from the box of ``center`` and ``scale`` (in units
    of ``pixel_std`` pixels), turned by ``rot`` degrees, onto an
    ``output_size`` = (w, h) image; its inverse with ``inv``."""
    if not isinstance(scale, (np.ndarray, list)):
        scale = np.array([scale, scale])
    scale_tmp = np.asarray(scale) * pixel_std
    src_w = scale_tmp[0]
    dst_w, dst_h = output_size[0], output_size[1]

    rot_rad = np.pi * rot / 180
    src_dir = get_dir([0, src_w * -0.5], rot_rad)
    dst_dir = np.array([0, dst_w * -0.5], np.float32)

    src = np.zeros((3, 2), dtype=np.float32)
    dst = np.zeros((3, 2), dtype=np.float32)
    src[0, :] = center + scale_tmp * shift
    src[1, :] = center + src_dir + scale_tmp * shift
    dst[0, :] = [dst_w * 0.5, dst_h * 0.5]
    dst[1, :] = np.array([dst_w * 0.5, dst_h * 0.5]) + dst_dir
    src[2:, :] = get_3rd_point(src[0, :], src[1, :])
    dst[2:, :] = get_3rd_point(dst[0, :], dst[1, :])

    if inv:
        return solve_affine(dst, src)
    return solve_affine(src, dst)


def affine_transform(pt, t):
    """The (x, y) point ``pt`` mapped by the 2x3 matrix ``t``."""
    new_pt = np.array([pt[0], pt[1], 1.0]).T
    return (t @ new_pt)[:2]


def transform_preds(coords: np.ndarray, center, scale, output_size
                    ) -> np.ndarray:
    """(J, D) heatmap coordinates back into the source image."""
    trans = get_affine_transform(center, scale, 0, output_size, inv=1)
    out = np.zeros_like(coords)
    for p in range(coords.shape[0]):
        out[p, 0:2] = affine_transform(coords[p, 0:2], trans)
    return out


def crop(img: np.ndarray, center, scale, output_size, rot: float = 0
         ) -> np.ndarray:
    """The affine crop of an (H, W, 3) or (H, W) uint8 image, bilinear
    with a black border (``cv2.warpAffine(..., INTER_LINEAR)``)."""
    trans = get_affine_transform(center, scale, rot, output_size)
    return imgproc.warp_affine(img, trans,
                               (int(output_size[0]), int(output_size[1])),
                               "linear", 0)


def get_final_preds(batch_heatmaps: np.ndarray, center, scale,
                    post_process: bool = True):
    """Affine decode of (B, J, H, W) heatmaps: each argmax moved a quarter
    pixel towards its higher neighbour, then mapped into the source
    image by each sample's ``center`` and ``scale``. Returns (preds
    (B, J, 2), maxvals (B, J, 1))."""
    coords, maxvals = _np_max_preds(batch_heatmaps)
    h, w = batch_heatmaps.shape[2], batch_heatmaps.shape[3]
    if post_process:
        for n in range(coords.shape[0]):
            for p in range(coords.shape[1]):
                hm = batch_heatmaps[n][p]
                px = int(np.floor(coords[n][p][0] + 0.5))
                py = int(np.floor(coords[n][p][1] + 0.5))
                if 1 < px < w - 1 and 1 < py < h - 1:
                    diff = np.array([hm[py][px + 1] - hm[py][px - 1],
                                     hm[py + 1][px] - hm[py - 1][px]])
                    coords[n][p] += np.sign(diff) * 0.25
    preds = coords.copy()
    for i in range(coords.shape[0]):
        preds[i] = transform_preds(coords[i], center[i], scale[i], [w, h])
    return preds, maxvals
