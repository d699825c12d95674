"""Geometric augmentation chain + joint coordinate co-transforms.

Port of ``npp_tpu/data/augmentation.py`` without cv2: random long-side
scale, canvas-expanding rotation, centre-jittered fixed crop and
horizontal flip, each with the matching joint-coordinate transform. The
resize and the warp are the host library's (``data/imgproc.py``), with
cv2's rules: the scaled and rotated images are within one grey level of
cv2's, and everything else (sizes, matrices, crop parameters, joints,
the ``rng`` draws) is equal to npp_tpu's.

The ``rng`` draws come in npp_tpu's order, one per step: the scale
multiplier (drawn even when ``is_train=False``), the angle, the crop's x
then y jitter (drawn even when ``max_center_trans=0``) and the flip.
npp_tpu flips when ``dice < flip_prob``, its fix of the reference's
inverted test; for the default 0.5 the two agree in distribution.
"""
from __future__ import annotations

import math

import numpy as np

from npp_tpu_torch.data import imgproc

# Left/right joint pairing in the internal 16-joint order
# (npp_tpu/data/augmentation.py:20-21).
RIGHT_IDX = (2, 3, 4, 8, 9, 10)
LEFT_IDX = (5, 6, 7, 11, 12, 13)

# MPII -> internal joint order (npp_tpu/data/augmentation.py:24).
MPI_TO_OURS = (9, 8, 12, 11, 10, 13, 14, 15, 2, 1, 0, 3, 4, 5, 7, 6)


def transform_mpi_to_ours(joints: np.ndarray) -> np.ndarray:
    return joints[list(MPI_TO_OURS), :].copy()


def swap_left_and_right(joints: np.ndarray, right_idx=RIGHT_IDX,
                        left_idx=LEFT_IDX) -> np.ndarray:
    out = joints.copy()
    out[list(right_idx)], out[list(left_idx)] = (
        joints[list(left_idx)].copy(), joints[list(right_idx)].copy())
    return out


def rotation_matrix(center: tuple[float, float], angle: float,
                    scale: float = 1.0) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: float64, the centre as float32 (cv2's
    ``Point2f``), the angle in degrees turned by ``angle * (pi / 180)``."""
    cx, cy = (float(np.float32(c)) for c in center)
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]],
                    np.float64)


def augmentation_scale(im: np.ndarray, scale_self: float, *,
                       scale_min: float = 0.8, scale_max: float = 1.5,
                       is_train: bool = True, crop_size: float = 384.0,
                       rng: np.random.Generator | None = None):
    """Long-side-normalised random scale (npp_tpu ``augmentation.py:
    40-53``): a bicubic resize by ``crop_size / long side``, times the
    drawn multiplier when training."""
    rng = rng or np.random.default_rng()
    dice = rng.random()
    scale_multiplier = (scale_max - scale_min) * dice + scale_min
    long_size = max(im.shape[0], im.shape[1])
    base_scale = crop_size / long_size
    scale = base_scale * scale_multiplier if is_train else base_scale
    return imgproc.resize(im, scale, "cubic"), scale


def augmentation_rotate(im: np.ndarray, *, max_rotate_degree: float = 40,
                        rng: np.random.Generator | None = None):
    """Canvas-expanding random rotation (npp_tpu ``augmentation.py:
    56-73``): bicubic, grey 128 outside the image; the canvas is
    ``int(new_w)`` x ``int(new_h)``."""
    rng = rng or np.random.default_rng()
    degree = (rng.random() - 0.5) * 2 * max_rotate_degree
    h, w = im.shape[:2]
    m = rotation_matrix((w / 2, h / 2), degree, 1)
    r = np.deg2rad(degree)
    new_w = abs(np.sin(r) * h) + abs(np.cos(r) * w)
    new_h = abs(np.sin(r) * w) + abs(np.cos(r) * h)
    m[0, 2] += (new_w - w) / 2
    m[1, 2] += (new_h - h) / 2
    rotated = imgproc.warp_affine(im, m, (int(new_w), int(new_h)), "cubic",
                                  128)
    return rotated, m


def augmentation_cropped(im: np.ndarray, obj_center: np.ndarray, *,
                         crop_x: int = 368, crop_y: int = 368,
                         max_center_trans: int = 40,
                         rng: np.random.Generator | None = None):
    """Centre-jittered fixed crop (npp_tpu ``augmentation.py:76-108``)
    onto a float canvas of 128; the crop's end is clamped to shape - 1,
    the reference's off-by-one, kept. Returns the crop and the 8-tuple
    crop_param [crop_start_x, crop_start_y, store_start_x,
    store_start_y, crop_end_x, crop_end_y, store_end_x, store_end_y]."""
    rng = rng or np.random.default_rng()
    x_offset = int((rng.random() - 0.5) * 2 * max_center_trans)
    y_offset = int((rng.random() - 0.5) * 2 * max_center_trans)
    cx = obj_center[0, 0] + x_offset
    cy = obj_center[0, 1] + y_offset

    cropped = np.zeros((crop_y, crop_x, 3), dtype="float") + 128.0
    off_sx = int(cx - crop_x / 2.0)
    off_sy = int(cy - crop_y / 2.0)
    crop_sx, crop_sy = max(off_sx, 0), max(off_sy, 0)
    store_sx, store_sy = max(-off_sx, 0), max(-off_sy, 0)
    off_ex = int(cx + crop_x / 2.0)
    off_ey = int(cy + crop_y / 2.0)
    crop_ex = min(off_ex, im.shape[1] - 1)
    crop_ey = min(off_ey, im.shape[0] - 1)
    store_ex = store_sx + (crop_ex - crop_sx)
    store_ey = store_sy + (crop_ey - crop_sy)
    cropped[store_sy:store_ey, store_sx:store_ex, :] = \
        im[crop_sy:crop_ey, crop_sx:crop_ex, :]
    param = np.array([[crop_sx, crop_sy, store_sx, store_sy,
                       crop_ex, crop_ey, store_ex, store_ey]])
    return cropped, param


def augmentation_flip(im: np.ndarray, *, flip_prob: float = 0.5,
                      rng: np.random.Generator | None = None):
    """Random horizontal flip (npp_tpu ``augmentation.py:111-116``)."""
    rng = rng or np.random.default_rng()
    doflip = bool(rng.random() < flip_prob)
    return (im[:, ::-1].copy() if doflip else im.copy()), doflip


# --- joint coordinate co-transforms (npp_tpu augmentation.py:119-149) ------

def scale_coords(joints, center, scale_param):
    return joints * scale_param, center * scale_param


def rotate_coords(joints, center, rotate_param):
    jp = np.ones((3, joints.shape[0]))
    jp[0:2, :] = joints.T
    cp = np.ones((3, 1))
    cp[0:2, :] = center.T
    return (rotate_param @ jp).T, (rotate_param @ cp).T


def crop_coords(joints, center, crop_param):
    j = joints.copy()
    j[:, 0] = j[:, 0] - crop_param[0, 0] + crop_param[0, 2]
    j[:, 1] = j[:, 1] - crop_param[0, 1] + crop_param[0, 3]
    c = center.copy()
    c[:, 0] = c[:, 0] - crop_param[0, 0] + crop_param[0, 2]
    c[:, 1] = c[:, 1] - crop_param[0, 1] + crop_param[0, 3]
    return j, c


def flip_coords(joints, center, flip_param, im_width, right_idx=RIGHT_IDX,
                left_idx=LEFT_IDX):
    j = joints.copy()
    c = center.copy()
    if flip_param:
        j[:, 0] = im_width - 1 - j[:, 0]
        j = swap_left_and_right(j, right_idx, left_idx)
        c[:, 0] = im_width - 1 - c[:, 0]
    return j, c
