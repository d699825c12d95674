"""The ``--fast-aug`` fused warp: ctypes bindings of ``csrc/fused_augment.cpp``.

Port of ``npp_tpu/data/fast_aug.py``. The reference's scale -> rotate ->
crop -> flip chain (three full-image resamples) runs as ONE bilinear
inverse warp with the ImageNet normalisation fused in, and the labels as
one nearest warp with the flip's class swap. The source is built into the
readers' host library (``data/imgproc.py``) at the first call, never at
import; a failed build raises. There is no fallback to the parity path.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from npp_tpu_torch.data import imgproc
from npp_tpu_torch.data.synthetic import IMAGENET_MEAN, IMAGENET_STD

_MEAN = np.ascontiguousarray(IMAGENET_MEAN, np.float32)
_STD = np.ascontiguousarray(IMAGENET_STD, np.float32)
_p, _f = ctypes.c_void_p, ctypes.c_float


def _ptr(a: Optional[np.ndarray]):
    return None if a is None else a.ctypes.data_as(_p)


def make_swap_lut(flip_pairs) -> np.ndarray:
    """The 256-entry class table that swaps each (a, b) pair."""
    lut = np.arange(256, dtype=np.uint8)
    for a, b in flip_pairs:
        lut[a], lut[b] = b, a
    return lut


def fused_augment(image: np.ndarray, label: Optional[np.ndarray],
                  joints: Optional[np.ndarray], *, scale: float,
                  rot_deg: float, crop_dx: float, crop_dy: float,
                  flip: bool, out_hw: tuple[int, int],
                  swap_lut: Optional[np.ndarray] = None,
                  as_uint8: bool = False):
    """One augmented sample in one pass. ``image`` (H, W, 3) uint8 RGB,
    ``label`` (H, W) uint8 or None, ``joints`` (J, 2) xy or None;
    ``crop_dx`` / ``crop_dy`` = store start - crop start per axis.

    Returns (image (oh, ow, 3): float32 ImageNet-normalised, or uint8
    with ``as_uint8``; labels (oh, ow) uint8 with 255 outside the source
    and ``swap_lut`` applied when flipped, or None; joints mapped through
    the same chain as float32, or None)."""
    lib = imgproc._library()
    oh, ow = out_hw
    image = np.ascontiguousarray(image, np.uint8)
    if image.ndim != 3 or image.shape[2] != 3 or min(image.shape[:2]) < 1:
        raise ValueError(f"image must be (H, W, 3), got {image.shape}")
    sh, sw = image.shape[:2]
    out_label = None
    if label is not None:
        label = np.ascontiguousarray(label, np.uint8)
        if label.shape != (sh, sw):
            raise ValueError(f"labels {label.shape} do not match the image "
                             f"{image.shape}")
        out_label = np.empty((oh, ow), np.uint8)
    lut = (np.ascontiguousarray(swap_lut, np.uint8)
           if swap_lut is not None else make_swap_lut(()))
    if lut.shape != (256,):
        raise ValueError(f"swap_lut must have 256 entries, got {lut.shape}")
    geometry = (_ptr(image), _ptr(label), sh, sw, _f(scale), _f(rot_deg),
                _f(crop_dx), _f(crop_dy), int(flip), oh, ow)
    if as_uint8:
        out_img = np.empty((oh, ow, 3), np.uint8)
        lib.npp_fused_augment_u8(*geometry, _ptr(lut), _ptr(out_img),
                                 _ptr(out_label))
    else:
        out_img = np.empty((oh, ow, 3), np.float32)
        lib.npp_fused_augment(*geometry, _ptr(_MEAN), _ptr(_STD), _ptr(lut),
                              _ptr(out_img), _ptr(out_label))
    out_joints = None
    if joints is not None:
        out_joints = np.ascontiguousarray(joints, np.float32).copy()
        if out_joints.ndim != 2 or out_joints.shape[1] != 2:
            raise ValueError(f"joints must be (J, 2), got {out_joints.shape}")
        lib.npp_transform_joints(
            _ptr(out_joints), out_joints.shape[0], sh, sw, _f(scale),
            _f(rot_deg), _f(crop_dx), _f(crop_dy), int(flip), ow)
    return out_img, out_label, out_joints
