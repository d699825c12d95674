"""Synthetic joint pose + parsing dataset.

A jax-free, cv2-free copy of ``npp_tpu/data/synthetic.py``: deterministic,
LIP-shaped random samples (blob "body parts" with consistent parsing
masks, joint locations and crop params) made from ``seed`` with numpy, so
the eval path runs without the LIP archives. The samples are identical
to the JAX package's for the same arguments.
"""
from __future__ import annotations

import numpy as np

# ImageNet normalisation (npp_tpu/data/lip.py:21-22).
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class SyntheticDataset:
    """The sample dict interface of the LIP dataset: ``image`` (H, W, 3),
    ``par`` (H, W) uint8, ``joints`` (J, 2), ``visibility`` (J,),
    ``scale``, ``crop_param`` (1, 8) and ``name``. With
    ``device_normalize=True`` the image stays raw uint8 and the loader's
    renderer normalises it on the device."""

    def __init__(self, *, length=64, crop_size=(384, 384), num_joints=16,
                 num_classes=20, seed=0, is_train=True,
                 device_normalize=False):
        self.length = length
        self.crop_size = crop_size
        self.num_joints = num_joints
        self.num_classes = num_classes
        self.seed = seed
        self.is_train = is_train  # the LIP reader's flag; samples ignore it
        self.device_normalize = device_normalize

    def __len__(self):
        return self.length

    def image_names(self):
        return [f"synthetic_{i:06d}.jpg" for i in range(self.length)]

    def __getitem__(self, index):
        rng = np.random.default_rng(self.seed * 100003 + index)
        cw, ch = self.crop_size
        image = rng.integers(0, 255, (ch, cw, 3)).astype(np.uint8)
        par = np.zeros((ch, cw), np.uint8)
        joints = np.zeros((self.num_joints, 2), np.float32)
        margin = max(4, min(cw, ch) // 8)
        for j in range(self.num_joints):
            cx = rng.integers(margin, cw - margin)
            cy = rng.integers(margin, ch - margin)
            cls = 1 + (j % (self.num_classes - 1))
            half = int(rng.integers(2, max(3, margin)))
            par[max(cy - half, 0):cy + half, max(cx - half, 0):cx + half] = cls
            image[max(cy - half, 0):cy + half,
                  max(cx - half, 0):cx + half] = (cls * 12) % 255
            joints[j] = (cx, cy)
        vis = (rng.random(self.num_joints) > 0.1).astype(np.float32)
        if self.device_normalize:
            img = image
        else:
            img = (image.astype(np.float32) / 255.0
                   - IMAGENET_MEAN) / IMAGENET_STD
        return {
            "image": img,
            "par": par,
            "joints": joints,
            "visibility": vis,
            "scale": np.float32(1.0),
            "crop_param": np.array([[0, 0, 0, 0, cw, ch, cw, ch]],
                                   np.float32),
            "name": f"synthetic_{index:06d}",
        }
