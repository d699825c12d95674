"""LIP dataset: joint pose + parsing samples read from a LIP directory.

Port of ``npp_tpu/data/lip.py:21-152`` (``LIPDataset``) without cv2:
images are read by ``utils/vis.read_image`` (JPEG through the host
decoder, PNG through the standard-library reader), parsing labels as
8-bit grey PNGs by ``utils/vis.read_png`` (anything else raises), the
JSON annotations with ``json``. The augmentation chain is
``data/augmentation.py`` and the label chain
``data/targets.gen_parsing_target``. Samples hold geometry (image,
warped labels, joints, visibility, scale, crop_param); the loader
renders the heatmaps and edges on the device.

One ``np.random.default_rng(seed)`` serves every call, as in npp_tpu: a
loader with several threads shares it, so which sample gets which draws
then depends on thread scheduling (sequential ``__getitem__`` calls give
npp_tpu's samples). ``FastLIPDataset`` (the ``--fast-aug`` fused warp)
is not ported.
"""
from __future__ import annotations

import json
import os

import numpy as np

from npp_tpu_torch.data import augmentation as aug
from npp_tpu_torch.data import targets as tgt
from npp_tpu_torch.data.synthetic import IMAGENET_MEAN, IMAGENET_STD
from npp_tpu_torch.utils.vis import read_image, read_png

# LIP parsing left/right class pairs (right, left), swapped on a flip
# (npp_tpu/data/lip.py:26).
LIP_FLIP_PAIRS = ((15, 14), (17, 16), (19, 18))

# split -> the (image root, annotation file, label root) keys of a
# dataset layout (``config.LIP.data``), as the JAX CLIs pair them.
SPLITS = {
    "train": ("train_imroot", "train_set", "train_segroot"),
    "val": ("val_imroot", "val_set", "val_segroot"),
    "search_train": ("train_imroot", "search_train_set", "train_segroot"),
    "search_mini": ("train_imroot", "search_mini_set", "train_segroot"),
    "search_val": ("val_imroot", "search_val_set", "val_segroot"),
    "test": ("test_imroot", "test_set", "val_segroot"),
}


def normalize_image(im_uint8_rgb: np.ndarray) -> np.ndarray:
    x = im_uint8_rgb.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def read_label_png(path: str) -> np.ndarray:
    """An 8-bit grey PNG as (H, W) uint8; any other PNG raises."""
    pix, palette = read_png(path)
    if pix.ndim != 2 or palette is not None:
        raise ValueError(f"{path}: parsing labels must be an 8-bit grey PNG")
    return pix


class LIPDataset:
    """Sample dict interface:
    image (H,W,3) f32 normalized, or uint8 with ``device_normalize`` |
    par (H,W) uint8 | joints (16,2) f32 | visibility (16,) f32 |
    scale f32 | crop_param (1,8) f32 | name str.
    """

    num_joints = 16
    flip_pairs = LIP_FLIP_PAIRS

    def __init__(self, root, im_root, pose_anno_file, parsing_anno_root, *,
                 crop_size=(384, 384), sigma=3, pose_net_stride=4,
                 scale_min=0.7, scale_max=1.3, max_rotate_degree=40,
                 max_center_trans=40, flip_prob=0.5, is_train=True,
                 sample=-1, inv_order=False, seed=None,
                 device_normalize=False):
        self.root = root
        self.im_root = os.path.join(root, im_root)
        self.parsing_anno_root = os.path.join(root, parsing_anno_root)
        with open(os.path.join(root, pose_anno_file)) as f:
            self.anno_list = json.load(f)["root"]
        if sample != -1:
            self.anno_list = (self.anno_list[:sample] if not inv_order
                              else self.anno_list[-sample:])
        self.crop_size = crop_size
        self.sigma = sigma
        self.pose_net_stride = pose_net_stride
        self.scale_min = scale_min
        self.scale_max = scale_max
        self.max_rotate_degree = max_rotate_degree
        self.max_center_trans = max_center_trans
        self.flip_prob = flip_prob
        self.is_train = is_train
        # device_normalize: ship raw uint8 images; the loader's renderer
        # (normalize_images=True) normalises them on the device.
        self.device_normalize = device_normalize
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.anno_list)

    def image_names(self):
        return [item["im_name"] for item in self.anno_list]

    def __getitem__(self, index):
        item = self.anno_list[index]
        im_name = item["im_name"]
        im = read_image(os.path.join(self.im_root, im_name))
        name_prefix = im_name.split(".")[0]
        parsing_anno = read_label_png(
            os.path.join(self.parsing_anno_root, name_prefix + ".png"))

        joints_all = np.array(item["joint_self"])
        joints = aug.transform_mpi_to_ours(joints_all[:, 0:2])
        # From the coordinates, not the annotation's third column.
        visibility = np.sum(joints, axis=1) != 0
        center = np.array([item["objpos"]], np.float64)

        return self._build_sample(im, parsing_anno, joints, visibility,
                                  center, name_prefix, self.flip_pairs)

    def _build_sample(self, im, parsing_anno, joints, visibility, center,
                      name, flip_pairs,
                      flip_right=aug.RIGHT_IDX, flip_left=aug.LEFT_IDX):
        cw, ch = self.crop_size
        rng = self.rng
        if self.is_train:
            im_s, scale = aug.augmentation_scale(
                im, 1.0, scale_min=self.scale_min, scale_max=self.scale_max,
                is_train=True, crop_size=float(cw), rng=rng)
            joints, center = aug.scale_coords(joints, center, scale)
            im_r, rot = aug.augmentation_rotate(
                im_s, max_rotate_degree=self.max_rotate_degree, rng=rng)
            joints, center = aug.rotate_coords(joints, center, rot)
            im_c, crop_param = aug.augmentation_cropped(
                im_r, center, crop_x=cw, crop_y=ch,
                max_center_trans=self.max_center_trans, rng=rng)
            joints, center = aug.crop_coords(joints, center, crop_param)
            im_f, flip = aug.augmentation_flip(im_c, flip_prob=self.flip_prob,
                                               rng=rng)
            joints, center = aug.flip_coords(joints, center, flip,
                                             im_f.shape[1], flip_right,
                                             flip_left)
            if flip:
                visibility = visibility.copy()
                for r, l in zip(flip_right, flip_left):
                    visibility[r], visibility[l] = (visibility[l],
                                                    visibility[r])
            par = tgt.gen_parsing_target(
                parsing_anno, scale_param=scale,
                rotate_param=[rot, im_r.shape[1], im_r.shape[0]],
                crop_param=[crop_param, im_c.shape[1], im_c.shape[0]],
                flip_param=flip, stride=1, flip_pairs=flip_pairs)
            image = im_f
        else:
            im_s, scale = aug.augmentation_scale(
                im, 1.0, is_train=False, crop_size=float(cw), rng=rng)
            joints, center = aug.scale_coords(joints, center, scale)
            im_c, crop_param = aug.augmentation_cropped(
                im_s, center, crop_x=cw, crop_y=ch, max_center_trans=0,
                rng=rng)
            joints, center = aug.crop_coords(joints, center, crop_param)
            par = tgt.gen_parsing_target(
                parsing_anno, scale_param=scale,
                crop_param=[crop_param, im_c.shape[1], im_c.shape[0]],
                stride=1, flip_pairs=flip_pairs)
            image = im_c

        image = np.ascontiguousarray(image.astype(np.uint8))
        return {
            "image": (image if self.device_normalize
                      else normalize_image(image)),
            "par": par.astype(np.uint8),
            "joints": joints.astype(np.float32),
            "visibility": visibility.astype(np.float32),
            "scale": np.float32(scale),
            "crop_param": crop_param.astype(np.float32),  # (1, 8)
            "name": name,
        }


def dataset_for(layout: dict, split: str, root: str, **kw) -> LIPDataset:
    """The ``LIPDataset`` of ``split`` (a key of ``SPLITS``) under
    ``root``, with the directories and annotation file that ``layout``
    names for it; ``kw`` go to ``LIPDataset``."""
    im_root, anno, seg_root = (layout[k] for k in SPLITS[split])
    return LIPDataset(root, im_root, anno, seg_root, **kw)
