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

``FastLIPDataset`` (``npp_tpu/data/lip.py:155-242``, the CLIs'
``--fast-aug``) draws its own five numbers per train sample and runs the
chain as one bilinear warp of the host library (``data/fast_aug.py``);
it has no fallback to the parity path.

One ``np.random.default_rng(seed)`` serves every call, as in npp_tpu: a
loader with several threads shares it, so which sample gets which draws
then depends on thread scheduling (sequential ``__getitem__`` calls give
npp_tpu's samples).
"""
from __future__ import annotations

import json
import os

import numpy as np

from npp_tpu_torch.data import augmentation as aug
from npp_tpu_torch.data import fast_aug
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


class FastLIPDataset(LIPDataset):
    """``LIPDataset`` with the fused warp (``--fast-aug``): scale,
    rotate, crop and flip as one bilinear inverse warp with the
    normalisation fused in, and one nearest warp of the labels. Train
    mode draws five ``rng.random()`` per sample (scale, degree, jitter x,
    jitter y, flip), npp_tpu's order, so one seed gives npp_tpu's
    samples. ``crop_param`` is in the parity reader's format, so the eval
    decode inverts it alike."""

    def _build_sample(self, im, parsing_anno, joints, visibility, center,
                      name, flip_pairs,
                      flip_right=aug.RIGHT_IDX, flip_left=aug.LEFT_IDX):
        cw, ch = self.crop_size
        rng = self.rng
        base_scale = float(cw) / max(im.shape[0], im.shape[1])
        if self.is_train:
            mult = (self.scale_max - self.scale_min) * rng.random() \
                + self.scale_min
            scale = base_scale * mult
            deg = (rng.random() - 0.5) * 2 * self.max_rotate_degree
            jitter_x = int((rng.random() - 0.5) * 2 * self.max_center_trans)
            jitter_y = int((rng.random() - 0.5) * 2 * self.max_center_trans)
            flip = bool(rng.random() < self.flip_prob)
        else:
            scale, deg, jitter_x, jitter_y, flip = base_scale, 0.0, 0, 0, \
                False

        # The person centre after scale and rotate (before the crop), as
        # rotate_coords(scale_coords(center)) gives it in the parity chain.
        r = np.deg2rad(deg)
        cs, sn = np.cos(r), np.sin(r)
        sw, sh = im.shape[1] * scale, im.shape[0] * scale
        new_w = abs(sn) * sh + abs(cs) * sw
        new_h = abs(sn) * sw + abs(cs) * sh
        cx0, cy0 = center[0, 0] * scale, center[0, 1] * scale
        rx = (cs * (cx0 - sw / 2) + sn * (cy0 - sh / 2)) + new_w / 2
        ry = (-sn * (cx0 - sw / 2) + cs * (cy0 - sh / 2)) + new_h / 2

        off_x = int(rx + jitter_x - cw / 2.0)
        off_y = int(ry + jitter_y - ch / 2.0)
        out_img, out_par, out_joints = fast_aug.fused_augment(
            im, parsing_anno, joints.astype(np.float32), scale=scale,
            rot_deg=deg, crop_dx=float(-off_x), crop_dy=float(-off_y),
            flip=flip, out_hw=(ch, cw),
            swap_lut=fast_aug.make_swap_lut(flip_pairs),
            as_uint8=self.device_normalize)
        if flip:
            out_joints = aug.swap_left_and_right(out_joints, flip_right,
                                                 flip_left)
            visibility = visibility.copy()
            for rr, ll in zip(flip_right, flip_left):
                visibility[rr], visibility[ll] = (visibility[ll],
                                                  visibility[rr])

        # The parity reader's crop_param (crop start - store start = the
        # offset per axis; the ends clamped to the rotated canvas, as
        # augmentation_cropped does), so the eval decode inverts alike.
        canvas_w = int(new_w) if self.is_train and deg != 0.0 \
            else int(round(im.shape[1] * scale))
        canvas_h = int(new_h) if self.is_train and deg != 0.0 \
            else int(round(im.shape[0] * scale))
        crop_sx, crop_sy = max(off_x, 0), max(off_y, 0)
        store_sx, store_sy = max(-off_x, 0), max(-off_y, 0)
        crop_ex = min(off_x + cw, canvas_w - 1)
        crop_ey = min(off_y + ch, canvas_h - 1)
        crop_param = np.array([[crop_sx, crop_sy, store_sx, store_sy,
                                crop_ex, crop_ey,
                                store_sx + (crop_ex - crop_sx),
                                store_sy + (crop_ey - crop_sy)]],
                              np.float32)
        return {
            "image": out_img,
            "par": out_par,
            "joints": out_joints.astype(np.float32),
            "visibility": visibility.astype(np.float32),
            "scale": np.float32(scale),
            "crop_param": crop_param,
            "name": name,
        }


def dataset_for(layout: dict, split: str, root: str, cls=LIPDataset,
                **kw) -> LIPDataset:
    """The ``cls`` (``LIPDataset`` or ``FastLIPDataset``) of ``split`` (a
    key of ``SPLITS``) under ``root``, with the directories and
    annotation file that ``layout`` names for it; ``kw`` go to ``cls``."""
    im_root, anno, seg_root = (layout[k] for k in SPLITS[split])
    return cls(root, im_root, anno, seg_root, **kw)
