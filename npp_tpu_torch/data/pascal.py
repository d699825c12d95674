"""Pascal-Person-Part: per-person crops with Hungarian-matched instance
masks, read from a PPP directory.

Port of ``npp_tpu/data/pascal.py`` without cv2. ``build_ppp_db`` reads
each id's pose ``.mat`` (``scipy.io.loadmat``: a 1 x P cell of
[x1, y1, x2, y2] boxes and one of (14, 3) joints) and its Mask-R-CNN
instance predictions (a pickled ``.npy`` dict: ``pred_classes``,
``boxes``, ``pred_masks``); person instances (class 0) are matched to
the GT boxes by ``linear_sum_assignment`` on 1 - IoU, and a pair whose
cost is over 0.3 is dropped. ``PPPDataset`` crops each matched person's
box out of the image (``utils/vis.read_image``) and out of the parsing
labels (``lip.read_label_png``: 8-bit grey PNGs only) gated by the
matched mask, then runs ``LIPDataset``'s scale / rotate / crop / flip
chain with no class swap (PPP's parts are side-agnostic) and PPP's
left/right joint sets.

npp_tpu's numpy semantics are kept, not fixed: the box is truncated
(``astype(np.int32)``), the crop is a plain slice (a negative coordinate
wraps), the crop centre comes from the box's size, and the labels times
the mask follow numpy's dtype promotion.

14 joints: 0 forehead, 1 neck, 2-7 one side (shoulder, elbow, wrist,
hip, knee, ankle), 8-13 the other.
"""
from __future__ import annotations

import os

import numpy as np
import scipy.io as scio
from scipy.optimize import linear_sum_assignment

from npp_tpu_torch.data.lip import LIPDataset, read_label_png
from npp_tpu_torch.utils.vis import read_image

# The joints swapped on a flip (npp_tpu/data/pascal.py:28-29, the
# reference's pairing).
PPP_RIGHT_IDX = (2, 3, 4, 5, 6, 7)
PPP_LEFT_IDX = (8, 9, 10, 11, 12, 13)

# split -> the (image root, id list, label root) keys of a PPP layout
# (``config.PPP.data``), as npp_tpu's train CLI pairs them.
SPLITS = {
    "train": ("train_imroot", "train_set", "train_segroot"),
    "val": ("val_imroot", "val_set", "val_segroot"),
}


def box_iou(a, b) -> float:
    """IoU of two [x1, y1, x2, y2] boxes."""
    carea = (a[2] - a[0]) * (a[3] - a[1])
    garea = (b[2] - b[0]) * (b[3] - b[1])
    w = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    h = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = w * h
    return inter / (carea + garea - inter)


def build_ppp_db(im_list, pose_anno_path, mask_path,
                 iou_cost_threshold: float = 0.3) -> list[dict]:
    """One entry (im_name, box, joint, mask) per GT person matched to a
    person instance at a cost of at most ``iou_cost_threshold``, in id
    order and then in GT order; an id without a pose ``.mat`` is
    skipped."""
    db = []
    for im_name in im_list:
        pose_file = os.path.join(pose_anno_path, im_name + ".mat")
        if not os.path.isfile(pose_file):
            continue
        mask_dict = np.load(os.path.join(mask_path, im_name + ".npy"),
                            allow_pickle=True).item()
        person = np.where(mask_dict["pred_classes"] == 0)
        prior_boxes = mask_dict["boxes"][person]
        prior_masks = mask_dict["pred_masks"][person]

        pose_labels = scio.loadmat(pose_file)
        boxes = pose_labels["boxes"]
        joints = pose_labels["joints"]
        assert boxes.shape[1] == joints.shape[1]
        cost = np.zeros((boxes.shape[1], prior_masks.shape[0]))
        for m in range(boxes.shape[1]):
            for n in range(prior_masks.shape[0]):
                cost[m, n] = 1 - box_iou(boxes[0, m][0].astype(np.float32),
                                         prior_boxes[n])
        gt_idx, prior_idx = linear_sum_assignment(cost)
        for g, p in zip(gt_idx, prior_idx):
            if cost[g, p] > iou_cost_threshold:
                continue
            db.append({"im_name": im_name, "box": boxes[0, g],
                       "joint": joints[0, g], "mask": prior_masks[p]})
    return db


class PPPDataset(LIPDataset):
    """``LIPDataset``'s sample chain over per-person PPP crops: the same
    sample dict, with 14 joints and 7 classes."""

    num_joints = 14
    flip_pairs = ()  # no left/right parsing classes

    def __init__(self, root, im_root, im_list_path, pose_anno_path,
                 parsing_anno_path, mask_path, *, crop_size=(384, 384),
                 sigma=3, pose_net_stride=4, scale_min=0.5, scale_max=1.25,
                 max_rotate_degree=40, max_center_trans=40, flip_prob=0.5,
                 is_train=True, sample=-1, inv_order=False, seed=None,
                 device_normalize=False):
        self.root = root
        self.im_root = os.path.join(root, im_root)
        self.parsing_anno_path = os.path.join(root, parsing_anno_path)
        with open(os.path.join(root, im_list_path)) as f:
            im_list = [line.strip() for line in f]
        self.db = build_ppp_db(im_list, os.path.join(root, pose_anno_path),
                               os.path.join(root, mask_path))
        if sample != -1:
            self.db = self.db[:sample] if not inv_order else self.db[-sample:]
        self.crop_size = crop_size
        self.sigma = sigma
        self.pose_net_stride = pose_net_stride
        self.scale_min = scale_min
        self.scale_max = scale_max
        self.max_rotate_degree = max_rotate_degree
        self.max_center_trans = max_center_trans
        self.flip_prob = flip_prob
        self.is_train = is_train
        self.device_normalize = device_normalize
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.db)

    def image_names(self):
        return [d["im_name"] for d in self.db]

    def __getitem__(self, index):
        item = self.db[index]
        box = item["box"].astype(np.int32)
        im = read_image(os.path.join(self.im_root, item["im_name"] + ".jpg"))
        crop = im[box[0, 1]:box[0, 3], box[0, 0]:box[0, 2], :].copy()

        parsing = read_label_png(os.path.join(self.parsing_anno_path,
                                              item["im_name"] + ".png"))
        parsing = parsing * item["mask"]
        # npp_tpu's label chain casts to uint8 after its nearest resize
        # and warp and the crop onto its canvas; those only move values,
        # so casting first gives the same labels.
        parsing = parsing[box[0, 1]:box[0, 3],
                          box[0, 0]:box[0, 2]].astype(np.uint8)

        joints_all = np.array(item["joint"])
        joints = np.zeros((joints_all.shape[0], 2))
        joints[:, 0] = joints_all[:, 0] - box[0, 0]
        joints[:, 1] = joints_all[:, 1] - box[0, 1]
        visibility = joints_all[:, 2] != 0
        center = np.array([[(box[0, 2] - box[0, 0]) / 2,
                            (box[0, 3] - box[0, 1]) / 2]])

        return self._build_sample(crop, parsing, joints, visibility, center,
                                  item["im_name"], self.flip_pairs,
                                  flip_right=PPP_RIGHT_IDX,
                                  flip_left=PPP_LEFT_IDX)


def dataset_for(layout: dict, split: str, root: str, **kw) -> PPPDataset:
    """The ``PPPDataset`` of ``split`` ('train' or 'val') under ``root``,
    with the directories and id list that ``layout`` names for it and its
    pose ``.mat`` and mask ``.npy`` directories; ``kw`` go to
    ``PPPDataset``."""
    im_root, ids, seg_root = (layout[k] for k in SPLITS[split])
    return PPPDataset(root, im_root, ids, layout["pose_root"], seg_root,
                      layout["mask_root"], **kw)
