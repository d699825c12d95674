"""Offline OKS mAP of Pascal-Person-Part pose predictions.

Port of ``tools/eval_ppp_map.py``: reads each listed image's ground-truth
``<gt-dir>/<name>.mat`` (``joints``: a 1 x P cell of (14, 3) arrays,
``boxes``: a 1 x P cell of (1, 4) arrays) with ``scipy.io.loadmat``,
takes an ``.npy`` dict of per-image predictions (image name -> list of
(14, 2) arrays, one per person, relative to the person's box corner),
and prints the per-joint AP and the mAP over the OKS thresholds
0.5:0.05:0.95 (``utils/metrics.oks_map``). Listed images without a
``.mat`` are skipped.

Usage:
  python -m npp_tpu_torch.tools.eval_ppp_map \\
      --val-list data/pascal_data/val_id.txt \\
      --gt-dir data/pascal_data/PersonJoints --preds pose_pred.npy
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import scipy.io as scio

from npp_tpu_torch.utils.metrics import oks_map

JOINT_NAMES = ("fore", "neck", "Lsho", "Lelb", "Lwri", "Lhip", "Lkne",
               "Lank", "Rsho", "Relb", "Rwri", "Rhip", "Rkne", "Rank")


def load_gt(gt_dir: str, im_names) -> dict:
    """name -> (list of (J, 3) joints, list of (1, 4) boxes) for each
    listed image that has a ``.mat``."""
    gts = {}
    for name in im_names:
        path = os.path.join(gt_dir, name + ".mat")
        if not os.path.isfile(path):
            continue
        m = scio.loadmat(path)
        joints = [m["joints"][0, i] for i in range(m["joints"].shape[1])]
        boxes = [m["boxes"][0, i] for i in range(m["boxes"].shape[1])]
        gts[name] = (joints, boxes)
    return gts


def main(argv=None) -> np.ndarray:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--val-list", required=True,
                   help="text file of image names, one per line")
    p.add_argument("--gt-dir", required=True,
                   help="directory of the ground-truth <name>.mat files")
    p.add_argument("--preds", required=True,
                   help=".npy dict im_name -> list of (J,2) predictions")
    args = p.parse_args(argv)

    with open(args.val_list) as f:
        im_names = [line.strip() for line in f]
    preds = np.load(args.preds, allow_pickle=True).item()
    ap = oks_map(preds, load_gt(args.gt_dir, im_names))
    for name, v in zip(JOINT_NAMES, ap[:-1]):
        print(f"{name:6s}: {v:.4f}")
    print(f"mAP (OKS 0.5:0.05:0.95): {ap[-1]:.4f}")
    return ap


if __name__ == "__main__":
    main()
