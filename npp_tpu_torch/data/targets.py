"""Targets: the host label chain, and on-device pose heatmaps and edge maps.

Port of ``npp_tpu/data/targets.py:66-196``. ``gen_parsing_target`` runs
the image's scale / rotate / crop / flip chain on the parsing labels on
the host (``data/imgproc.py``, cv2's nearest rules, equal to npp_tpu's).
Heatmaps come from ``ops/heatmaps.render_heatmaps``: the hand-written
CUDA kernel on a CUDA tensor, its plain PyTorch version on a CPU tensor.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from npp_tpu_torch.data import imgproc
from npp_tpu_torch.ops.heatmaps import render_heatmaps


def gen_parsing_target(parsing_anno: np.ndarray, scale_param=None,
                       rotate_param=None, crop_param=None, flip_param=None,
                       stride: int = 8,
                       flip_pairs=((15, 14), (17, 16), (19, 18))
                       ) -> np.ndarray:
    """npp_tpu's ``gen_parsing_target`` (``targets.py:159-196``): the
    image's chain on the (H, W) uint8 labels: a nearest resize by
    ``scale_param``, a nearest warp by ``rotate_param`` = [m, w, h] with
    255 outside, the crop onto 255 by ``crop_param`` = [param, w, h]
    (its canvas is (w, h), npp_tpu's order, square in every caller), the
    flip with the (right, left) class pairs swapped, and a nearest resize
    by 1 / ``stride``. ``flip_pairs=()`` is the Pascal variant."""
    t = parsing_anno.copy()
    if scale_param is not None:
        t = imgproc.resize(t, scale_param, "nearest")
    if rotate_param is not None:
        t = imgproc.warp_affine(t, rotate_param[0],
                                (int(rotate_param[1]), int(rotate_param[2])),
                                "nearest", 255)
    if crop_param is not None:
        cp = crop_param[0]
        out = np.zeros((crop_param[1], crop_param[2])) + 255
        out[cp[0, 3]:cp[0, 7], cp[0, 2]:cp[0, 6]] = \
            t[cp[0, 1]:cp[0, 5], cp[0, 0]:cp[0, 4]]
        t = out.astype(np.uint8)
    if flip_param:
        t = t[:, ::-1].copy()
        for right, left in flip_pairs:
            right_pos = t == right
            left_pos = t == left
            t[right_pos] = left
            t[left_pos] = right
    if stride != 1:
        t = imgproc.resize(t, 1.0 / stride, "nearest")
    return t


def gen_pose_target_device(joints: torch.Tensor, visibility: torch.Tensor,
                           stride: int = 4, grid_x: int = 96,
                           grid_y: int = 96, sigma: float = 3):
    """Batched heatmap rendering. ``joints``: (B, J, 2) xy in input-crop
    pixels; ``visibility``: (B, J). Returns the NCHW maps (B, J+1, grid_y,
    grid_x) at sigma and the aux maps at 2 sigma. The kernel writes NHWC,
    so the maps are NCHW views in ``channels_last`` memory format."""
    main, aux = render_heatmaps(joints, visibility, stride=stride,
                                grid_x=grid_x, grid_y=grid_y,
                                sigma=float(sigma))
    return main.permute(0, 3, 1, 2), aux.permute(0, 3, 1, 2)


def generate_edge_device(label: torch.Tensor, edge_width: int = 3,
                         ignore: int = 255) -> torch.Tensor:
    """(B, H, W) int labels -> (B, H, W) float edge mask: label changes in
    4 directions between two non-ignored pixels, dilated by an
    ``edge_width`` square (a stride-1 max pool with 'same' padding)."""
    lab = label.to(torch.int32)
    valid = lab != ignore

    def diff(a_sl, b_sl, pad):
        a, b = lab[:, a_sl[0], a_sl[1]], lab[:, b_sl[0], b_sl[1]]
        va, vb = valid[:, a_sl[0], a_sl[1]], valid[:, b_sl[0], b_sl[1]]
        d = ((a != b) & va & vb).to(torch.float32)
        return F.pad(d, pad)  # (left, right, top, bottom)

    sl = slice(None)
    e = diff((slice(1, None), sl), (slice(None, -1), sl), (0, 0, 1, 0))
    e = torch.maximum(e, diff((sl, slice(None, -1)), (sl, slice(1, None)),
                              (0, 1, 0, 0)))
    e = torch.maximum(e, diff((slice(None, -1), slice(None, -1)),
                              (slice(1, None), slice(1, None)),
                              (0, 1, 0, 1)))
    e = torch.maximum(e, diff((slice(None, -1), slice(1, None)),
                              (slice(1, None), slice(None, -1)),
                              (1, 0, 0, 1)))
    p = edge_width // 2
    return F.max_pool2d(e[:, None], edge_width, 1, p)[:, 0]
