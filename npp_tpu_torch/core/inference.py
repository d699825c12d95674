"""Heatmap decoding and flip fusion on the device (NCHW).

Port of ``npp_tpu/core/inference.py:32-203, 265-277``: argmax decode,
the scipy-compatible Gaussian blur, the validate-time pose decode with
flip fusion, and the parsing flip fusion. The quarter-pixel offset and
the DARK decode are not ported: the eval path runs neither.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from npp_tpu_torch.ops.resize import resize_bilinear

# Pose stream left/right remap under horizontal flip: LIP 16 joints and
# PPP 14 joints (npp_tpu/core/inference.py:28-29).
FLIPPED_POSEIDX = (0, 1, 5, 6, 7, 2, 3, 4, 11, 12, 13, 8, 9, 10, 14, 15)
FLIPPED_POSEIDX_PPP = (0, 1, 8, 9, 10, 11, 12, 13, 2, 3, 4, 5, 6, 7)


def get_max_preds(batch_heatmaps: torch.Tensor):
    """Argmax decode of (B, J, H, W) heatmaps. Returns preds (B, J, 2) in
    (x, y) and maxvals (B, J, 1); ties go to the first maximum in
    row-major order, and predictions with a non-positive maxval are
    zeroed."""
    b, j, h, w = batch_heatmaps.shape
    flat = batch_heatmaps.reshape(b, j, h * w)
    maxvals = flat.amax(dim=2)
    idx = torch.argmax(flat, dim=2)  # the first maximum on ties
    x = (idx % w).float()
    y = torch.floor(idx.float() / w)
    preds = torch.stack([x, y], dim=-1)
    mask = (maxvals[..., None] > 0.0).float()
    return preds * mask, maxvals[..., None]


@functools.lru_cache(maxsize=None)
def _gauss_kernel(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """scipy.ndimage's 1-D Gaussian kernel (normalised, radius
    int(truncate * sigma + 0.5))."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _symmetric_index(n: int, r: int, device) -> torch.Tensor:
    """Source index of numpy/scipy 'symmetric' padding by ``r`` on each
    side of an ``n``-long axis (the edge sample is repeated; torch's
    'reflect' mode would skip it)."""
    i = torch.arange(-r, n + r, device=device) % (2 * n)
    return torch.where(i < n, i, 2 * n - 1 - i)


def gaussian_blur(x: torch.Tensor, sigma: float,
                  truncate: float = 4.0) -> torch.Tensor:
    """Separable Gaussian blur of (B, C, H, W) maps with scipy's 'reflect'
    (= symmetric) boundary, as ``gaussian_filter(heatmap, sigma)``."""
    k = torch.as_tensor(_gauss_kernel(float(sigma), truncate),
                        device=x.device)
    r = (k.shape[0] - 1) // 2
    c, h, w = x.shape[1], x.shape[2], x.shape[3]
    x = x.index_select(2, _symmetric_index(h, r, x.device))
    x = x.index_select(3, _symmetric_index(w, r, x.device))
    x = F.conv2d(x, k.reshape(1, 1, -1, 1).repeat(c, 1, 1, 1), groups=c)
    return F.conv2d(x, k.reshape(1, 1, 1, -1).repeat(c, 1, 1, 1), groups=c)


def decode_pose_validate(pred_pose: torch.Tensor,
                         flip_pred_pose: torch.Tensor | None,
                         crop_param: torch.Tensor, base_scale: torch.Tensor,
                         out_hw: tuple[int, int] = (384, 384),
                         blur_sigma: float = 3.0,
                         flip_idx: tuple = FLIPPED_POSEIDX) -> torch.Tensor:
    """Validate-time pose decode. ``pred_pose``: (B, J, h, w) raw heatmaps;
    ``flip_pred_pose``: the flipped image's heatmaps or None;
    ``crop_param``: (B, 1, 8); ``base_scale``: (B,). Returns (B, J, 3):
    x, y in original image coordinates and the peak score."""
    hm = resize_bilinear(pred_pose.float(), out_hw, align_corners=False)
    if flip_pred_pose is not None:
        fl = flip_pred_pose.float()
        perm = torch.as_tensor(flip_idx[:fl.shape[1]], device=fl.device)
        fl = resize_bilinear(fl.index_select(1, perm), out_hw,
                             align_corners=False)
        hm = 0.5 * (hm + fl.flip(3))  # unflip horizontally
    return decode_pose_fused(hm, crop_param, base_scale,
                             blur_sigma=blur_sigma)


def decode_pose_fused(hm: torch.Tensor, crop_param: torch.Tensor,
                      base_scale: torch.Tensor, *,
                      blur_sigma: float = 3.0) -> torch.Tensor:
    """Blur -> argmax -> inverse crop/scale map of (B, J, ch, cw) heatmaps
    already fused at crop resolution: p_src = (p - store_start +
    crop_start) / scale."""
    hm = gaussian_blur(hm, blur_sigma)
    preds, maxvals = get_max_preds(hm)
    cp = crop_param[:, 0, :].float()
    dx = cp[:, 0] - cp[:, 2]
    dy = cp[:, 1] - cp[:, 3]
    s = base_scale.float()
    x = (preds[..., 0] + dx[:, None]) / s[:, None]
    y = (preds[..., 1] + dy[:, None]) / s[:, None]
    return torch.stack([x, y, maxvals[..., 0]], dim=-1)


def flip_parsing_fuse(pred_par: torch.Tensor, flip_pred_par: torch.Tensor,
                      flip_pairs=((14, 15), (16, 17), (18, 19))
                      ) -> torch.Tensor:
    """Average direct and flipped (B, C, H, W) parsing logits, with the
    flipped ones' left/right channels swapped and unflipped."""
    c = pred_par.shape[1]
    perm = list(range(c))
    for a, b in flip_pairs:
        perm[a], perm[b] = perm[b], perm[a]
    fl = flip_pred_par.index_select(
        1, torch.as_tensor(perm, device=flip_pred_par.device))
    return 0.5 * (pred_par + fl.flip(3))
