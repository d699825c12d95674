"""Heatmap decoding and flip fusion on the device (NCHW).

Port of ``npp_tpu/core/inference.py``: argmax decode, the reference's
quarter-pixel offset, the DARK sub-pixel refinement, the scipy-compatible
Gaussian blur, the validate-time pose decode with flip fusion, the
scale-list pose fusion and the parsing flip fusion.
"""
from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
import torch.nn.functional as F

from npp_tpu_torch.core.graphs import constant
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
    y = (idx // w).float()  # integer division: exact at any width
    preds = torch.stack([x, y], dim=-1)
    mask = (maxvals[..., None] > 0.0).float()
    return preds * mask, maxvals[..., None]


def _gather_at(hm: torch.Tensor, py: torch.Tensor,
               px: torch.Tensor) -> torch.Tensor:
    """``hm[b, j, py[b, j], px[b, j]]`` for (B, J, H, W) maps."""
    w = hm.shape[3]
    flat = hm.reshape(hm.shape[0], hm.shape[1], -1)
    return flat.gather(2, (py * w + px)[..., None])[..., 0]


def post_process_quarter_offset(coords: torch.Tensor,
                                batch_heatmaps: torch.Tensor) -> torch.Tensor:
    """The reference's quarter-pixel step toward the larger neighbour, per
    axis, for peaks at least two pixels inside the map. ``coords``: (B, J,
    2) in (x, y); ``batch_heatmaps``: (B, J, H, W)."""
    h, w = batch_heatmaps.shape[2], batch_heatmaps.shape[3]
    px = torch.floor(coords[..., 0] + 0.5).long()
    py = torch.floor(coords[..., 1] + 0.5).long()
    inb = (px > 1) & (px < w - 1) & (py > 1) & (py < h - 1)
    pxc, pyc = px.clamp(1, w - 2), py.clamp(1, h - 2)

    def at(dy, dx):
        return _gather_at(batch_heatmaps, pyc + dy, pxc + dx)

    diff_x = at(0, 1) - at(0, -1)
    diff_y = at(1, 0) - at(-1, 0)
    offset = torch.stack([torch.sign(diff_x), torch.sign(diff_y)], -1) * 0.25
    return coords + offset * inb[..., None].to(coords.dtype)


def post_process_dark(coords: torch.Tensor,
                      batch_heatmaps: torch.Tensor) -> torch.Tensor:
    """DARK sub-pixel refinement (Zhang et al., arXiv:1910.06278): a
    Newton step ``-H^-1 grad`` on the log of the (already blurred) map at
    the argmax. The step is taken only inside the map's border, where the
    Hessian's determinant is above 1e-12 in magnitude and where both
    components stay under one pixel."""
    h, w = batch_heatmaps.shape[2], batch_heatmaps.shape[3]
    hm = torch.log(batch_heatmaps.clamp_min(1e-10))
    px = torch.floor(coords[..., 0] + 0.5).long()
    py = torch.floor(coords[..., 1] + 0.5).long()
    inb = (px > 0) & (px < w - 1) & (py > 0) & (py < h - 1)
    pxc, pyc = px.clamp(1, w - 2), py.clamp(1, h - 2)

    def at(dy, dx):
        return _gather_at(hm, pyc + dy, pxc + dx)

    c0 = at(0, 0)
    dx = 0.5 * (at(0, 1) - at(0, -1))
    dy = 0.5 * (at(1, 0) - at(-1, 0))
    dxx = at(0, 1) - 2.0 * c0 + at(0, -1)
    dyy = at(1, 0) - 2.0 * c0 + at(-1, 0)
    dxy = 0.25 * (at(1, 1) - at(1, -1) - at(-1, 1) + at(-1, -1))
    det = dxx * dyy - dxy * dxy
    regular = det.abs() > 1e-12
    safe = torch.where(regular, det, torch.ones_like(det))
    ox = -(dyy * dx - dxy * dy) / safe
    oy = -(dxx * dy - dxy * dx) / safe
    ok = inb & regular & (ox.abs() < 1.0) & (oy.abs() < 1.0)
    offset = torch.stack([ox, oy], -1) * ok[..., None].to(coords.dtype)
    return coords + offset


@contextlib.contextmanager
def _full_fp32_convs(device: torch.device):
    """cuDNN convolutions in full float32 inside the block (PyTorch lets
    cuDNN round fp32 convs to TF32 by default, which can move a blurred
    peak); the caller's setting is restored on exit."""
    if device.type != "cuda":
        yield
        return
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


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
    k = constant(tuple(_gauss_kernel(float(sigma), truncate).tolist()),
                 torch.float32, x.device)
    r = (k.shape[0] - 1) // 2
    c, h, w = x.shape[1], x.shape[2], x.shape[3]
    x = x.index_select(2, _symmetric_index(h, r, x.device))
    x = x.index_select(3, _symmetric_index(w, r, x.device))
    with _full_fp32_convs(x.device):
        x = F.conv2d(x, k.reshape(1, 1, -1, 1).repeat(c, 1, 1, 1), groups=c)
        return F.conv2d(x, k.reshape(1, 1, 1, -1).repeat(c, 1, 1, 1),
                        groups=c)


def decode_pose_validate(pred_pose: torch.Tensor,
                         flip_pred_pose: torch.Tensor | None,
                         crop_param: torch.Tensor, base_scale: torch.Tensor,
                         out_hw: tuple[int, int] = (384, 384),
                         blur_sigma: float = 3.0,
                         flip_idx: tuple = FLIPPED_POSEIDX,
                         dark: bool = False) -> torch.Tensor:
    """Validate-time pose decode. ``pred_pose``: (B, J, h, w) raw heatmaps;
    ``flip_pred_pose``: the flipped image's heatmaps or None;
    ``crop_param``: (B, 1, 8); ``base_scale``: (B,). Returns (B, J, 3):
    x, y in original image coordinates and the peak score; ``dark`` adds
    the DARK refinement after the argmax."""
    hm = resize_bilinear(pred_pose.float(), out_hw, align_corners=False)
    if flip_pred_pose is not None:
        fl = flip_pred_pose.float()
        perm = constant(tuple(flip_idx[:fl.shape[1]]), torch.int64,
                        fl.device)
        fl = resize_bilinear(fl.index_select(1, perm), out_hw,
                             align_corners=False)
        hm = 0.5 * (hm + fl.flip(3))  # unflip horizontally
    return decode_pose_fused(hm, crop_param, base_scale,
                             blur_sigma=blur_sigma, dark=dark)


def decode_pose_fused(hm: torch.Tensor, crop_param: torch.Tensor,
                      base_scale: torch.Tensor, *, blur_sigma: float = 3.0,
                      dark: bool = False) -> torch.Tensor:
    """Blur -> argmax (-> DARK) -> inverse crop/scale map of (B, J, ch, cw)
    heatmaps already fused at crop resolution: p_src = (p - store_start +
    crop_start) / scale."""
    hm = gaussian_blur(hm, blur_sigma)
    preds, maxvals = get_max_preds(hm)
    if dark:
        preds = post_process_dark(preds, hm)
    cp = crop_param[:, 0, :].float()
    dx = cp[:, 0] - cp[:, 2]
    dy = cp[:, 1] - cp[:, 3]
    s = base_scale.float()
    x = (preds[..., 0] + dx[:, None]) / s[:, None]
    y = (preds[..., 1] + dy[:, None]) / s[:, None]
    return torch.stack([x, y, maxvals[..., 0]], dim=-1)


def fuse_multiscale_pose(hm: torch.Tensor, crop_params: torch.Tensor,
                         scale_mults: tuple, base_index: int) -> torch.Tensor:
    """Scale-list pose TTA: resample each scale's heatmaps onto the base
    scale's canvas and average. ``hm``: (S, B, J, H, W) heatmaps at crop
    resolution, one set per scale multiplier; ``crop_params``: (S, B, 1, 8)
    each scale canvas's crop params. Returns (B, J, H, W).

    Base-canvas pixel p maps to original coordinates (p + d_base) / s and
    into scale k's canvas at (p + d_base) * m_k - d_k, with d = crop_start
    - store_start and m_k the multiplier. There the maps are sampled
    bilinearly (4 taps, each tap outside the map contributing 0, as
    ``map_coordinates(order=1, mode='constant')``), with the coordinates
    first clamped into the scale's valid store region; samples outside
    that region count 0. The mean divides by the number of scales."""
    s, b, j, h, w = hm.shape
    cp = crop_params[:, :, 0, :].float()                     # (S, B, 8)
    dx = cp[..., 0] - cp[..., 2]
    dy = cp[..., 1] - cp[..., 3]
    sm = torch.as_tensor(scale_mults, dtype=torch.float32,
                         device=hm.device)
    gy = torch.arange(h, dtype=torch.float32, device=hm.device)
    gx = torch.arange(w, dtype=torch.float32, device=hm.device)
    ys = ((gy[None, None, :] + dy[base_index][None, :, None])
          * sm[:, None, None] - dy[:, :, None])              # (S, B, H)
    xs = ((gx[None, None, :] + dx[base_index][None, :, None])
          * sm[:, None, None] - dx[:, :, None])              # (S, B, W)
    lo_x, hi_x = cp[..., 2, None], cp[..., 6, None] - 1.0
    lo_y, hi_y = cp[..., 3, None], cp[..., 7, None] - 1.0
    valid = (((ys >= lo_y) & (ys <= hi_y))[..., :, None]
             & ((xs >= lo_x) & (xs <= hi_x))[..., None, :])  # (S, B, H, W)
    ys = torch.minimum(torch.maximum(ys, lo_y), hi_y)
    xs = torch.minimum(torch.maximum(xs, lo_x), hi_x)
    y0f, x0f = torch.floor(ys), torch.floor(xs)
    wy1, wx1 = ys - y0f, xs - x0f
    wy0, wx0 = 1.0 - wy1, 1.0 - wx1
    y0, x0 = y0f.long(), x0f.long()
    hm = hm.float()

    def tap(yi, xi):
        """hm[s, b, :, yi[s, b, h], xi[s, b, w]], 0 where out of the map."""
        rows = yi.clamp(0, h - 1)[:, :, None, :, None].expand(s, b, j, h, w)
        cols = xi.clamp(0, w - 1)[:, :, None, None, :].expand(s, b, j, h, w)
        v = hm.gather(3, rows).gather(4, cols)
        ok = (((yi >= 0) & (yi < h))[..., :, None]
              & ((xi >= 0) & (xi < w))[..., None, :])
        return torch.where(ok[:, :, None], v, torch.zeros((), device=v.device))

    def wt(a, c):
        return (a[..., :, None] * c[..., None, :])[:, :, None]

    out = (wt(wy0, wx0) * tap(y0, x0) + wt(wy0, wx1) * tap(y0, x0 + 1)
           + wt(wy1, wx0) * tap(y0 + 1, x0) + wt(wy1, wx1) * tap(y0 + 1, x0 + 1))
    out = out * valid[:, :, None].float()
    return out.mean(dim=0)


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
        1, constant(tuple(perm), torch.int64, flip_pred_par.device))
    return 0.5 * (pred_par + fl.flip(3))
