"""Targets: the host label chain and host targets, and on-device pose
heatmaps and edge maps.

Port of ``npp_tpu/data/targets.py``. ``gen_parsing_target`` runs the
image's scale / rotate / crop / flip chain on the parsing labels on the
host (``data/imgproc.py``, cv2's nearest rules, equal to npp_tpu's).
The loaders render heatmaps and edges on the device:
``ops/heatmaps.render_heatmaps`` is the hand-written CUDA kernel on a
CUDA tensor and its plain PyTorch version on a CPU tensor. The host
numpy targets (``gen_pose_target``, ``generate_edge`` with cv2's
dilation rule, and the part-affinity-field target, which is off by
default and on no path) complete the module.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from npp_tpu_torch.data import imgproc
from npp_tpu_torch.ops.heatmaps import render_heatmaps

_TRUNC = 4.6052  # the exponent past which a Gaussian map is 0

# LIP's 16-joint limb segments (joint pairs) of the PAF target.
LIP_BODY_PARTS = ((1, 0), (1, 2), (2, 3), (3, 4), (1, 5), (5, 6), (6, 7),
                  (1, 14), (14, 15), (15, 8), (8, 9), (9, 10), (15, 11),
                  (11, 12), (12, 13))


def _gaussian_grid(joints: np.ndarray, visibility: np.ndarray, stride: int,
                   grid_x: int, grid_y: int, sigma: float) -> np.ndarray:
    """(J, grid_y, grid_x) float64 maps: exp(-d^2 / 2 sigma^2) at the
    cell centres stride/2 - 0.5 + i * stride, 0 past the cut-off, times
    the visibility."""
    start = stride / 2.0 - 0.5
    xs = start + np.arange(grid_x, dtype=np.float64) * stride
    ys = start + np.arange(grid_y, dtype=np.float64) * stride
    dx2 = (xs[None, None, :] - joints[:, 0, None, None]) ** 2
    dy2 = (ys[None, :, None] - joints[:, 1, None, None]) ** 2
    exponent = (dx2 + dy2) / (2.0 * sigma * sigma)
    maps = np.where(exponent > _TRUNC, 0.0, np.exp(-exponent))
    maps = np.minimum(maps, 1.0)
    maps *= visibility[:, None, None].astype(np.float64)
    return maps


def gen_pose_target(joints: np.ndarray, visibility: np.ndarray,
                    stride: int = 8, grid_x: int = 46, grid_y: int = 46,
                    sigma: float = 7, aux: bool = False):
    """npp_tpu's host ``gen_pose_target`` (``targets.py:43-65``): the
    (J+1, grid_y, grid_x) float32 maps, J Gaussians and a ``1 - max``
    background channel, and with ``aux`` the same at 2 sigma (else
    None)."""
    j = joints.shape[0]

    def render(s):
        maps = np.zeros((j + 1, grid_y, grid_x), np.float32)
        maps[:j] = _gaussian_grid(joints, visibility, stride, grid_x,
                                  grid_y, s)
        maps[j] = 1.0 - maps[:j].max(axis=0)
        return maps

    return render(sigma), (render(2 * sigma) if aux else None)


def _dilate_rect(a: np.ndarray, k: int) -> np.ndarray:
    """``cv2.dilate(a, getStructuringElement(MORPH_RECT, (k, k)))``: the
    max over a k x k window anchored at (k // 2, k // 2); pixels outside
    the image never win (cv2's default border for a dilation)."""
    lo = k // 2
    h, w = a.shape
    pad = np.full((h + k - 1, w + k - 1), -np.inf)
    pad[lo:lo + h, lo:lo + w] = a
    out = np.full(a.shape, -np.inf)
    for dy in range(k):
        for dx in range(k):
            np.maximum(out, pad[dy:dy + h, dx:dx + w], out=out)
    return out


def generate_edge(label: np.ndarray, edge_width: int = 3) -> np.ndarray:
    """npp_tpu's host ``generate_edge`` (``targets.py:99-119``): 1.0
    where the label changes towards the next row, column or diagonal
    between two non-255 pixels, dilated by an ``edge_width`` square;
    (H, W) float64."""
    h, w = label.shape
    edge = np.zeros(label.shape)
    edge_right = edge[1:h, :]
    edge_right[(label[1:h, :] != label[: h - 1, :])
               & (label[1:h, :] != 255) & (label[: h - 1, :] != 255)] = 1
    edge_up = edge[:, : w - 1]
    edge_up[(label[:, : w - 1] != label[:, 1:w])
            & (label[:, : w - 1] != 255) & (label[:, 1:w] != 255)] = 1
    edge_upright = edge[: h - 1, : w - 1]
    edge_upright[(label[: h - 1, : w - 1] != label[1:h, 1:w])
                 & (label[: h - 1, : w - 1] != 255)
                 & (label[1:h, 1:w] != 255)] = 1
    edge_bottomright = edge[: h - 1, 1:w]
    edge_bottomright[(label[: h - 1, 1:w] != label[1:h, : w - 1])
                     & (label[: h - 1, 1:w] != 255)
                     & (label[1:h, : w - 1] != 255)] = 1
    return _dilate_rect(edge, edge_width)


def get_paf_by_hm(hm: np.ndarray, vis, body_parts=LIP_BODY_PARTS,
                  sigma_paf: float = 5, variable_width: bool = False
                  ) -> np.ndarray:
    """Part-affinity fields from the heatmaps' argmax keypoints
    (npp_tpu's ``targets.py:205-240``). ``hm``: (J+1, H, W). Returns
    (2 * len(body_parts), H, W) float64."""
    size = hm.shape[-2:]
    n_parts = len(body_parts)
    out_pafs = np.zeros((n_parts, 2, size[0], size[1]))
    n_person = np.zeros((n_parts, size[0], size[1]))
    keypoints = np.zeros((hm.shape[0] - 1, 2))
    for i in range(hm.shape[0] - 1):
        pos = np.unravel_index(hm[i].argmax(), size)
        keypoints[i] = (pos[1], pos[0])
    x, y = np.meshgrid(np.arange(size[1]), np.arange(size[0]))
    for i, (a, b) in enumerate(body_parts):
        if not (vis[a] and vis[b]):
            continue
        seg = keypoints[b] - keypoints[a]
        length = np.linalg.norm(seg)
        if length <= 1e-2:
            continue
        sigma = sigma_paf * length * 0.025 if variable_width else sigma_paf
        v = seg / length
        v_per = (v[1], -v[0])
        d_along = v[0] * (x - keypoints[a][0]) + v[1] * (y - keypoints[a][1])
        d_perp = np.abs(v_per[0] * (x - keypoints[a][0])
                        + v_per[1] * (y - keypoints[a][1]))
        mask = ((d_along >= 0) & (d_along <= length)
                & (d_perp <= sigma)).astype("float32")
        out_pafs[i, 0] += mask * v[0]
        out_pafs[i, 1] += mask * v[1]
        n_person[i] += mask
    out_pafs = out_pafs / (n_person[:, None] + 1e-8)
    return out_pafs.reshape(n_parts * 2, size[0], size[1])


def gen_pose_target_paf(joints, visibility, body_parts=LIP_BODY_PARTS,
                        stride: int = 8, grid_x: int = 46, grid_y: int = 46,
                        sigma: float = 7, aux: bool = False):
    """npp_tpu's ``gen_pose_target_paf`` (``targets.py:243-254``): the
    Gaussian maps and, with ``aux``, the PAF fields plus their sum as a
    last channel (else None)."""
    maps, _ = gen_pose_target(joints, visibility, stride, grid_x, grid_y,
                              sigma, aux=False)
    if not aux:
        return maps, None
    paf = get_paf_by_hm(maps, visibility, body_parts, sigma_paf=2.5)
    paf = np.concatenate([paf, paf.sum(axis=0, keepdims=True)], axis=0)
    return maps, paf


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
