"""Bilinear / nearest resize with the reference's semantics (NCHW).

Port of ``npp_tpu/ops/resize.py:54-98``. The JAX package writes the
bilinear resize as two interpolation-matrix contractions for the TPU's
matrix unit; here it is ``F.interpolate``, which computes the same
source grid. The output size is always passed explicitly as
``floor(in * scale)`` (``npp_tpu/ops/resize.py:75-85``): torch's own
``scale_factor=`` path with ``align_corners=True`` may derive the source
grid from the scale instead of from the sizes.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def scale_output_size(size: int, scale: float) -> int:
    """Output size as ``F.interpolate`` computes it: floor(in * scale)."""
    return int(math.floor(size * scale))


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int], *,
                    align_corners: bool) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor to ``out_hw`` = (H', W')."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=align_corners)


def resize_scale(x: torch.Tensor, scale: float, *,
                 align_corners: bool = True, space=None) -> torch.Tensor:
    """``F.interpolate(x, scale_factor=scale, mode='bilinear')`` with the
    output size made explicit; with a ``space`` (``parallel/spatial.py``)
    of the whole image, from this rank's rows."""
    if space is not None:
        return space.resize_scale(x, scale, align_corners=align_corners)
    h = scale_output_size(x.shape[-2], scale)
    w = scale_output_size(x.shape[-1], scale)
    return resize_bilinear(x, (h, w), align_corners=align_corners)


def _nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    """Source index of torch 'nearest': floor(i * n_in / n_out)."""
    i = torch.arange(n_out, dtype=torch.float64, device=device)
    return torch.floor(i * n_in / n_out).clamp(0, n_in - 1).long()


def resize_nearest(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize of an NCHW tensor (floor indexing)."""
    h_in, w_in = x.shape[-2], x.shape[-1]
    if (h_in, w_in) == tuple(out_hw):
        return x
    x = x.index_select(-2, _nearest_index(h_in, out_hw[0], x.device))
    return x.index_select(-1, _nearest_index(w_in, out_hw[1], x.device))
