"""Parsing-only test paths: multi-scale evaluation and palette PNG export.

Port of ``npp_tpu/core/test_seg.py``: ``testval`` runs the multi-scale
sliding-window inference over a loader of single images and accumulates
the confusion matrix on the device; ``test`` writes each image's labels
as a palette PNG (``utils/vis.py``). ``mesh`` splits each image's
windows over a grid's data axis (``multiscale.multi_scale_inference``).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from npp_tpu_torch.core.multiscale import multi_scale_inference
from npp_tpu_torch.ops.resize import resize_bilinear
from npp_tpu_torch.parallel.mesh import is_primary
from npp_tpu_torch.utils import metrics as M
from npp_tpu_torch.utils.vis import save_parsing_png


def make_parsing_apply_fn(model):
    """tiles (N, 3, h, w) -> the last stage's parsing logits, float32,
    upsampled to (h, w)."""
    @torch.inference_mode()
    def apply_fn(tiles):
        _, par_list = model(tiles)
        return resize_bilinear(par_list[-1][0].float(),
                               (tiles.shape[2], tiles.shape[3]),
                               align_corners=False)

    return apply_fn


def _image(batch) -> torch.Tensor:
    """The loader's normalised (1, H, W, 3) image as (1, 3, H, W)."""
    image = batch["image"]
    if image.shape[0] != 1:
        raise ValueError("multi-scale inference runs one image at a time, "
                         f"got a batch of {image.shape[0]}")
    return image.permute(0, 3, 1, 2).float()


@torch.inference_mode()
def testval(apply_fn, loader, *, num_classes: int,
            scales=(0.5, 0.75, 1.0, 1.25, 1.5), flip: bool = True,
            crop_size=(384, 384), ignore: int = 255, mesh=None) -> dict:
    """Multi-scale parsing evaluation over a loader of single images;
    returns ``seg_metrics`` of the summed confusion matrix (also as
    ``cm``), fetched once at the end."""
    cm = None
    for batch in loader:
        pred = multi_scale_inference(apply_fn, _image(batch),
                                     num_classes=num_classes,
                                     crop_size=crop_size, scales=scales,
                                     flip=flip, mesh=mesh)
        c = M.confusion_matrix(batch["par"], pred.argmax(dim=1),
                               num_classes, ignore)
        cm = c if cm is None else cm + c
    cm = (np.zeros((num_classes, num_classes)) if cm is None
          else cm.cpu().numpy().astype(np.float64))
    return {**M.seg_metrics(cm), "cm": cm}


@torch.inference_mode()
def test(apply_fn, loader, out_dir: str, *, num_classes: int,
         scales=(1.0,), flip: bool = False,
         crop_size=(384, 384), mesh=None) -> list[str]:
    """Write ``<out_dir>/<name>.png`` palette parsings; returns the paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for batch in loader:
        pred = multi_scale_inference(apply_fn, _image(batch),
                                     num_classes=num_classes,
                                     crop_size=crop_size, scales=scales,
                                     flip=flip, mesh=mesh)
        labels = pred.argmax(dim=1).to(torch.uint8).cpu().numpy()
        for i, name in enumerate(batch["names"]):
            path = os.path.join(out_dir, f"{name}.png")
            if mesh is None or is_primary():  # every rank holds the labels
                save_parsing_png(labels[i], path, num_classes)
            paths.append(path)
    return paths
