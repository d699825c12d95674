"""Evaluation: the flip-TTA eval step and the single-process ``validate``.

Port of ``npp_tpu/core/evaluate.py:30-126, 247-328``. The step runs the
direct and the flipped forward (in the model's compute dtype), then the
losses, the parsing flip fusion, argmax, the confusion matrix and the
pose decode, all in float32 on the device. ``validate`` keeps every
result on the device inside the loop and fetches once at the end.
"""
from __future__ import annotations

import numpy as np
import torch

from npp_tpu_torch.core import criterion as crit
from npp_tpu_torch.core.inference import (FLIPPED_POSEIDX,
                                          FLIPPED_POSEIDX_PPP,
                                          decode_pose_validate,
                                          flip_parsing_fuse)
from npp_tpu_torch.ops.resize import resize_bilinear
from npp_tpu_torch.utils import metrics as M


def make_eval_step(model, *, num_classes: int, class_weights,
                   flip_test: bool = True, ignore_index: int = 255,
                   ohem_keep: int = 131072,
                   decode_hw: tuple[int, int] = (384, 384)):
    """Returns ``step(criterion_params, batch) -> {loss, loss_pose,
    loss_par, cm (C, C), pose_pred (B, J, 3), par_pred (B, H, W)}``, with
    ``criterion_params`` = {"lamda_pose", "lamda_par"} and ``batch`` a
    rendered device batch (``data/loader.py``). The flip pairs are LIP's;
    the decode blurs with sigma 3."""

    @torch.inference_mode()
    def step(criterion_params, batch):
        image = batch["image"]
        pose_list, par_list = model(image)
        if flip_test:
            flip_pose, flip_par = model(image.flip(3))
        loss_pose = crit.pose_loss(pose_list, batch["pose"],
                                   batch["pose_aux"],
                                   criterion_params["lamda_pose"])
        loss_par = crit.parsing_loss(par_list, batch["par"], batch["edge"],
                                     criterion_params["lamda_par"],
                                     class_weights=class_weights,
                                     ignore_index=ignore_index,
                                     min_kept=ohem_keep)

        # Parsing: last stage, upsampled to label size, flip-fused, argmax.
        h, w = batch["par"].shape[1], batch["par"].shape[2]
        par = resize_bilinear(par_list[-1][0].float(), (h, w),
                              align_corners=False)
        if flip_test:
            fpar = resize_bilinear(flip_par[-1][0].float(), (h, w),
                                   align_corners=False)
            par = flip_parsing_fuse(par, fpar)
        par_pred = torch.argmax(par, dim=1)
        cm = M.confusion_matrix(batch["par"], par_pred, num_classes,
                                ignore_index)

        # Pose: last-stage heatmaps (+ flipped) -> decoded coordinates.
        pose_hm = pose_list[-1][0].float()
        flip_hm = flip_pose[-1][0].float() if flip_test else None
        n_j = pose_hm.shape[1]
        fidx = (FLIPPED_POSEIDX if n_j == 16 else FLIPPED_POSEIDX_PPP
                if n_j == 14 else tuple(range(n_j)))
        pose_pred = decode_pose_validate(pose_hm, flip_hm,
                                         batch["crop_param"], batch["scale"],
                                         decode_hw, flip_idx=fidx)
        return {"loss": loss_pose + loss_par, "loss_pose": loss_pose,
                "loss_par": loss_par, "cm": cm, "pose_pred": pose_pred,
                "par_pred": par_pred}

    return step


def validate(eval_step, criterion_params, loader, *, num_classes: int,
             pred_csv: str | None = None, gt_csv: str | None = None,
             log_fn=print) -> dict:
    """One pass over ``loader``. Returns the mean batch loss, the
    segmentation metrics of the summed confusion matrix (also returned as
    ``cm``), and the pose predictions with their image names in dataset
    order. ``pred_csv`` writes the predictions as a LIP pose CSV; with
    ``gt_csv`` too, the PCKh table against it is added as ``pck`` and its
    average as ``pck_avg``, and logged."""
    cm_dev = None
    losses_dev, all_preds, all_names, all_idx = [], [], [], []
    for batch in loader:
        out = eval_step(criterion_params, batch)
        cm_dev = out["cm"] if cm_dev is None else cm_dev + out["cm"]
        losses_dev.append(out["loss"])
        all_preds.append(out["pose_pred"])
        all_names.extend(batch["names"])
        all_idx.append(np.asarray(batch["index"]))
    # The one fetch of the pass.
    cm = (cm_dev.cpu().numpy().astype(np.float64) if cm_dev is not None
          else np.zeros((num_classes, num_classes), np.float64))
    losses = (torch.stack(losses_dev).cpu().numpy().astype(np.float64)
              if losses_dev else np.zeros((0,), np.float64))
    preds = (torch.cat(all_preds).cpu().numpy() if all_preds
             else np.zeros((0, 16, 3), np.float32))
    if all_idx:
        order = np.argsort(np.concatenate(all_idx), kind="stable")
        preds = preds[order]
        all_names = [all_names[i] for i in order]
    result = {"loss": float(losses.mean()) if losses.size else float("nan"),
              **M.seg_metrics(cm)}
    result.update(cm=cm, pose_preds=preds, names=all_names)
    if pred_csv is not None and all_names:
        M.save_pose_csv(all_names, preds, pred_csv)
        if gt_csv is not None:
            pck = M.calc_pck_lip(gt_csv, pred_csv, eval_num=len(all_names))
            result["pck"] = pck
            result["pck_avg"] = float(pck[-1][-1])
            log_fn(M.pckh_table(pck[-1]))
    return result
