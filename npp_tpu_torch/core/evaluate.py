"""Evaluation: the flip-TTA eval steps and the single-process validation
passes, for LIP and for Pascal-Person-Part (PPP).

Port of ``npp_tpu/core/evaluate.py:30-126, 219-328, 411-489``. A step
runs the direct and the flipped forward (in the model's compute dtype),
then the losses, the parsing flip fusion, argmax and the confusion matrix
in float32 on the device; the LIP step decodes the pose, the PPP step
returns the flip-fused heatmaps, which ``validate_ppp`` scores in heatmap
space. Both passes keep every result on the device inside the loop and
fetch once at the end.

Under a process group each rank evaluates its loader's shard and the
passes gather the ranks' results, as npp_tpu's multi-process pass does:
the confusion matrices (and the PPP PCK meter) are summed, the batch
losses and the predictions gathered, and the predictions put back into
dataset order by their indices with the wrap-padding duplicates dropped
(``merge_eval_shards``), their names from the dataset's table. Every rank
returns the same result; rank 0 alone writes ``pred_csv``. As in npp_tpu
(and the reference's all-reduced matrix), the summed matrix counts the
padding duplicates.

A step runs on a tensor-parallel model (``parallel/tensor.py``, a grid
without a space axis: the dry run's flip-TTA eval step,
``__graft_entry__.py:176-200``): every model rank of a data shard
evaluates the same batch and returns the same whole outputs. The passes
refuse such a model, as they refuse a spatially converted one: they
gather over every rank, and npp_tpu has no such path.

``make_eval_epoch`` / ``validate_scanned`` are npp_tpu's one-dispatch
eval (``evaluate.py:125-200, 331-400``): the stacked batches of an epoch
through the eval step, the confusion matrix summed on the device; on a
card that is one CUDA graph replay (``core/graphs.Program``), on the
CPU the step runs batch by batch. A short tail batch is scored by the
step alone, never padded (OHEM's k-th value is a whole-batch quantity).
One process only: npp_tpu's multi-process branch is not ported, and the
pass refuses a process group.

``make_eval_step(quantize="int8")`` runs both forwards with int8 dense
convs (``ops/quantize.py``) on a copy of the model whose weights are
quantized when the step is made; the losses, the decode and the metrics
stay float32. It refuses a tensor-parallel or spatially converted model.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from npp_tpu_torch.core import criterion as crit
from npp_tpu_torch.core import graphs
from npp_tpu_torch.core.inference import (FLIPPED_POSEIDX,
                                          FLIPPED_POSEIDX_PPP,
                                          decode_pose_validate,
                                          flip_parsing_fuse)
from npp_tpu_torch.ops.quantize import prepare_int8
from npp_tpu_torch.ops.resize import resize_bilinear
from npp_tpu_torch.parallel import mesh, tensor
from npp_tpu_torch.utils import metrics as M


def _parsing_pred(par_list, flip_par, labels: torch.Tensor, flip_pairs):
    """Argmax of the last stage's parsing logits at the labels' size, the
    flipped forward's fused in (its ``flip_pairs`` swapped) when given."""
    h, w = labels.shape[1], labels.shape[2]
    par = resize_bilinear(par_list[-1][0].float(), (h, w),
                          align_corners=False)
    if flip_par is not None:
        fpar = resize_bilinear(flip_par[-1][0].float(), (h, w),
                               align_corners=False)
        par = flip_parsing_fuse(par, fpar, flip_pairs)
    return torch.argmax(par, dim=1)


def _check_model(model) -> None:
    """Refuse a model whose steps would read row shards as whole images."""
    if getattr(model, "_sharding", None) is not None:
        raise ValueError("the eval step reads whole images; it does not run "
                         "on a spatially converted model (serve with "
                         "Predictor(mesh=) or test_seg.testval(mesh=))")


def _check_pass(eval_step) -> None:
    if tensor.sharding_of(getattr(eval_step, "model", None)) is not None:
        raise ValueError("validate gathers every rank's shard; it does not "
                         "run a model split over a grid with n_model > 1")


def make_eval_step(model, *, num_classes: int, class_weights,
                   flip_test: bool = True, ignore_index: int = 255,
                   ohem_thres: float = 0.9, ohem_keep: int = 131072,
                   flip_pairs=((14, 15), (16, 17), (18, 19)),
                   pose_flip_idx=None,
                   decode_hw: tuple[int, int] = (384, 384),
                   blur_sigma: float = 3.0, dark: bool = False,
                   quantize: str | None = None):
    """Returns ``step(criterion_params, batch) -> {loss, loss_pose,
    loss_par, cm (C, C), pose_pred (B, J, 3), par_pred (B, H, W)}``, with
    ``criterion_params`` = {"lamda_pose", "lamda_par"} and ``batch`` a
    rendered device batch (``data/loader.py``). ``flip_pairs`` are the
    parsing classes swapped under a flip (LIP's by default);
    ``pose_flip_idx`` remaps the joints (by default LIP's for 16 joints,
    PPP's for 14, none otherwise); the decode blurs with ``blur_sigma``
    and, with ``dark``, refines the argmax by the DARK step. ``model``
    may be split over a grid's model axis (module docstring), except
    with ``quantize="int8"``."""
    _check_model(model)
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    if quantize is not None:
        if tensor.sharding_of(model) is not None:
            raise ValueError("the int8 eval step runs an unsharded model; "
                             "this one is split over a grid's model axis")
        model = prepare_int8(copy.deepcopy(model))

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
                                     thres=ohem_thres, min_kept=ohem_keep)

        # Parsing: last stage, upsampled to label size, flip-fused, argmax.
        par_pred = _parsing_pred(par_list, flip_par if flip_test else None,
                                 batch["par"], flip_pairs)
        cm = M.confusion_matrix(batch["par"], par_pred, num_classes,
                                ignore_index)

        # Pose: last-stage heatmaps (+ flipped) -> decoded coordinates.
        pose_hm = pose_list[-1][0].float()
        flip_hm = flip_pose[-1][0].float() if flip_test else None
        n_j = pose_hm.shape[1]
        fidx = pose_flip_idx or (FLIPPED_POSEIDX if n_j == 16
                                 else FLIPPED_POSEIDX_PPP if n_j == 14
                                 else tuple(range(n_j)))
        pose_pred = decode_pose_validate(pose_hm, flip_hm,
                                         batch["crop_param"], batch["scale"],
                                         decode_hw, blur_sigma, fidx,
                                         dark=dark)
        return {"loss": loss_pose + loss_par, "loss_pose": loss_pose,
                "loss_par": loss_par, "cm": cm, "pose_pred": pose_pred,
                "par_pred": par_pred}

    step.model = model
    return step


def merge_eval_shards(preds: np.ndarray, idxs: np.ndarray,
                      names: list | None = None,
                      names_src: list | None = None
                      ) -> tuple[np.ndarray, list]:
    """``npp_tpu/core/evaluate.py:219-244``: the predictions put into
    dataset order by their indices ``idxs``, the wrap-padding duplicates
    dropped, and their names: from ``names`` (one per prediction) or else
    from ``names_src`` (the dataset's table, by index)."""
    order = np.argsort(idxs, kind="stable")
    keep = np.concatenate([[True], np.diff(idxs[order]) != 0])
    sel = order[keep]
    if names:
        merged = [names[i] for i in sel]
    elif names_src:
        merged = [names_src[i] for i in idxs[sel]]
    else:
        merged = []
    return preds[sel], merged


def _names_table(loader) -> list:
    dataset = getattr(loader, "dataset", None)
    return list(dataset.image_names()) if hasattr(dataset, "image_names") \
        else []


def validate(eval_step, criterion_params, loader, *, num_classes: int,
             pred_csv: str | None = None, gt_csv: str | None = None,
             log_fn=print) -> dict:
    """One pass over ``loader``. Returns the mean batch loss, the
    segmentation metrics of the summed confusion matrix (also returned as
    ``cm``), and the pose predictions with their image names in dataset
    order. ``pred_csv`` writes the predictions as a LIP pose CSV;
    ``gt_csv`` adds the PCKh table against that ground-truth CSV as
    ``pck`` and its average as ``pck_avg``, and logs it: of the
    predictions as a pose CSV holds them (integer pixels), so the numbers
    are the CSV protocol's. Under a process group, of every rank's shard
    (module docstring)."""
    _check_pass(eval_step)
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
    idxs = np.concatenate(all_idx) if all_idx else np.zeros(0, np.int64)
    if mesh.world_size() > 1:
        parts = mesh.all_gather_numpy((cm, losses, preds, idxs))
        cm = sum(p[0] for p in parts)
        losses, preds, idxs = (np.concatenate([p[i] for p in parts])
                               for i in (1, 2, 3))
        preds, all_names = merge_eval_shards(preds, idxs,
                                             names_src=_names_table(loader))
    elif all_idx:
        preds, all_names = merge_eval_shards(preds, idxs, all_names)
    result = {"loss": float(losses.mean()) if losses.size else float("nan"),
              **M.seg_metrics(cm)}
    result.update(cm=cm, pose_preds=preds, names=all_names)
    if pred_csv is not None and all_names and mesh.is_primary():
        M.save_pose_csv(all_names, preds, pred_csv)
    if gt_csv is not None and all_names:
        pck = M.pckh_against_csv(gt_csv, M.as_pose_csv_reads(preds),
                                 eval_num=len(all_names))
        result["pck"] = pck
        result["pck_avg"] = float(pck[-1][-1])
        log_fn(M.pckh_table(pck[-1]))
    return result


class _EvalEpoch:
    """``make_eval_epoch``'s program: ``__call__(criterion_params,
    stacked)`` runs the epoch, ``step`` is the per-batch eval step (for a
    tail batch) and ``programs`` the captured graphs, one per batch count
    and shape."""

    def __init__(self, step):
        self.step = step
        self.programs: dict = {}

    def _body(self, inputs: dict, n: int) -> dict:
        crit_params = {k[5:]: v for k, v in inputs.items()
                       if k.startswith("crit/")}
        cm, ys = None, {"loss": [], "pose_pred": [], "par_pred": []}
        for i in range(n):
            out = self.step(crit_params, {k: v[i] for k, v in inputs.items()
                                          if not k.startswith("crit/")})
            cm = out["cm"] if cm is None else cm + out["cm"]
            for k, v in ys.items():
                v.append(out[k])
        return {"cm": cm, **{k: torch.stack(v) for k, v in ys.items()}}

    def __call__(self, criterion_params: dict, stacked: dict) -> dict:
        """{cm (C, C) summed, loss (N,), pose_pred (N, B, J, 3), par_pred
        (N, B, H, W)} of N stacked batches."""
        n = stacked["image"].shape[0]
        inputs = dict(stacked, **{f"crit/{k}": v
                                  for k, v in criterion_params.items()})
        if stacked["image"].device.type != "cuda":
            return self._body(inputs, n)
        key = tuple((k, tuple(v.shape), v.dtype)
                    for k, v in sorted(inputs.items()))
        prog = self.programs.get(key)
        if prog is None:
            prog = graphs.Program(lambda x: self._body(x, n), inputs,
                                  warmup=lambda x: self._body(x, 1))
            self.programs[key] = prog
        return {k: v.clone() for k, v in prog(inputs).items()}


def make_eval_epoch(model, **kw) -> _EvalEpoch:
    """The whole eval epoch as one program (npp_tpu's ``make_eval_epoch``):
    ``epoch(criterion_params, stacked)`` over batches stacked on a leading
    axis (``stack_batches``), ``make_eval_step(model, **kw)``'s step on
    each, the confusion matrix summed on the device. On a card one CUDA
    graph replay a call (captured at the first call of each batch count
    and shape, over the model's weights as they are at each replay); on
    the CPU the step batch by batch. ``epoch.step`` scores a tail batch."""
    return _EvalEpoch(make_eval_step(model, **kw))


def stack_batches(batches: list[dict]):
    """(stacked, names, dataset indices, tail) of a pass's loader batches:
    the device tensors stacked on a new leading axis (``graphs.stack``),
    a short last batch split off as ``tail`` (None if there is none) and
    never padded, the names and indices on the host in loader order (the
    tail's last). ``stacked`` is None when the tail is the only batch."""
    if not batches:
        raise ValueError("stack_batches: no batches")
    keys = [k for k in batches[0] if k not in ("names", "index")]
    lead = {k: max(b[k].shape[0] for b in batches) for k in keys}
    tail = None
    if any(batches[-1][k].shape[0] != lead[k] for k in keys):
        tail, batches = batches[-1], batches[:-1]
    for k in keys:
        shapes = {tuple(b[k].shape) for b in batches}
        if len(shapes) > 1:
            raise ValueError(
                f"stack_batches needs shape-uniform batches (apart from one "
                f"short tail batch at the end); key {k!r} has shapes "
                f"{sorted(shapes)}")
    out = ({k: graphs.stack([b[k] for b in batches]) for k in keys}
           if batches else None)
    names, idxs = [], []
    for b in batches + ([tail] if tail is not None else []):
        names.extend(b.get("names", []))
        if b.get("index") is not None:
            idxs.append(np.asarray(b["index"]))
    return out, names, (np.concatenate(idxs) if idxs else None), tail


def validate_scanned(eval_epoch: _EvalEpoch, criterion_params, loader, *,
                     num_classes: int, pred_csv: str | None = None,
                     gt_csv: str | None = None, log_fn=print) -> dict:
    """``validate`` in one dispatch (npp_tpu's ``validate_scanned``): the
    loader's batches stacked (``stack_batches``; best with a
    ``cache_on_device`` loader) and run by ``eval_epoch``
    (``make_eval_epoch``), a short tail batch by ``eval_epoch.step``. The
    same result as ``validate``. One process only."""
    _check_pass(eval_epoch.step)
    graphs.one_process("validate_scanned",
                       "npp_tpu's multi-process validate_scanned")
    stacked, names, idxs, tail = stack_batches(list(loader))
    if stacked is not None:
        out = eval_epoch(criterion_params, stacked)
        cm = out["cm"].cpu().numpy().astype(np.float64)
        losses = out["loss"].cpu().numpy().astype(np.float64)
        preds = out["pose_pred"].cpu().numpy()
        preds = preds.reshape((-1,) + preds.shape[2:])
    else:
        cm = np.zeros((num_classes, num_classes), np.float64)
        losses = np.zeros((0,), np.float64)
        preds = None
    if tail is not None:
        tail_in = {k: v for k, v in tail.items()
                   if k not in ("names", "index")}
        log_fn(f"validate_scanned: short tail batch of "
               f"{tail_in['image'].shape[0]} sample(s) scored in a separate "
               f"exact step (not padded/dropped)")
        tout = eval_epoch.step(criterion_params, tail_in)
        cm = cm + tout["cm"].cpu().numpy().astype(np.float64)
        losses = np.concatenate(
            [losses, [float(tout["loss"].cpu().double())]])
        tpred = tout["pose_pred"].cpu().numpy()
        preds = tpred if preds is None else np.concatenate([preds, tpred])
    if idxs is not None:
        preds, names = merge_eval_shards(preds, idxs, names)
    result = {"loss": float(losses.mean()) if losses.size else float("nan"),
              **M.seg_metrics(cm)}
    result.update(cm=cm, pose_preds=preds, names=names)
    if pred_csv is not None and names:
        M.save_pose_csv(names, preds, pred_csv)
    if gt_csv is not None and names:
        pck = M.pckh_against_csv(gt_csv, M.as_pose_csv_reads(preds),
                                 eval_num=len(names))
        result["pck"] = pck
        result["pck_avg"] = float(pck[-1][-1])
        log_fn(M.pckh_table(pck[-1]))
    return result


def make_ppp_eval_step(model, *, num_classes: int, class_weights,
                       flip_test: bool = True, ignore_index: int = 255,
                       ohem_thres: float = 0.9, ohem_keep: int = 131072):
    """The PPP eval step: ``step(criterion_params, batch) -> {loss, cm
    (C, C), pose_hm (B, J, h, w), par_pred (B, H, W)}``. Parsing as in
    ``make_eval_step`` with no class pairs to swap; the pose is scored in
    heatmap space, so the step returns the last stage's heatmaps, with the
    flipped forward's averaged in after ``FLIPPED_POSEIDX_PPP`` and a
    horizontal unflip. npp_tpu keeps that unflip where the reference
    averaged mirror-image maps (PARITY.md, ``function_ppp.py`` row)."""
    _check_model(model)

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
                                     thres=ohem_thres, min_kept=ohem_keep)
        par_pred = _parsing_pred(par_list, flip_par if flip_test else None,
                                 batch["par"], ())
        cm = M.confusion_matrix(batch["par"], par_pred, num_classes,
                                ignore_index)
        hm = pose_list[-1][0].float()
        if flip_test:
            perm = torch.as_tensor(FLIPPED_POSEIDX_PPP, device=hm.device)
            fl = flip_pose[-1][0].float().index_select(1, perm)
            hm = 0.5 * (hm + fl.flip(3))
        return {"loss": loss_pose + loss_par, "cm": cm, "pose_hm": hm,
                "par_pred": par_pred}

    step.model = model
    return step


def validate_ppp(eval_step, criterion_params, loader, *, num_classes: int,
                 num_joints: int = 14, log_fn=print) -> dict:
    """One PPP pass over ``loader``: the mean batch loss, the segmentation
    metrics of the summed confusion matrix (also returned as ``cm``), and
    the heatmap PCK: each batch's ``heatmap_pck_accuracy`` of the fused
    heatmaps against the targets, averaged over the batches with each
    weighted by its count of scoring joints (``MulAverageMeter``), in
    percent as ``pck`` ((J + 1,), the average first) and ``pck_avg``; the
    PPP PCK table is logged. Each batch's maps are fetched as contiguous
    NCHW arrays, so the argmax runs over each map's row-major (h * w)
    order and ties go to the first maximum; the losses and the confusion
    matrix are fetched once after the loop. Under a process group the
    matrices and the meters are summed over the ranks and the losses
    gathered."""
    _check_pass(eval_step)
    cm_dev = None
    losses_dev = []
    acc = M.MulAverageMeter(num_joints + 1)
    for batch in loader:
        out = eval_step(criterion_params, batch)
        cm_dev = out["cm"] if cm_dev is None else cm_dev + out["cm"]
        losses_dev.append(out["loss"])
        hm = out["pose_hm"].float().contiguous().cpu().numpy()
        gt = batch["pose"].float().contiguous().cpu().numpy()
        acc1, _, cnt, _ = M.heatmap_pck_accuracy(hm, gt)
        acc.update(acc1, max(cnt, 1))
    cm = (cm_dev.cpu().numpy().astype(np.float64) if cm_dev is not None
          else np.zeros((num_classes, num_classes), np.float64))
    losses = (torch.stack(losses_dev).cpu().numpy().astype(np.float64)
              if losses_dev else np.zeros((0,), np.float64))
    if mesh.world_size() > 1:
        parts = mesh.all_gather_numpy((cm, losses, acc.sum, acc.count))
        cm = sum(p[0] for p in parts)
        losses = np.concatenate([p[1] for p in parts])
        acc.sum = sum(p[2] for p in parts)
        acc.count = sum(p[3] for p in parts)
    pck = acc.val() * 100
    log_fn(M.ppp_pck_table(pck))
    return {"loss": float(losses.mean()) if losses.size else float("nan"),
            **M.seg_metrics(cm), "cm": cm, "pck": pck,
            "pck_avg": float(pck[0])}
