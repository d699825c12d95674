"""Evaluation CLI: the LIP flip-TTA val protocol on the port.

Port of ``tools/eval_lip.py``. The LIP flagship configuration is built
in (``config.LIP``); ``--cfg`` takes npp_tpu's LIP experiment YAML
instead (``config.load_preset``; a PPP file is refused): L=16 cells,
C=64, one refinement stage, 20 classes, 16 joints, 384x384 crops, bf16
compute (channels_last on the card). ``--tiny`` is the small test
configuration (L=8, C=8, 128x128). Without ``--ckpt`` the weights are
random, drawn from ``--seed``; ``--ckpt`` takes a train-CLI checkpoint
directory (its ``best`` checkpoint, else the latest epoch's) or a flax
variable tree saved as ``.npz`` with '/'-joined keys
(``core/loading.load_eval_model``), and ``--genotype`` a search's
``best_genotype.json`` to build the net from. The loss lambdas are the
initial ones, as in the JAX CLI. Data: the val set of a LIP directory
(``--data-root``, by default the YAML's ``data/LIP/``; its first
``--sample`` entries, by default TRAIN.NUM_SAMPLES = 5000) or, with
``--synthetic``, 2 x ``--batch`` synthetic images, as the JAX CLI's.
``--gt-csv`` adds the PCKh table against that LIP pose CSV (of the
predictions as the LIP pose CSV holds them), and without it the
configuration's ``POSE_GT_PATH`` does where that file exists (read from
a LIP directory only); the flip is the configuration's
``TEST.FLIP_TEST``;
``--pred-csv`` writes that CSV, ``--json-out`` the metrics as JSON;
``--int8`` runs the forwards with int8 dense convs
(``make_eval_step(quantize="int8")``). ``--scanned`` (npp_tpu's flag)
evaluates the set in one dispatch: the loader keeps the rendered device
batches (``cache_on_device``), ``make_eval_epoch`` + ``validate_scanned``
run them, on the card as one CUDA graph replay (a failed capture raises),
a short tail batch by the per-batch step; with ``--int8`` the int8
kernels run inside the graph. One process only: under a process group
it is refused.
LIP only, as the JAX CLI is: it fixes LIP's class weights and flip
pairs. Under ``python -m torch.distributed.run --nproc_per_node=N`` each
rank evaluates its strided shard of the set and ``validate`` gathers the
ranks' results into dataset order; rank 0 prints them and writes
``--pred-csv`` and ``--json-out``.

Examples:
  python -m npp_tpu_torch.tools.eval_lip --data-root data/LIP \\
      --gt-csv data/LIP/pose_csv/pose_gt.csv \\
      --ckpt output/lip/augment/flagship/checkpoints
  python -m npp_tpu_torch.tools.eval_lip --cfg experiments/lip/384_384.yaml \\
      --synthetic --batch 8 --device cuda
  python -m npp_tpu_torch.tools.eval_lip --data-root data/LIP --sample 500
  python -m npp_tpu_torch.tools.eval_lip --synthetic --tiny --batch 2 \\
      --device cpu --dtype float32
  python -m npp_tpu_torch.tools.eval_lip --synthetic --scanned --int8
  python -m npp_tpu_torch.tools.eval_lip --synthetic \\
      --ckpt output/lip/augment/flagship/checkpoints \\
      --genotype best_genotype.json --pred-csv pred.csv --json-out m.json
"""
from __future__ import annotations

import argparse
import json

import torch

from npp_tpu_torch.config import IGNORE, LIP, SIGMA
from npp_tpu_torch.core import evaluate as E
from npp_tpu_torch.core.criterion import init_criterion_params
from npp_tpu_torch.core.loading import load_eval_model
from npp_tpu_torch.data.lip import dataset_for
from npp_tpu_torch.data.loader import DataLoader, make_target_renderer
from npp_tpu_torch.data.synthetic import SyntheticDataset
from npp_tpu_torch.parallel import mesh
from npp_tpu_torch.tools.augment_lip import (add_cfg_argument, data_source,
                                             pose_gt_csv, refuse_under_group,
                                             resolve_preset, start_ranks)
from npp_tpu_torch.utils.metrics import per_class_table

NUM_CLASSES, NUM_JOINTS = LIP.num_classes, LIP.num_joints
FLAGSHIP = LIP.train_config()[0]
TINY = LIP.train_config(tiny=True)[0]


def evaluate(model, ds, *, batch: int, crop_size, device,
             pred_csv: str | None = None, gt_csv: str | None = None,
             quantize: str | None = None, flip_test: bool = True,
             scanned: bool = False) -> dict:
    """Flip-TTA validation of ``model`` over the dataset ``ds`` (uint8
    images): the loader renders the targets on ``device`` (the heatmap
    kernel on a card), then ``make_eval_step`` + ``validate`` with the
    initial loss lambdas; ``pred_csv`` writes the LIP pose CSV, and with
    ``gt_csv`` the PCKh against it is added; ``quantize`` and
    ``flip_test``: as ``make_eval_step``'s. ``scanned``: the
    device-cached loader, ``make_eval_epoch`` and ``validate_scanned``
    (module docstring)."""
    renderer = make_target_renderer(stride=4, sigma=SIGMA,
                                    num_joints=NUM_JOINTS, ignore=IGNORE,
                                    normalize_images=True)
    loader = DataLoader(ds, batch, device=device, num_workers=8,
                        renderer=renderer, cache_on_device=scanned)
    kw = dict(num_classes=NUM_CLASSES, class_weights=LIP.class_weights,
              flip_test=flip_test, ignore_index=IGNORE,
              flip_pairs=LIP.flip_pairs,
              decode_hw=(crop_size[1], crop_size[0]), quantize=quantize)
    crit = init_criterion_params(model.refine_layers + 1, device)
    if scanned:
        return E.validate_scanned(E.make_eval_epoch(model, **kw), crit,
                                  loader, num_classes=NUM_CLASSES,
                                  pred_csv=pred_csv, gt_csv=gt_csv)
    return E.validate(E.make_eval_step(model, **kw), crit, loader,
                      num_classes=NUM_CLASSES, pred_csv=pred_csv,
                      gt_csv=gt_csv)


def evaluate_synthetic(model, *, n: int, batch: int, crop_size, device,
                       seed: int = 0, pred_csv: str | None = None,
                       quantize: str | None = None,
                       flip_test: bool = True, scanned: bool = False) -> dict:
    """``evaluate`` over ``n`` synthetic images drawn from ``seed``."""
    ds = SyntheticDataset(length=n, crop_size=crop_size,
                          num_joints=NUM_JOINTS, num_classes=NUM_CLASSES,
                          seed=seed, device_normalize=True)
    return evaluate(model, ds, batch=batch, crop_size=crop_size,
                    device=device, pred_csv=pred_csv, quantize=quantize,
                    flip_test=flip_test, scanned=scanned)


def result_line(result: dict) -> str:
    line = (f"n={len(result['names'])} loss={result['loss']:.4f} "
            f"pixel_acc={result['pixel_acc']:.4f} "
            f"mIoU={result['mean_iou']:.4f}")
    if "pck_avg" in result:
        line += f" PCKh@0.5={result['pck_avg']:.2f}"
    return line


def metrics_json(result: dict) -> dict:
    """The metrics as the JAX CLI's ``--json-out`` writes them: every
    entry but the predictions, their names, the PCKh table (and the
    confusion matrix, which the JAX result does not hold), arrays as
    lists."""
    return {k: (v.tolist() if hasattr(v, "tolist") else v)
            for k, v in result.items()
            if k not in ("pose_preds", "names", "pck", "cm")}


def run(args, data_root: str | None, device, preset=LIP) -> dict:
    """The CLI's work on this rank: load the model, evaluate, and on rank
    0 print the tables and write ``--json-out``."""
    model, crop, _ = load_eval_model(
        args.ckpt, tiny=args.tiny, genotype=args.genotype, device=device,
        dtype=getattr(torch, args.dtype), seed=args.seed, preset=preset)
    pred_csv = args.pred_csv or None
    kw = dict(quantize="int8" if args.int8 else None,
              flip_test=preset.test["flip_test"], scanned=args.scanned)
    if data_root is None:
        result = evaluate_synthetic(model, n=2 * args.batch,
                                    batch=args.batch, crop_size=crop,
                                    device=device, seed=args.seed,
                                    pred_csv=pred_csv, **kw)
    else:
        sample = args.sample or preset.train_config()[1]["num_samples"] or -1
        ds = dataset_for(
            preset.data, "val", data_root, crop_size=crop, sigma=SIGMA,
            is_train=False, device_normalize=True, sample=sample,
            **preset.reader)
        result = evaluate(model, ds, batch=args.batch, crop_size=crop,
                          device=device, pred_csv=pred_csv,
                          gt_csv=pose_gt_csv(args, preset, data_root), **kw)
    if not mesh.is_primary():
        return result
    print(per_class_table(result["per_class_iou"], result["per_class_acc"]))
    print(result_line(result))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(metrics_json(result), f, indent=1)
        print(f"wrote {args.json_out}")
    return result


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_cfg_argument(p, datasets=False)
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic LIP-shaped data")
    p.add_argument("--data-root", default="",
                   help="LIP directory (default: the YAML's data/LIP/)")
    p.add_argument("--gt-csv", default="",
                   help="LIP pose ground-truth CSV: adds the PCKh table")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--ckpt", default="",
                   help="train-CLI checkpoint directory or flax .npz "
                        "(empty = random weights from --seed)")
    p.add_argument("--genotype", default="",
                   help="searched-genotype JSON matching the checkpoint")
    p.add_argument("--pred-csv", default="",
                   help="write the LIP-protocol pose CSV here")
    p.add_argument("--json-out", default="",
                   help="also dump the metric dict as JSON")
    p.add_argument("--sample", type=int, default=0,
                   help="evaluate the first N val samples (0 = the "
                        "configuration's TRAIN.NUM_SAMPLES, the 5000 "
                        "protocol); --synthetic evaluates 2 x --batch")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--int8", action="store_true",
                   help="serve the forwards through int8 dense convs")
    p.add_argument("--scanned", action="store_true",
                   help="the whole set in one dispatch: device-cached "
                        "batches, one CUDA graph replay on the card (one "
                        "process only)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", default="bfloat16",
                   choices=("bfloat16", "float32"),
                   help="model compute dtype (the flagship's is bfloat16)")
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    preset = resolve_preset(p, args, lip_only=True)
    data_root = data_source(p, args, preset)

    device, started = start_ranks(p, args)
    if args.scanned:
        refuse_under_group(p, started, "--scanned",
                           "npp_tpu's multi-process validate_scanned")
    try:
        result = run(args, data_root, device, preset)
    finally:
        if started:
            torch.distributed.destroy_process_group()
    return result


if __name__ == "__main__":
    main()
