"""Search CLI: the bi-level NPPNet interaction search on LIP or synthetic
data.

Port of ``tools/search_lip.py``. The reference search scale is built in
(``config.py``); ``--cfg`` takes npp_tpu's experiment YAML instead, as
the train CLI does (``augment_lip.resolve_preset``), and trailing
``opts`` are accepted and read nowhere. For ``--dataset lip`` (the default)
the supernet at L=16, C=32, one refinement stage, 20 classes, 16 joints,
384x384 crops at batch 7, bf16 compute (channels_last on the card), and
``experiments/lip/384_384.yaml``'s ``SEARCH`` / ``LOSS``:
weight Adam at W_LR 1e-3 with LR_STEP (70, 100) x 0.2 per iteration (the
loss lambdas at 1e-4), arch Adam at APLHA_LR 1e-3 with betas (0.5, 0.999)
and weight decay 1e-3 (the value the JAX CLI passes, not the yaml's
1e-4), 15 weight-only warmup epochs, the entropy term after epoch 70, 120
epochs, OHEM 0.9 / 131072. ``--dataset ppp`` is Pascal-Person-Part
(``experiments/pascal/384_384.yaml``): the supernet at L=12 with 7
classes and 14 joints, the same search hyper-parameters, the Pascal class
weights and no parsing flip pairs; its validation stays the LIP-protocol
step with the 14-joint flip index, as the JAX CLI's does. ``--tiny`` is
the small test configuration (L=8, C=8, 128x128, batch 2). Weights are
random, drawn from ``--seed``.

Data: a LIP directory (``--data-root``, by default the YAML's
``data/LIP/``) laid out as ``config.LIP.data`` names it: the search's
train (``_w``) and mini (``_a``) sets with the reader's augmentation
(seeded by ``--seed``) and the first 5000 entries of the val set;
``--gt-csv`` adds the PCKh of each validation against that LIP pose CSV.
``--synthetic``: synthetic train, mini and val sets instead (8 x batch,
8 x batch and 2 x batch images, seeds 0, 1 and 2). The train and mini
loaders shuffle (the mini one with seed 1), and each renders its batch's
targets on the device (the heatmap kernel on a card).

``--dataset ppp`` searches on synthetic data only: npp_tpu's search CLI
reads no PPP directory. On disk it builds ``LIPDataset`` from the PPP
YAML's ``SEARCH`` sets, which are LIP annotation JSONs
(``tools/search_lip.py:92-101``, ``experiments/pascal/384_384.yaml:46-48``),
so under a PPP root it finds nothing to read, and its 16-joint samples
would not fit the 14-joint targets.

Each epoch: weight steps alone during the warmup, then
``engine.search_epoch`` (a weight step on a train batch, an arch step on
a mini batch), the flip-TTA ``validate``, the genotype of the current
architecture parameters (logged), the coupled best-model rule,
``best_genotype.json`` for a new best, and a checkpoint (mirrored to
``warmed`` at the warmup's last epoch and ``final`` at the last) under
``<out>/<dataset>/search/<config>/``.

Several GPUs: ``python -m torch.distributed.run --nproc_per_node=N -m
npp_tpu_torch.tools.search_lip ...``, as the train CLI (one process per
card, the preset's batch per rank, global BN moments and losses, the
architecture parameters' gradients averaged with the weights' by DDP,
rank 0 logs and writes); ``--zero`` shards both Adams' state (ZeRO-1).

``--resume-jax STATE.npz`` continues an npp_tpu search from its
``SearchState`` as a flat ``.npz`` (npp_tpu's keys, in its default
vmapped layout or the unrolled one; ``utils/convert.load_jax_state``):
weights, architecture parameters, both Adams' moments and counts and the
weight schedule, from the epoch after ``meta/epoch`` (else after ``step``
/ steps per epoch); the warmup follows from that epoch, as after
``--resume``.

Not ported: ``--merged-streams``.

Examples:
  python -m npp_tpu_torch.tools.search_lip --data-root data/LIP \\
      --gt-csv data/LIP/pose_csv/pose_gt.csv
  python -m npp_tpu_torch.tools.search_lip --synthetic --steps 2 \\
      --epochs 2 --warmup-epochs 1
  python -m npp_tpu_torch.tools.search_lip --synthetic --dataset ppp \\
      --steps 2 --epochs 1
  python -m npp_tpu_torch.tools.search_lip --synthetic --tiny \\
      --device cpu --dtype float32 --steps 2 --epochs 2 --warmup-epochs 1
  python -m torch.distributed.run --nproc_per_node=4 \\
      -m npp_tpu_torch.tools.search_lip --data-root data/LIP --zero
"""
from __future__ import annotations

import argparse
import os

import torch

from npp_tpu_torch import engine
from npp_tpu_torch.config import IGNORE, LIP, SIGMA
from npp_tpu_torch.core import evaluate as E
from npp_tpu_torch.core import search as S
from npp_tpu_torch.core.checkpoint import CheckpointManager
from npp_tpu_torch.data.lip import dataset_for
from npp_tpu_torch.data.loader import DataLoader, make_target_renderer
from npp_tpu_torch.data.synthetic import SyntheticDataset
from npp_tpu_torch.genotypes import save_genotypes
from npp_tpu_torch.models import genotype_parse as GP
from npp_tpu_torch.parallel import mesh
from npp_tpu_torch.tools.augment_lip import (LimitedLoader,
                                             add_cfg_argument,
                                             add_resume_jax_argument,
                                             data_source, make_lip_eval_step,
                                             pose_gt_csv, resolve_preset,
                                             resume_from_jax, start_ranks)
from npp_tpu_torch.utils.logging_utils import (MetricWriter, close_logger,
                                               create_logger)

FLAGSHIP_SEARCH_MODEL, FLAGSHIP_SEARCH = LIP.search_config()
TINY_SEARCH_MODEL, TINY_SEARCH = LIP.search_config(tiny=True)


def build_loaders(hp: dict, device, preset=LIP, data_root: str | None = None,
                  seed: int = 0):
    """(train, mini, val) loaders: with ``data_root`` the LIP directory's
    search train and mini sets (augmented, the readers seeded by
    ``seed``) and the first 5000 entries of its val set, else synthetic
    data shaped as ``preset``'s; each renders its targets on ``device``
    and normalises the uint8 images there."""
    renderer = make_target_renderer(stride=4, sigma=SIGMA,
                                    num_joints=preset.num_joints,
                                    ignore=IGNORE, normalize_images=True)
    bs, crop = hp["batch_size"], hp["crop"]

    if data_root is not None:
        def dataset(split, train, sample=-1):
            return dataset_for(preset.data, split, data_root,
                               crop_size=crop, sigma=SIGMA, is_train=train,
                               sample=sample, seed=seed,
                               device_normalize=True, **preset.reader)

        sets = (dataset("search_train", True), dataset("search_mini", True),
                dataset("search_val", False, sample=5000))
    else:
        def dataset(n, seed, train):
            return SyntheticDataset(length=n, crop_size=crop,
                                    num_joints=preset.num_joints,
                                    num_classes=preset.num_classes,
                                    seed=seed, is_train=train,
                                    device_normalize=True)

        sets = (dataset(8 * bs, 0, True), dataset(8 * bs, 1, True),
                dataset(2 * bs, 2, False))

    common = dict(device=device, num_workers=hp["workers"],
                  renderer=renderer)
    train = DataLoader(sets[0], bs, shuffle=True, drop_last=True, **common)
    mini = DataLoader(sets[1], bs, shuffle=True, drop_last=True, seed=1,
                      **common)
    val = DataLoader(sets[2], bs, **common)
    return train, mini, val


def init_state(model_kw: dict, hp: dict, *, device, dtype, seed: int,
               steps_per_epoch: int, group=None,
               zero: bool = False) -> S.SearchState:
    return S.init_search_state(
        generator=torch.Generator().manual_seed(seed), device=device,
        w_lr=hp["w_lr"], alpha_lr=hp["alpha_lr"], lr_step=hp["lr_step"],
        lr_factor=hp["lr_factor"], steps_per_epoch=steps_per_epoch,
        dtype=dtype, group=group, zero=zero, **model_kw)


def make_search_steps(hp: dict, preset=LIP):
    return S.make_search_steps(class_weights=preset.class_weights,
                               ignore_index=IGNORE,
                               ohem_thres=hp["ohem_thres"],
                               ohem_keep=hp["ohem_keep"],
                               use_target_weight=hp["use_target_weight"])


def validate(state: S.SearchState, eval_step, val_loader, preset=LIP,
             gt_csv: str | None = None, pred_csv: str | None = None,
             log_fn=print) -> dict:
    """Flip-TTA validation of the supernet in eval mode (with ``gt_csv``
    and ``pred_csv``, the PCKh table too)."""
    state.model.eval()
    return E.validate(eval_step, state.lamdas, val_loader,
                      num_classes=preset.num_classes, gt_csv=gt_csv,
                      pred_csv=pred_csv, log_fn=log_fn)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_cfg_argument(p, opts=True)
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic data shaped as the dataset's")
    p.add_argument("--data-root", default="",
                   help="LIP directory (default: the YAML's data/LIP/)")
    p.add_argument("--gt-csv", default="",
                   help="LIP pose ground-truth CSV: adds PCKh to each "
                        "validation")
    p.add_argument("--steps", type=int, default=0,
                   help="limit steps (pairs) per epoch (0 = full)")
    p.add_argument("--epochs", type=int, default=0,
                   help="number of epochs (0 = the reference's 120)")
    p.add_argument("--warmup-epochs", type=int, default=-1,
                   help="weight-only epochs first (-1 = the reference's 15)")
    p.add_argument("--tiny", action="store_true",
                   help="L=8, C=8, 128x128, batch 2")
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", default="bfloat16",
                   choices=("bfloat16", "float32"),
                   help="model compute dtype (the reference scale's is "
                        "bfloat16)")
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest epoch checkpoint")
    add_resume_jax_argument(p, "SearchState")
    p.add_argument("--out", default="output",
                   help="root of the run's output and log directories")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--zero", action="store_true",
                   help="ZeRO-1: shard both Adam moment trees over the "
                        "data-parallel ranks (parallel/zero.py)")
    return p


def main(argv=None) -> dict:
    p = build_parser()
    args = p.parse_args(argv)
    preset = resolve_preset(p, args)
    if preset.name == "ppp" and not args.synthetic:
        p.error("the PPP preset searches on --synthetic data only: npp_tpu's "
                "search reads the PPP YAML's SEARCH sets, which are LIP "
                "annotation JSONs, not a PPP directory")
    data_root = data_source(p, args, preset)
    if args.resume and args.resume_jax:
        p.error("--resume and --resume-jax both restore the state: give one")

    device, started = start_ranks(p, args)
    model_kw, hp = preset.search_config(args.tiny)
    logger, out_dir, tb_dir = create_logger(
        args.out, os.path.join(args.out, "log"), preset.name,
        "tiny" if args.tiny else "flagship", "search")
    writer = MetricWriter(tb_dir)
    try:
        train_loader, mini_loader, val_loader = build_loaders(
            hp, device, preset, data_root, args.seed)
        if args.steps:
            train_loader = LimitedLoader(train_loader, args.steps)
            mini_loader = LimitedLoader(mini_loader, args.steps)
            val_loader = LimitedLoader(val_loader, max(1, args.steps // 2))
        state = init_state(model_kw, hp, device=device,
                           dtype=getattr(torch, args.dtype), seed=args.seed,
                           steps_per_epoch=max(1, len(train_loader)),
                           group=mesh.data_group(), zero=args.zero)
        logger.info(f"device {device}; rank {mesh.rank()} of "
                    f"{mesh.world_size()}; search state initialised")

        ckpt = CheckpointManager(os.path.join(out_dir, "checkpoints"))
        begin_epoch, best_iou, best_pck = 0, 0.0, 0.0
        if args.resume:
            restored, meta = ckpt.restore(state)
            if restored is not None:
                begin_epoch = int(meta["epoch"]) + 1
                best_iou = float(meta.get("best_iou", 0.0))
                best_pck = float(meta.get("best_pck", 0.0))
                logger.info(f"resumed from epoch {meta['epoch']}")
        if args.resume_jax:
            begin_epoch, best_iou, best_pck = resume_from_jax(
                state, args.resume_jax, max(1, len(train_loader)),
                logger.info)

        weight_step, arch_step = make_search_steps(hp, preset)
        # The LIP protocol for either dataset, as in the JAX search CLI.
        eval_step = make_lip_eval_step(state.model, hp, preset)
        gt_csv = pose_gt_csv(args, preset, data_root)
        warmup = (args.warmup_epochs if args.warmup_epochs >= 0
                  else hp["warmup_epochs"])
        epochs = args.epochs or hp["epochs"]
        gstep, train_loss, result, best_genotype = 0, float("nan"), None, None
        genotype = None
        for epoch in range(begin_epoch, epochs):
            train_loader.set_epoch(epoch)
            mini_loader.set_epoch(epoch)
            if epoch < warmup:
                train_loss, gstep = engine.train_epoch(
                    weight_step, state, train_loader, epoch=epoch,
                    logger=logger, writer=writer,
                    print_freq=hp["print_freq"], global_step=gstep)
            else:
                train_loss, gstep = engine.search_epoch(
                    weight_step, arch_step, state, train_loader,
                    mini_loader, epoch=epoch,
                    entropy_epoch=hp["entropy_epoch"], logger=logger,
                    writer=writer, print_freq=hp["print_freq"],
                    global_step=gstep)
            result = validate(
                state, eval_step, val_loader, preset,
                gt_csv=gt_csv,
                pred_csv=(os.path.join(out_dir, "pose_pred.csv")
                          if gt_csv else None), log_fn=logger.info)
            miou = result["mean_iou"]
            pck = result.get("pck_avg", 0.0)  # PCKh only with a GT CSV
            genotype = GP.extract_genotype(S.get_arch_params(state))
            logger.info(f"epoch {epoch}: train loss {train_loss:.4f} val "
                        f"loss {result['loss']:.4f} mIoU {miou:.4f} PCKh "
                        f"{pck:.2f}")
            logger.info(f"genotype = {genotype}")
            writer.scalar("valid_mIoU", miou, epoch)
            is_best = engine.is_best_checkpoint(miou, pck, best_iou,
                                                best_pck)
            if is_best:
                best_iou, best_pck = miou, pck
                best_genotype = genotype
            if is_best and mesh.is_primary():
                save_genotypes(os.path.join(out_dir, "best_genotype.json"),
                               genotype[0], genotype[1],
                               meta={"epoch": epoch, "miou": miou,
                                     "pck": pck})
            ckpt.save(epoch, state,
                      metrics={"best_iou": best_iou, "best_pck": best_pck},
                      is_best=is_best,
                      tag=("warmed" if epoch == warmup - 1 else
                           "final" if epoch == epochs - 1 else None))
        ckpt.wait()
        logger.info(f"final best mIoU {best_iou:.4f} best PCKh "
                    f"{best_pck:.2f}")
        logger.info(f"best genotype = {best_genotype}")
    finally:
        writer.close()
        close_logger(logger)
        if started:
            torch.distributed.destroy_process_group()
    return {"state": state, "train_loss": train_loss, "result": result,
            "genotype": genotype, "best_genotype": best_genotype,
            "out_dir": out_dir, "checkpoints": ckpt.directory,
            "begin_epoch": begin_epoch}


if __name__ == "__main__":
    main()
