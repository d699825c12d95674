"""Search CLI: the bi-level NPPNet interaction search on synthetic data.

Port of ``tools/search_lip.py`` for synthetic data (the LIP and PPP
readers are not ported yet). The reference search scale is built in, so
no YAML is read: the supernet at L=16, C=32, one refinement stage, 20
classes, 16 joints, 384x384 crops at batch 7, bf16 compute (channels_last
on the card), and ``experiments/lip/384_384.yaml``'s ``SEARCH`` / ``LOSS``:
weight Adam at W_LR 1e-3 with LR_STEP (70, 100) x 0.2 per iteration (the
loss lambdas at 1e-4), arch Adam at APLHA_LR 1e-3 with betas (0.5, 0.999)
and weight decay 1e-3 (the value the JAX CLI passes, not the yaml's
1e-4), 15 weight-only warmup epochs, the entropy term after epoch 70, 120
epochs, OHEM 0.9 / 131072. ``--tiny`` is the small test configuration
(L=8, C=8, 128x128, batch 2). Weights are random, drawn from ``--seed``.

Data: synthetic train, mini and val sets (8 x batch, 8 x batch and 2 x
batch images, seeds 0, 1 and 2); the train and mini loaders shuffle (the
mini one with seed 1), and each renders its batch's targets on the
device (the heatmap kernel on a card). Each epoch: weight steps alone
during the warmup, then ``engine.search_epoch`` (a weight step on a train
batch, an arch step on a mini batch), the flip-TTA ``validate``, the
genotype of the current architecture parameters (logged), the coupled
best-model rule, ``best_genotype.json`` for a new best, and a checkpoint
(mirrored to ``warmed`` at the warmup's last epoch and ``final`` at the
last) under ``<out>/lip/search/<config>/``.

Not ported: ``--zero`` (several devices), ``--merged-streams`` and the
dataset readers.

Examples:
  python -m npp_tpu_torch.tools.search_lip --synthetic --steps 2 \\
      --epochs 2 --warmup-epochs 1
  python -m npp_tpu_torch.tools.search_lip --synthetic --tiny \\
      --device cpu --dtype float32 --steps 2 --epochs 2 --warmup-epochs 1
"""
from __future__ import annotations

import argparse
import os

import torch

from npp_tpu_torch import engine
from npp_tpu_torch.core import evaluate as E
from npp_tpu_torch.core import search as S
from npp_tpu_torch.core.checkpoint import CheckpointManager
from npp_tpu_torch.core.criterion import LIP_CLASS_WEIGHTS
from npp_tpu_torch.data.loader import DataLoader, make_target_renderer
from npp_tpu_torch.data.synthetic import SyntheticDataset
from npp_tpu_torch.genotypes import save_genotypes
from npp_tpu_torch.models import genotype_parse as GP
from npp_tpu_torch.tools.augment_lip import LimitedLoader
from npp_tpu_torch.tools.eval_lip import IGNORE, NUM_CLASSES, NUM_JOINTS, SIGMA
from npp_tpu_torch.utils.logging_utils import (MetricWriter, close_logger,
                                               create_logger)

FLAGSHIP_SEARCH_MODEL = dict(num_classes=NUM_CLASSES, num_joints=NUM_JOINTS,
                             layers=16, init_channels=32, refine_layers=1)
TINY_SEARCH_MODEL = dict(FLAGSHIP_SEARCH_MODEL, layers=8, init_channels=8)
# experiments/lip/384_384.yaml SEARCH / LOSS / PRINT_FREQ / WORKERS and
# npp_tpu/config.py:121-125; the arch weight decay is
# core/search.ALPHA_WEIGHT_DECAY.
FLAGSHIP_SEARCH = dict(crop=(384, 384), batch_size=7, w_lr=1e-3,
                       alpha_lr=1e-3, lr_step=(70, 100), lr_factor=0.2,
                       warmup_epochs=15, entropy_epoch=70, epochs=120,
                       ohem_thres=0.9, ohem_keep=131072,
                       use_target_weight=False, print_freq=100, workers=8)
TINY_SEARCH = dict(FLAGSHIP_SEARCH, crop=(128, 128), batch_size=2)


def build_loaders(hp: dict, device):
    """(train, mini, val) loaders over synthetic data, rendering their
    targets on ``device`` and normalising the uint8 images there."""
    renderer = make_target_renderer(stride=4, sigma=SIGMA,
                                    num_joints=NUM_JOINTS, ignore=IGNORE,
                                    normalize_images=True)
    bs, crop = hp["batch_size"], hp["crop"]

    def dataset(n, seed, train):
        return SyntheticDataset(length=n, crop_size=crop,
                                num_joints=NUM_JOINTS,
                                num_classes=NUM_CLASSES, seed=seed,
                                is_train=train, device_normalize=True)

    common = dict(device=device, num_workers=hp["workers"],
                  renderer=renderer)
    train = DataLoader(dataset(8 * bs, 0, True), bs, shuffle=True,
                       drop_last=True, **common)
    mini = DataLoader(dataset(8 * bs, 1, True), bs, shuffle=True,
                      drop_last=True, seed=1, **common)
    val = DataLoader(dataset(2 * bs, 2, False), bs, **common)
    return train, mini, val


def init_state(model_kw: dict, hp: dict, *, device, dtype, seed: int,
               steps_per_epoch: int) -> S.SearchState:
    return S.init_search_state(
        generator=torch.Generator().manual_seed(seed), device=device,
        w_lr=hp["w_lr"], alpha_lr=hp["alpha_lr"], lr_step=hp["lr_step"],
        lr_factor=hp["lr_factor"], steps_per_epoch=steps_per_epoch,
        dtype=dtype, **model_kw)


def make_search_steps(hp: dict):
    return S.make_search_steps(class_weights=LIP_CLASS_WEIGHTS,
                               ignore_index=IGNORE,
                               ohem_thres=hp["ohem_thres"],
                               ohem_keep=hp["ohem_keep"],
                               use_target_weight=hp["use_target_weight"])


def validate(state: S.SearchState, eval_step, val_loader) -> dict:
    """Flip-TTA validation of the supernet in eval mode."""
    state.model.eval()
    return E.validate(eval_step, state.lamdas, val_loader,
                      num_classes=NUM_CLASSES)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic LIP-shaped data (the only source so far)")
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
    p.add_argument("--out", default="output",
                   help="root of the run's output and log directories")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not args.synthetic:
        p.error("only --synthetic data is ported so far")

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is False")
    if device.type == "cuda":
        # fp32 convs (the last head convs, the decode blur) in full fp32.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    model_kw, hp = ((TINY_SEARCH_MODEL, TINY_SEARCH) if args.tiny
                    else (FLAGSHIP_SEARCH_MODEL, FLAGSHIP_SEARCH))
    logger, out_dir, tb_dir = create_logger(
        args.out, os.path.join(args.out, "log"), "lip",
        "tiny" if args.tiny else "flagship", "search")
    writer = MetricWriter(tb_dir)
    try:
        train_loader, mini_loader, val_loader = build_loaders(hp, device)
        if args.steps:
            train_loader = LimitedLoader(train_loader, args.steps)
            mini_loader = LimitedLoader(mini_loader, args.steps)
            val_loader = LimitedLoader(val_loader, max(1, args.steps // 2))
        state = init_state(model_kw, hp, device=device,
                           dtype=getattr(torch, args.dtype), seed=args.seed,
                           steps_per_epoch=max(1, len(train_loader)))
        logger.info(f"device {device}; search state initialised")

        ckpt = CheckpointManager(os.path.join(out_dir, "checkpoints"))
        begin_epoch, best_iou, best_pck = 0, 0.0, 0.0
        if args.resume:
            restored, meta = ckpt.restore(state)
            if restored is not None:
                begin_epoch = int(meta["epoch"]) + 1
                best_iou = float(meta.get("best_iou", 0.0))
                best_pck = float(meta.get("best_pck", 0.0))
                logger.info(f"resumed from epoch {meta['epoch']}")

        weight_step, arch_step = make_search_steps(hp)
        crop = hp["crop"]
        eval_step = E.make_eval_step(
            state.model, num_classes=NUM_CLASSES,
            class_weights=LIP_CLASS_WEIGHTS, flip_test=True,
            ignore_index=IGNORE, decode_hw=(crop[1], crop[0]))
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
            result = validate(state, eval_step, val_loader)
            miou = result["mean_iou"]
            pck = 0.0  # synthetic names match no PCKh ground truth
            genotype = GP.extract_genotype(S.get_arch_params(state))
            logger.info(f"epoch {epoch}: train loss {train_loss:.4f} val "
                        f"loss {result['loss']:.4f} mIoU {miou:.4f}")
            logger.info(f"genotype = {genotype}")
            writer.scalar("valid_mIoU", miou, epoch)
            is_best = engine.is_best_checkpoint(miou, pck, best_iou,
                                                best_pck)
            if is_best:
                best_iou, best_pck = miou, pck
                best_genotype = genotype
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
    return {"state": state, "train_loss": train_loss, "result": result,
            "genotype": genotype, "best_genotype": best_genotype,
            "out_dir": out_dir, "checkpoints": ckpt.directory}


if __name__ == "__main__":
    main()
