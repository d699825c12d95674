"""Training CLI (augment phase): the fixed NPPNet on LIP or synthetic data.

Port of ``tools/augment_lip.py``. The configurations are built in
(``config.py``); ``--cfg`` takes npp_tpu's experiment YAML instead
(``experiments/lip/384_384.yaml`` or ``experiments/pascal/384_384.yaml``,
read by ``config.load_preset``): its ``DATASET.DATASET`` picks the
preset and its values set it, and a ``--dataset`` that contradicts it is
refused. Trailing ``opts`` are accepted and read nowhere, as in npp_tpu.
``--dataset lip`` (the default) is
the LIP flagship: the NPPNet of L=16, C=64, one refinement stage, 20
classes, 16 joints, 384x384 crops at batch 16, bf16 compute with the
last head conv in fp32 (channels_last on the card), and
``experiments/lip/384_384.yaml``'s ``TRAIN`` / ``LOSS``: Adam at lr
0.0015 (0.2x for the backbone, 1e-4 for the loss lambdas), LR_STEP (150,
170) with factor 0.2 per iteration, 190 epochs, OHEM 0.9 / 131072, sigma
3, ignore 255, no joint target weights. ``--dataset ppp`` is
Pascal-Person-Part (``experiments/pascal/384_384.yaml``): 7 classes, 14
joints, the same net, batch 2, Adam at lr 0.001 with LR_STEP (75, 85,
95) x 0.1, 150 epochs, the Pascal class weights. ``--tiny`` is the small
test configuration (L=8, C=8, 128x128, batch 4). Weights are random,
drawn from ``--seed``; ``--genotype`` builds the net from a search's
``best_genotype.json``, and ``--pretrained-encoder`` then merges a search
checkpoint directory's weights into it (its ``best`` checkpoint, else the
latest epoch's; ``core/checkpoint.load_pretrained_params``), after
``--resume`` as in the JAX CLI, logging what it loaded and skipped.
``--resume-jax STATE.npz`` continues an npp_tpu run instead: its
``TrainState`` as a flat ``.npz`` (npp_tpu's keys, ``utils/convert.
load_jax_state``; the README shows how to write it), weights, Adam's
moments and counts, the schedule and the lambdas' gradient sum, from
the epoch after ``meta/epoch`` (else after ``step`` / steps per epoch).

Data: the dataset's directory (``--data-root``, by default the YAML's
``data/LIP/`` or ``data/pascal_data/``) laid out as the preset's
``data`` names it: the train set (augmented by the preset's reader,
seeded by ``--seed``) and the val set (its first ``num_samples`` = 5000
entries, no augmentation). A LIP directory holds the images, grey PNG
labels and annotation JSONs of ``config.LIP.data`` (``LIPDataset``, or
with ``--fast-aug`` the fused warp of ``FastLIPDataset``); ``--gt-csv``
adds the PCKh of each validation against a LIP pose CSV, and without it
the configuration's ``POSE_GT_PATH`` does where that file exists (else
the LIP validation reports mIoU only). A run that does not resume
begins at the configuration's ``TRAIN.BEGIN_EPOCH`` (0 in the YAMLs). A
PPP directory holds ``JPEGImages/<id>.jpg``,
``SegmentationPart/<id>.png`` (8-bit grey part
labels 0-6), ``PersonJoints/<id>.mat`` (the GT persons' boxes and
joints), ``masks/<id>.npy`` (Mask-R-CNN instances) and the id lists
``train_id.txt`` and ``val_id.txt`` (``PPPDataset``: one sample per
matched person). ``--synthetic`` trains on synthetic data instead.

``--steps-per-dispatch K`` (npp_tpu's flag, default 1) runs K train
steps a dispatch (``engine.train_epoch_scanned``, ``core/train.
make_train_step_scanned``): on the card one CUDA graph replay, captured
at the first dispatch of each chunk size (a failed capture raises); on
the CPU the same K steps one after another. One process only: under a
process group it is refused.

Each epoch: ``engine.train_epoch`` over the shuffled train set (the
loader renders each batch's targets on the device: the heatmap kernel
once per step on a card), the flip-TTA validation: ``validate`` for LIP,
``validate_ppp`` (heatmap PCK) for PPP; the coupled (mIoU, PCK)
best-model rule, and a checkpoint under
``<out>/<dataset>/augment/<config>/checkpoints``.

Several GPUs: launch it with ``python -m torch.distributed.run
--nproc_per_node=N -m npp_tpu_torch.tools.augment_lip ...`` (one process
per card, ``cuda:{LOCAL_RANK}``; NCCL, or gloo with ``--device cpu``).
The preset's batch is each rank's, as in npp_tpu's multi-process loader
and the reference, so the global batch is N x batch: each rank trains on
its strided shard of the epoch, BN takes the moments of the global batch,
the loss is the global batch's and DDP averages the gradients
(``parallel/``); the validation gathers every rank's shard. ``--zero``
shards Adam's state over the ranks (ZeRO-1). Rank 0 alone logs and
writes the checkpoints, which hold no ``module.`` key and restore in one
process. The returned dict is the same on every rank.

Examples:
  python -m npp_tpu_torch.tools.augment_lip \\
      --cfg experiments/lip/384_384.yaml --synthetic --tiny --steps 2 \\
      --epochs 1
  python -m npp_tpu_torch.tools.augment_lip --data-root data/LIP \\
      --gt-csv data/LIP/pose_csv/pose_gt.csv
  python -m npp_tpu_torch.tools.augment_lip --synthetic --steps 20 \\
      --epochs 1
  python -m npp_tpu_torch.tools.augment_lip --synthetic --steps 8 \\
      --epochs 1 --steps-per-dispatch 4
  python -m npp_tpu_torch.tools.augment_lip --data-root data/LIP \\
      --fast-aug
  python -m npp_tpu_torch.tools.augment_lip --dataset ppp \\
      --data-root data/pascal_data
  python -m npp_tpu_torch.tools.augment_lip --synthetic --dataset ppp \\
      --steps 2 --epochs 1
  python -m npp_tpu_torch.tools.augment_lip --synthetic --tiny \\
      --device cpu --dtype float32 --steps 2 --epochs 1 \\
      --genotype best_genotype.json --pretrained-encoder search/checkpoints
  python -m torch.distributed.run --nproc_per_node=4 \\
      -m npp_tpu_torch.tools.augment_lip --data-root data/LIP --zero
"""
from __future__ import annotations

import argparse
import itertools
import os

import numpy as np
import torch

from npp_tpu_torch import engine
from npp_tpu_torch.config import IGNORE, LIP, PRESETS, SIGMA, load_preset
from npp_tpu_torch.core import evaluate as E
from npp_tpu_torch.core import train as T
from npp_tpu_torch.core.checkpoint import (CheckpointManager,
                                           load_pretrained_params)
from npp_tpu_torch.core.graphs import one_process
from npp_tpu_torch.data import lip, pascal
from npp_tpu_torch.data.loader import DataLoader, make_target_renderer
from npp_tpu_torch.data.synthetic import SyntheticDataset
from npp_tpu_torch.genotypes import load_genotypes
from npp_tpu_torch.parallel import mesh
from npp_tpu_torch.utils.convert import load_jax_state
from npp_tpu_torch.utils.logging_utils import (MetricWriter, close_logger,
                                               create_logger)

FLAGSHIP_TRAIN = LIP.train_config()[1]
TINY_TRAIN = LIP.train_config(tiny=True)[1]


def build_loaders(hp: dict, device, preset=LIP, data_root: str | None = None,
                  seed: int = 0, fast_aug: bool = False):
    """(train loader, val loader): with ``data_root`` the dataset
    directory's train set (augmented, the reader seeded by ``seed``; LIP
    with ``fast_aug`` through ``FastLIPDataset``) and val set (its first
    ``num_samples`` entries), else synthetic data shaped as ``preset``'s
    (val: 2 x batch images, seed 7); both render their targets on
    ``device`` and normalise the uint8 images there."""
    renderer = make_target_renderer(stride=4, sigma=SIGMA,
                                    num_joints=preset.num_joints,
                                    ignore=IGNORE, normalize_images=True)
    bs, crop = hp["batch_size"], hp["crop"]
    if data_root is not None:
        common = dict(crop_size=crop, sigma=SIGMA, device_normalize=True,
                      seed=seed, **preset.reader)
        if preset.name == "ppp":
            reader = pascal.dataset_for
        else:
            common["cls"] = lip.FastLIPDataset if fast_aug else lip.LIPDataset
            reader = lip.dataset_for
        train_ds = reader(preset.data, "train", data_root, is_train=True,
                          **common)
        val_ds = reader(preset.data, "val", data_root, is_train=False,
                        sample=hp["num_samples"] or -1, **common)
    else:
        common = dict(crop_size=crop, num_joints=preset.num_joints,
                      num_classes=preset.num_classes, device_normalize=True)
        train_ds = SyntheticDataset(length=max(4 * bs, 32), **common)
        val_ds = SyntheticDataset(length=2 * bs, is_train=False, seed=7,
                                  **common)
    train = DataLoader(train_ds, bs, device=device, shuffle=True,
                       drop_last=True, num_workers=hp["workers"],
                       renderer=renderer)
    val = DataLoader(val_ds, bs, device=device, num_workers=hp["workers"],
                     renderer=renderer)
    return train, val


def add_cfg_argument(p: argparse.ArgumentParser, datasets: bool = True,
                     opts: bool = False) -> None:
    """``--cfg`` (and, with ``datasets``, ``--dataset``; with ``opts``,
    npp_tpu's trailing ``opts``) on a CLI's parser."""
    p.add_argument("--cfg", default="",
                   help="npp_tpu experiment YAML (e.g. "
                        "experiments/lip/384_384.yaml): its DATASET.DATASET "
                        "picks the preset and its values set it (default: "
                        "the built-in preset)")
    if datasets:
        p.add_argument("--dataset", choices=sorted(PRESETS), default=None,
                       help="the built-in configuration: LIP (the default) "
                            "or Pascal-Person-Part; must agree with --cfg")
    if opts:
        p.add_argument("opts", nargs=argparse.REMAINDER,
                       help="accepted and read nowhere, as in npp_tpu")


def resolve_preset(p: argparse.ArgumentParser, args, lip_only=False):
    """The preset of ``--cfg`` (``config.load_preset``; an unknown key
    raises ``ValueError``), else of ``--dataset``; refuses a
    ``--dataset`` that contradicts the file, and with ``lip_only`` any
    preset but LIP's."""
    dataset = getattr(args, "dataset", None)
    if args.cfg:
        preset = load_preset(args.cfg)
        if dataset and dataset != preset.name:
            p.error(f"--dataset {dataset} contradicts {args.cfg}, whose "
                    f"DATASET.DATASET is {preset.name!r}")
    else:
        preset = PRESETS[dataset or "lip"]
    if lip_only and preset.name != "lip":
        p.error(f"{args.cfg} is a {preset.name.upper()} configuration; this "
                f"CLI runs LIP's protocol only, as npp_tpu's")
    return preset


def data_source(p: argparse.ArgumentParser, args, preset) -> str | None:
    """The dataset root the CLI reads (None: ``--synthetic``); refuses
    the combinations that make no sense."""
    if args.synthetic:
        if args.data_root or getattr(args, "gt_csv", ""):
            p.error("--data-root and --gt-csv read a dataset directory; "
                    "drop them with --synthetic")
        return None
    if preset.name != "lip" and getattr(args, "gt_csv", ""):
        p.error("--gt-csv is LIP's PCKh ground truth; the "
                f"{preset.name.upper()} validation scores its heatmap PCK")
    return args.data_root or preset.data["root"]


def pose_gt_csv(args, preset, data_root: str | None) -> str | None:
    """The LIP pose CSV to score PCKh against: ``--gt-csv``, else the
    configuration's ``POSE_GT_PATH`` where that file exists, as
    npp_tpu's CLIs take it (LIP from a directory only: a synthetic run
    and PPP's validation score none)."""
    if args.gt_csv:
        return args.gt_csv
    path = preset.data.get("pose_gt_path", "")
    if data_root is None or preset.name != "lip" or not path:
        return None
    return path if os.path.isfile(path) else None


class LimitedLoader:
    """The first ``limit`` batches of each epoch of ``loader``."""

    def __init__(self, loader, limit: int):
        self.loader, self.limit = loader, limit

    def __len__(self):
        return min(len(self.loader), self.limit)

    @property
    def dataset(self):
        return self.loader.dataset

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def __iter__(self):
        # islice pulls exactly ``limit`` batches: no extra one is rendered.
        it = iter(self.loader)
        try:
            yield from itertools.islice(it, self.limit)
        finally:
            it.close()


def init_state(model_kw: dict, hp: dict, *, device, dtype, seed: int,
               steps_per_epoch: int, group=None,
               zero: bool = False) -> T.TrainState:
    return T.init_train_state(
        generator=torch.Generator().manual_seed(seed), device=device,
        base_lr=hp["lr"], lr_step=hp["lr_step"], lr_factor=hp["lr_factor"],
        steps_per_epoch=steps_per_epoch, dtype=dtype, group=group, zero=zero,
        **model_kw)


def resume_from_jax(state, path: str, steps_per_epoch: int,
                    log_fn=print) -> tuple[int, float, float]:
    """Load the npp_tpu state in ``path`` (``--resume-jax``) into
    ``state``; returns (the epoch to begin at, best mIoU, best PCK). The
    state's ``step`` must end an epoch of ``steps_per_epoch`` updates, and
    the epoch after ``meta/epoch`` where the file has it."""
    with np.load(path) as f:
        tree = {k: f[k] for k in f.files}
    if "step" not in tree:
        raise KeyError(f"{path}: no step; not an npp_tpu state")
    step = int(tree["step"])
    epoch, rest = divmod(step, steps_per_epoch)
    if rest:
        raise ValueError(f"{path}: step {step} is not at the end of an epoch "
                         f"of {steps_per_epoch} steps")
    if "meta/epoch" in tree and int(tree["meta/epoch"]) + 1 != epoch:
        raise ValueError(f"{path}: step {step} ends epoch {epoch - 1} at "
                         f"{steps_per_epoch} steps an epoch, meta/epoch says "
                         f"{int(tree['meta/epoch'])}: the run took another "
                         f"number of steps per epoch")
    load_jax_state(state, tree)
    optimizers = [o for o in (getattr(state, "optimizer", None),
                              getattr(state, "w_optimizer", None),
                              getattr(state, "a_optimizer", None)) if o]
    lrs = {g["name"]: g["lr"] for o in optimizers for g in o.param_groups}
    log_fn(f"resumed npp_tpu's state {path} at step {step}, epoch {epoch}, "
           f"lr {lrs}")
    return (epoch, float(tree.get("meta/best_iou", 0.0)),
            float(tree.get("meta/best_pck", 0.0)))


def make_train_step(hp: dict, preset=LIP, scanned: bool = False):
    """The preset's train step; with ``scanned`` K steps a call
    (``make_train_step_scanned``)."""
    make = T.make_train_step_scanned if scanned else T.make_train_step
    return make(class_weights=preset.class_weights, ignore_index=IGNORE,
                ohem_thres=hp["ohem_thres"], ohem_keep=hp["ohem_keep"],
                use_target_weight=hp["use_target_weight"])


def _eval_kw(hp: dict, preset) -> dict:
    return dict(num_classes=preset.num_classes,
                class_weights=preset.class_weights, flip_test=True,
                ignore_index=IGNORE, ohem_thres=hp["ohem_thres"],
                ohem_keep=hp["ohem_keep"])


def make_lip_eval_step(model, hp: dict, preset=LIP):
    """The LIP-protocol flip-TTA eval step (``make_eval_step``: pose
    decode, parsing fusion with ``preset``'s flip pairs; the joint flip
    index follows from the joint count)."""
    crop = hp["crop"]
    return E.make_eval_step(model, flip_pairs=preset.flip_pairs,
                            decode_hw=(crop[1], crop[0]),
                            **_eval_kw(hp, preset))


def make_eval_step(model, hp: dict, preset=LIP):
    """The train CLI's eval step: ``make_ppp_eval_step`` for PPP, the
    LIP protocol otherwise."""
    if preset.name == "ppp":
        return E.make_ppp_eval_step(model, **_eval_kw(hp, preset))
    return make_lip_eval_step(model, hp, preset)


def validate(state: T.TrainState, eval_step, val_loader, preset=LIP,
             log_fn=print, gt_csv: str | None = None,
             pred_csv: str | None = None) -> dict:
    """Flip-TTA validation of the state's model in eval mode:
    ``validate_ppp`` (heatmap PCK, its table logged) for PPP, else
    ``validate`` (with ``gt_csv`` and ``pred_csv``, the PCKh table too)."""
    state.model.eval()
    if preset.name == "ppp":
        return E.validate_ppp(eval_step, state.lamdas, val_loader,
                              num_classes=preset.num_classes,
                              num_joints=preset.num_joints, log_fn=log_fn)
    return E.validate(eval_step, state.lamdas, val_loader,
                      num_classes=preset.num_classes, gt_csv=gt_csv,
                      pred_csv=pred_csv, log_fn=log_fn)


def merge_pretrained(state: T.TrainState, directory: str,
                     log_fn=print) -> tuple[int, int]:
    """Merge the supernet weights of a search-CLI checkpoint directory
    (its ``best`` checkpoint, else the latest epoch's) into the state's
    model (``load_pretrained_params``); returns the (loaded,
    shape-skipped) counts."""
    weights, meta = CheckpointManager(directory).model_state()
    if weights is None:
        raise FileNotFoundError(f"no search checkpoint in {directory}")
    log_fn(f"merging the pretrained search state of {directory} "
           f"(meta {meta})")
    loaded, skipped = load_pretrained_params(state.model, weights, log_fn)
    return len(loaded), len(skipped)


def start_ranks(p: argparse.ArgumentParser, args) -> tuple:
    """(this rank's device, whether this call started the process group)
    for a CLI: under torchrun it joins the group (NCCL on the card, gloo
    on the CPU); ``--zero`` needs one; on the card fp32 convs run without
    TF32."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is False")
    started = mesh.initialize_distributed(device)
    if getattr(args, "zero", False) and mesh.data_group() is None:
        p.error("--zero shards the optimizer over the ranks: launch with "
                "python -m torch.distributed.run")
    if device.type == "cuda":
        # fp32 convs (the last head convs, the decode blur) in full fp32.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return mesh.local_device(device), started


def refuse_under_group(p: argparse.ArgumentParser, started: bool,
                       flag: str, missing: str) -> None:
    """``p.error`` where a process group is up: ``flag`` runs in one
    process (``core/graphs.one_process``); a group this CLI started is
    ended first."""
    try:
        one_process(flag, missing)
    except ValueError as err:
        if started:
            torch.distributed.destroy_process_group()
        p.error(str(err))


def add_resume_jax_argument(p: argparse.ArgumentParser, what: str) -> None:
    p.add_argument("--resume-jax", default="", metavar="STATE.npz",
                   help=f"continue an npp_tpu run from its {what} as a flat "
                        f".npz (npp_tpu's keys; see the README)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_cfg_argument(p, opts=True)
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic data shaped as the dataset's")
    p.add_argument("--data-root", default="",
                   help="dataset directory (default: the YAML's data/LIP/ "
                        "or data/pascal_data/)")
    p.add_argument("--gt-csv", default="",
                   help="LIP pose ground-truth CSV: adds PCKh to each "
                        "validation")
    p.add_argument("--steps", type=int, default=0,
                   help="limit steps per epoch (0 = full)")
    p.add_argument("--epochs", type=int, default=0,
                   help="number of epochs (0 = the configuration's: 190 for "
                        "LIP, 150 for PPP)")
    p.add_argument("--tiny", action="store_true",
                   help="L=8, C=8, 128x128, batch 4")
    p.add_argument("--fast-aug", action="store_true",
                   help="LIP from disk: the fused-warp reader "
                        "(FastLIPDataset) for the train and val sets")
    p.add_argument("--genotype", default="",
                   help="genotype JSON from a search run (best_genotype.json)")
    p.add_argument("--pretrained-encoder", default="",
                   help="search-CLI checkpoint directory whose supernet "
                        "weights are merged in where names and shapes match")
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", default="bfloat16",
                   choices=("bfloat16", "float32"),
                   help="model compute dtype (the flagship's is bfloat16)")
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest epoch checkpoint")
    add_resume_jax_argument(p, "TrainState")
    p.add_argument("--out", default="output",
                   help="root of the run's output and log directories")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--zero", action="store_true",
                   help="ZeRO-1: shard optimizer moments over the "
                        "data-parallel ranks (parallel/zero.py); frees ~2 "
                        "param copies per card at one parameter broadcast "
                        "per step")
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="K train steps a dispatch: one CUDA graph replay on "
                        "the card (one process only)")
    return p


def main(argv=None) -> dict:
    p = build_parser()
    args = p.parse_args(argv)
    preset = resolve_preset(p, args)
    data_root = data_source(p, args, preset)
    if args.fast_aug and (data_root is None or preset.name != "lip"):
        p.error("--fast-aug is the LIP directory's fused-warp reader: drop "
                "--synthetic and --dataset ppp")
    if args.resume and args.resume_jax:
        p.error("--resume and --resume-jax both restore the state: give one")

    if args.steps_per_dispatch < 1:
        p.error("--steps-per-dispatch must be at least 1")

    device, started = start_ranks(p, args)
    if args.steps_per_dispatch > 1:
        refuse_under_group(p, started, "--steps-per-dispatch",
                           "npp_tpu's ZeRO steps_per_dispatch")
    model_kw, hp = preset.train_config(args.tiny)
    logger, out_dir, tb_dir = create_logger(
        args.out, os.path.join(args.out, "log"), preset.name,
        "tiny" if args.tiny else "flagship", "augment")
    writer = MetricWriter(tb_dir)
    merged = None
    try:
        if args.genotype:
            model_kw = dict(model_kw)
            model_kw["inter"], model_kw["fusion"] = load_genotypes(
                args.genotype)
            logger.info(f"loaded searched genotypes from {args.genotype}")
        train_loader, val_loader = build_loaders(hp, device, preset,
                                                 data_root, args.seed,
                                                 args.fast_aug)
        if args.steps:
            train_loader = LimitedLoader(train_loader, args.steps)
            val_loader = LimitedLoader(val_loader, max(1, args.steps // 2))
        state = init_state(model_kw, hp, device=device,
                           dtype=getattr(torch, args.dtype), seed=args.seed,
                           steps_per_epoch=max(1, len(train_loader)),
                           group=mesh.data_group(), zero=args.zero)
        logger.info(f"device {device}; rank {mesh.rank()} of "
                    f"{mesh.world_size()}; state initialised")

        ckpt = CheckpointManager(os.path.join(out_dir, "checkpoints"))
        begin_epoch, best_iou, best_pck = hp["begin_epoch"], 0.0, 0.0
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
        if args.pretrained_encoder:
            merged = merge_pretrained(state, args.pretrained_encoder,
                                      logger.info)

        scanned = args.steps_per_dispatch > 1
        train_step = make_train_step(hp, preset, scanned)
        eval_step = make_eval_step(state.model, hp, preset)
        gt_csv = pose_gt_csv(args, preset, data_root)
        epochs = args.epochs or hp["epochs"]
        gstep, train_loss, result = 0, float("nan"), None
        for epoch in range(begin_epoch, epochs):
            train_loader.set_epoch(epoch)
            if scanned:
                train_loss, gstep = engine.train_epoch_scanned(
                    train_step, state, train_loader, epoch=epoch,
                    steps_per_dispatch=args.steps_per_dispatch,
                    logger=logger, writer=writer, global_step=gstep)
            else:
                train_loss, gstep = engine.train_epoch(
                    train_step, state, train_loader, epoch=epoch,
                    logger=logger, writer=writer,
                    print_freq=hp["print_freq"], global_step=gstep)
            result = validate(
                state, eval_step, val_loader, preset, logger.info,
                gt_csv=gt_csv,
                pred_csv=(os.path.join(out_dir, "pose_pred.csv")
                          if gt_csv else None))
            miou = result["mean_iou"]
            # PCKh only against a GT CSV; PPP's heatmap PCK always.
            pck = result.get("pck_avg", 0.0)
            logger.info(f"epoch {epoch}: train loss {train_loss:.4f} val "
                        f"loss {result['loss']:.4f} mIoU {miou:.4f} "
                        f"PCK {pck:.2f}")
            writer.scalar("valid_mIoU", miou, epoch)
            writer.scalar("valid_loss", result["loss"], epoch)
            is_best = engine.is_best_checkpoint(miou, pck, best_iou,
                                                best_pck)
            if is_best:
                best_iou, best_pck = miou, pck
            ckpt.save(epoch, state,
                      metrics={"best_iou": best_iou, "best_pck": best_pck,
                               "mean_iou": miou, "pck": pck,
                               "train_loss": train_loss},
                      is_best=is_best,
                      tag="final" if epoch == epochs - 1 else None)
        ckpt.wait()
        logger.info(f"done: best mIoU {best_iou:.4f} best PCK "
                    f"{best_pck:.2f}")
    finally:
        writer.close()
        close_logger(logger)
        if started:
            torch.distributed.destroy_process_group()
    return {"state": state, "train_loss": train_loss, "result": result,
            "out_dir": out_dir, "checkpoints": ckpt.directory,
            "merged": merged, "begin_epoch": begin_epoch}


if __name__ == "__main__":
    main()
