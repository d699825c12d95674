"""Parsing test CLI: multi-scale evaluation or palette PNG export.

Port of ``tools/test_lip.py``: ``--mode testval`` runs the multi-scale
sliding-window evaluation at the configuration's ``TEST.SCALE_LIST``
((0.5, 0.75, 1, 1.25, 1.5) in ``experiments/lip/384_384.yaml``; (0.5,
1.0) under ``--tiny``) and prints the parsing metrics; ``--mode test``
writes palette PNGs at scale 1.0; both flip as ``TEST.FLIP_TEST`` says
(True in the YAML). The flagship model is built in (bf16 + channels_last on the
card); ``--cfg`` takes npp_tpu's LIP experiment YAML instead
(``config.load_preset``; a PPP file is refused), and ``--tiny`` is the
test one. Data: the test set of a LIP
directory (``--data-root``, by default the YAML's ``data/LIP/``; TEST's
annotation file over the val images and labels, its first ``--limit``
entries, all for 0), unaugmented at batch 1, or with ``--synthetic``
``--limit`` synthetic images (4 for 0).

``--mesh`` splits each image's multi-scale windows over the ranks of a
``python -m torch.distributed.run`` launch (a data grid over the world,
as npp_tpu's ``make_mesh()`` over its devices; ``core/multiscale.py``):
every rank reads every image, the exp-logit sums are added over the
ranks, and rank 0 prints the metrics or writes the PNGs. npp_tpu's CLI
has no space flag, and neither has this one.

Examples:
  python -m npp_tpu_torch.tools.test_lip --data-root data/LIP \\
      --ckpt output/lip/augment/flagship/checkpoints --mode testval
  python -m npp_tpu_torch.tools.test_lip --synthetic --mode testval --limit 2
  python -m npp_tpu_torch.tools.test_lip --synthetic --tiny --mode test \\
      --device cpu --dtype float32 --out preds/
  python -m torch.distributed.run --standalone --nproc_per_node=2 \\
      -m npp_tpu_torch.tools.test_lip --synthetic --tiny --mesh
"""
from __future__ import annotations

import argparse

import torch

from npp_tpu_torch.core import test_seg
from npp_tpu_torch.core.loading import load_eval_model
from npp_tpu_torch.data.lip import dataset_for
from npp_tpu_torch.data.loader import DataLoader
from npp_tpu_torch.data.synthetic import SyntheticDataset
from npp_tpu_torch.config import IGNORE, SIGMA
from npp_tpu_torch.parallel import mesh as M
from npp_tpu_torch.tools.augment_lip import (add_cfg_argument, data_source,
                                             resolve_preset, start_ranks)

TINY_SCALES = (0.5, 1.0)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_cfg_argument(p, datasets=False)
    p.add_argument("--mode", choices=("testval", "test"), default="testval")
    p.add_argument("--ckpt", default="",
                   help="train-CLI checkpoint directory or flax .npz (empty "
                        "= random weights from --seed, smoke only)")
    p.add_argument("--out", default="test_results")
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic LIP-shaped data")
    p.add_argument("--data-root", default="",
                   help="LIP directory (default: the YAML's data/LIP/)")
    p.add_argument("--tiny", action="store_true",
                   help="the test model (L=8, C=8, 128x128)")
    p.add_argument("--limit", type=int, default=0,
                   help="images to run (0 = 4 synthetic ones, or every LIP "
                        "test entry)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", default="bfloat16",
                   choices=("bfloat16", "float32"),
                   help="model compute dtype (the flagship's is bfloat16)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh", action="store_true",
                   help="split each image's multi-scale windows over the "
                        "ranks of a torchrun launch (data axis)")
    return p


def main(argv=None) -> dict:
    p = build_parser()
    args = p.parse_args(argv)
    args.preset = resolve_preset(p, args, lip_only=True)
    data_root = data_source(p, args, args.preset)
    if not args.mesh:
        device = torch.device(args.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise SystemExit("--device cuda: torch.cuda.is_available() is "
                             "False")
        if device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        return run(args, data_root, device, None)
    device, started = start_ranks(p, args)
    if not torch.distributed.is_initialized():
        p.error("--mesh splits the windows over the ranks: launch with "
                "python -m torch.distributed.run")
    try:
        return run(args, data_root, device,
                   M.make_grid(M.world_size(), 1))
    finally:
        if started:
            torch.distributed.destroy_process_group()


def run(args, data_root, device, grid) -> dict:
    """The test of ``main``'s arguments on ``device``; with ``grid`` this
    rank's windows of every image."""
    model, size, config = load_eval_model(
        args.ckpt, tiny=args.tiny, device=device,
        dtype=getattr(torch, args.dtype), seed=args.seed, preset=args.preset)
    if data_root is None:
        ds = SyntheticDataset(length=args.limit or 4, crop_size=size,
                              num_joints=config["num_joints"],
                              num_classes=config["num_classes"],
                              is_train=False)
    else:  # host-normalised images, as the JAX CLI's
        ds = dataset_for(args.preset.data, "test", data_root,
                         crop_size=size, sigma=SIGMA, is_train=False,
                         sample=args.limit or -1, **args.preset.reader)
    loader = DataLoader(ds, 1, device=device, num_workers=4,
                        process_index=0, process_count=1)
    apply_fn = test_seg.make_parsing_apply_fn(model)
    crop_hw = (size[1], size[0])
    flip = args.preset.test["flip_test"]
    if args.mode == "testval":
        metrics = test_seg.testval(
            apply_fn, loader, num_classes=config["num_classes"],
            scales=(TINY_SCALES if args.tiny
                    else args.preset.test["scale_list"]), flip=flip,
            crop_size=crop_hw, ignore=IGNORE, mesh=grid)
        if M.is_primary():
            print(f"pixel_acc {metrics['pixel_acc']:.4f} "
                  f"mean_acc {metrics['mean_acc']:.4f} "
                  f"mIoU {metrics['mean_iou']:.4f} "
                  f"fwIoU {metrics['fw_iou']:.4f}")
        return metrics
    paths = test_seg.test(apply_fn, loader, args.out,
                          num_classes=config["num_classes"], scales=(1.0,),
                          flip=flip, crop_size=crop_hw, mesh=grid)
    if M.is_primary():
        print(f"wrote {len(paths)} parsing PNGs to {args.out}")
    return {"paths": paths}


if __name__ == "__main__":
    main()
