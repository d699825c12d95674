"""Evaluation CLI: the LIP flip-TTA val protocol on the port.

Port of ``tools/eval_lip.py`` for synthetic data (the LIP dataset reader
is not ported yet). The flagship configuration is built in, so no YAML
is read: L=16 cells, C=64, one refinement stage, 20 classes, 16 joints,
384x384 crops, bf16 compute (channels_last on the card). ``--tiny`` is
the small test configuration (L=8, C=8, 128x128). Without ``--ckpt`` the
weights are random, drawn from ``--seed``; ``--ckpt`` loads a flax
variable tree saved as ``.npz`` with '/'-joined keys
(``params/stem0/Conv_0/Conv_0/kernel``, ...).

Examples:
  python -m npp_tpu_torch.tools.eval_lip --synthetic --batch 8 --n 16 \\
      --device cuda
  python -m npp_tpu_torch.tools.eval_lip --synthetic --tiny --n 4 \\
      --batch 2 --device cpu --dtype float32
"""
from __future__ import annotations

import argparse

import torch

from npp_tpu_torch.core import evaluate as E
from npp_tpu_torch.core.criterion import (LIP_CLASS_WEIGHTS,
                                          init_criterion_params)
from npp_tpu_torch.data.loader import DataLoader, make_target_renderer
from npp_tpu_torch.data.synthetic import SyntheticDataset
from npp_tpu_torch.models.augment import build_nppnet
from npp_tpu_torch.utils.convert import load_jax_variables, load_npz
from npp_tpu_torch.utils.metrics import per_class_table

NUM_CLASSES, NUM_JOINTS, SIGMA, IGNORE = 20, 16, 3, 255
FLAGSHIP = dict(num_classes=NUM_CLASSES, num_joints=NUM_JOINTS, layers=16,
                init_channels=64, refine_layers=1)
TINY = dict(FLAGSHIP, layers=8, init_channels=8)


def evaluate_synthetic(model, *, n: int, batch: int, crop_size, device,
                       seed: int = 0) -> dict:
    """Flip-TTA validation of ``model`` over ``n`` synthetic images: the
    loader renders the targets on ``device`` (the heatmap kernel on a
    card), then ``make_eval_step`` + ``validate``."""
    ds = SyntheticDataset(length=n, crop_size=crop_size,
                          num_joints=NUM_JOINTS, num_classes=NUM_CLASSES,
                          seed=seed, device_normalize=True)
    renderer = make_target_renderer(stride=4, sigma=SIGMA,
                                    num_joints=NUM_JOINTS, ignore=IGNORE,
                                    normalize_images=True)
    loader = DataLoader(ds, batch, device=device, num_workers=4,
                        renderer=renderer)
    step = E.make_eval_step(model, num_classes=NUM_CLASSES,
                            class_weights=LIP_CLASS_WEIGHTS, flip_test=True,
                            ignore_index=IGNORE,
                            decode_hw=(crop_size[1], crop_size[0]))
    crit = init_criterion_params(model.refine_layers + 1, device)
    return E.validate(step, crit, loader, num_classes=NUM_CLASSES)


def result_line(result: dict) -> str:
    return (f"n={len(result['names'])} loss={result['loss']:.4f} "
            f"pixel_acc={result['pixel_acc']:.4f} "
            f"mIoU={result['mean_iou']:.4f}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic LIP-shaped data (the only source so far)")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--ckpt", default="",
                   help=".npz of a flax NPPNet variable tree (empty = "
                        "random weights from --seed)")
    p.add_argument("--n", type=int, default=16, help="images to evaluate")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", default="bfloat16",
                   choices=("bfloat16", "float32"),
                   help="model compute dtype (the flagship's is bfloat16)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not args.synthetic:
        p.error("only --synthetic data is ported so far")

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is False")
    if device.type == "cuda":
        # fp32 convs (the decode blur, an fp32 model) in full fp32, not TF32.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg, crop = (TINY, (128, 128)) if args.tiny else (FLAGSHIP, (384, 384))
    model = build_nppnet(device="cpu", generator=torch.Generator()
                         .manual_seed(args.seed),
                         dtype=getattr(torch, args.dtype), **cfg)
    if args.ckpt:
        load_jax_variables(model, load_npz(args.ckpt))
    model = model.to(device)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    result = evaluate_synthetic(model, n=args.n, batch=args.batch,
                                crop_size=crop, device=device,
                                seed=args.seed)
    print(per_class_table(result["per_class_iou"], result["per_class_acc"]))
    print(result_line(result))
    return result


if __name__ == "__main__":
    main()
