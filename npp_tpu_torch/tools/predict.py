"""Serving CLI: images in, palette parsing PNGs and a LIP keypoint CSV out.

Port of ``tools/predict.py``: streams a directory (or glob) of images
through ``core.predictor.Predictor`` and writes ``<stem>.png`` palette
parsings and one ``pose_pred.csv`` in the LIP protocol. Images are read
without cv2 or PIL through ``utils/vis.read_image``: ``.jpg`` /
``.jpeg`` (baseline JPEG, the host decoder of ``data/imgproc.py``),
``.png`` (8-bit grey, RGB or RGBA) and ``.npy`` holding (H, W, 3) uint8
RGB; any other file named by ``--images`` is refused with the format
named, and so is a JPEG the decoder does not read (progressive,
arithmetic-coded, 12-bit, CMYK, a turning EXIF orientation). The
flagship model is built in (bf16 + channels_last on the card);
``--cfg`` takes npp_tpu's LIP experiment YAML instead
(``config.load_preset``; a PPP file is refused), and ``--tiny`` is the
test one. As npp_tpu's, it serves the fused-neck and fused sibling-cell
layouts by default (``--no-fuse-necks``, ``--no-fuse-cells``, or
``--no-fuse`` for both, serve the standard graph); ``--int8`` serves the
dense convs in int8 with dynamic activation scales.

Examples:
  python -m npp_tpu_torch.tools.predict --cfg experiments/lip/384_384.yaml \\
      --synthetic 4 --tiny --out preds/ --batch 2
  python -m npp_tpu_torch.tools.predict --ckpt output/lip/augment/flagship/checkpoints \\
      --images demo/ --out preds/
  python -m npp_tpu_torch.tools.predict --synthetic 4 --tiny --device cpu \\
      --dtype float32 --out preds/
  python -m npp_tpu_torch.tools.predict --synthetic 4 --int8 --no-fuse
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from npp_tpu_torch.core.loading import load_eval_model
from npp_tpu_torch.core.predictor import Predictor
from npp_tpu_torch.tools.augment_lip import add_cfg_argument, resolve_preset
from npp_tpu_torch.utils.metrics import save_pose_csv
from npp_tpu_torch.utils.vis import (check_readable, read_image,
                                     save_parsing_png)


_IMAGE_EXTENSIONS = (".png", ".npy", ".jpg", ".jpeg", ".bmp")


def parse_pose_scales(spec: str) -> tuple:
    """The ``--pose-scales`` comma list: blanks skipped, duplicates dropped
    (one would weigh its scale twice in the average)."""
    scales: list = []
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        try:
            val = float(tok)
        except ValueError:
            raise SystemExit(f"--pose-scales: {tok!r} is not a number "
                             f"(expected e.g. 0.8,1.0,1.2)")
        if val not in scales:
            scales.append(val)
    if not scales:
        raise SystemExit("--pose-scales: no scales given")
    return tuple(scales)


def gather_images(spec: str) -> list[str]:
    """The image files of a directory, or the files of a glob, sorted."""
    if os.path.isdir(spec):
        paths = sorted(p for p in glob.glob(os.path.join(spec, "*"))
                       if p.lower().endswith(_IMAGE_EXTENSIONS))
    else:
        paths = sorted(glob.glob(spec))
    if not paths:
        raise SystemExit(f"no images match {spec!r}")
    return paths


def synthetic_images(n: int, seed: int = 0) -> list[np.ndarray]:
    """``n`` random uint8 RGB images, (200 + 8 * (i % 3), 160, 3)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, (200 + 8 * (i % 3), 160, 3)).astype(np.uint8)
            for i in range(n)]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_cfg_argument(p, datasets=False)
    p.add_argument("--ckpt", default="",
                   help="train-CLI checkpoint directory or flax .npz (empty "
                        "= random weights from --seed, smoke only)")
    p.add_argument("--genotype", default="",
                   help="searched-genotype JSON (best_genotype.json) to "
                        "build the net from; must match the checkpoint")
    p.add_argument("--images", default="", help="image directory or glob")
    p.add_argument("--out", default="predictions")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--int8", action="store_true",
                   help="serve the dense convs in int8")
    p.add_argument("--fuse-necks", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="serve through the fused-neck graph (exact; on by "
                        "default, as npp_tpu's)")
    p.add_argument("--fuse-cells", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="merge same-input sibling edges inside cells into "
                        "K-wide ops (exact; on by default, as npp_tpu's)")
    p.add_argument("--no-fuse", action="store_true",
                   help="neither fusion (--no-fuse-necks --no-fuse-cells)")
    p.add_argument("--no-flip", action="store_true", help="no flip TTA")
    p.add_argument("--dark", action="store_true",
                   help="DARK sub-pixel keypoint decode (arXiv:1910.06278)")
    p.add_argument("--pose-scales", default="",
                   help="comma list of scale multipliers for scale-list "
                        "pose TTA, e.g. 0.8,1.0,1.2 (must include 1.0)")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="predict N random images instead of --images")
    p.add_argument("--tiny", action="store_true",
                   help="the test model (L=8, C=8, 128x128)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", default="bfloat16",
                   choices=("bfloat16", "float32"),
                   help="model compute dtype (the flagship's is bfloat16)")
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv=None) -> dict:
    p = build_parser()
    args = p.parse_args(argv)
    preset = resolve_preset(p, args, lip_only=True)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is False")
    if device.type == "cuda":
        # fp32 convs (the last head convs, an fp32 model) in full fp32.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    pose_scales = (parse_pose_scales(args.pose_scales)
                   if args.pose_scales else (1.0,))
    if args.no_fuse:
        args.fuse_necks = args.fuse_cells = False

    if args.synthetic:
        names = [f"synthetic_{i:03d}" for i in range(args.synthetic)]
        images = iter(synthetic_images(args.synthetic))
    else:
        paths = gather_images(args.images)
        names = [os.path.splitext(os.path.basename(p))[0] for p in paths]
        if len(set(names)) != len(names):
            dupes = sorted({n for n in names if names.count(n) > 1})
            raise SystemExit(
                f"duplicate image stems would overwrite outputs: {dupes}")
        for path in paths:  # refuse an unread format before any work
            try:
                check_readable(path)
            except ValueError as e:
                raise SystemExit(str(e))
        images = (read_image(p) for p in paths)

    model, size, config = load_eval_model(
        args.ckpt, tiny=args.tiny, genotype=args.genotype, device=device,
        dtype=getattr(torch, args.dtype), seed=args.seed, preset=preset)
    pred = Predictor(model, crop_size=size, flip_test=not args.no_flip,
                     dark_decode=args.dark, pose_scales=pose_scales,
                     quantize="int8" if args.int8 else None,
                     fuse_necks=args.fuse_necks, fuse_cells=args.fuse_cells)
    del model  # the Predictor serves its own twin or copy when it fuses
    os.makedirs(args.out, exist_ok=True)
    parsings, keypoints = [], []
    for name, result in zip(names, pred.predict_stream(
            images, batch_size=args.batch)):
        save_parsing_png(result["parsing"],
                         os.path.join(args.out, f"{name}.png"),
                         num_cls=config["num_classes"])
        parsings.append(result["parsing"])
        keypoints.append(result["keypoints"])
    csv_path = None
    if config["num_joints"] == 16:
        csv_path = os.path.join(args.out, "pose_pred.csv")
        save_pose_csv(names, np.stack(keypoints)[..., :2], csv_path)
    print(f"wrote {len(keypoints)} parsings to {args.out}"
          + ("" if csv_path is None else " + pose_pred.csv"))
    return {"names": names, "parsings": parsings, "keypoints": keypoints,
            "out": args.out, "csv": csv_path}


if __name__ == "__main__":
    main()
