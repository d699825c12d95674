"""The serving and test CLIs' model loading: built-in configuration,
optional searched genotype, weights.

After ``npp_tpu/core/loading.py``, with a preset in place of the YAML
(``config.LIP`` by default, or ``config.load_preset``'s): its NPPNet (the
LIP flagship: L=16, C=64, 384x384) or, with ``tiny``, the test one (L=8,
C=8, 128x128).
"""
from __future__ import annotations

import os

import torch

from npp_tpu_torch.config import LIP
from npp_tpu_torch.core.checkpoint import CheckpointManager
from npp_tpu_torch.genotypes import load_genotypes
from npp_tpu_torch.models.augment import build_nppnet
from npp_tpu_torch.utils.convert import load_jax_variables, load_npz


def load_eval_model(ckpt: str = "", *, tiny: bool = False,
                    genotype: str = "", device="cuda",
                    dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                    log_fn=print, preset=LIP):
    """Returns ``(model, size, config)``: an eval-mode NPPNet on ``device``
    (channels_last on a card) with compute dtype ``dtype``, the crop
    ``(width, height)`` and the model's keyword arguments.

    ``genotype`` is a searched-genotype JSON (``best_genotype.json``); the
    net is built from it instead of the released genotypes. ``ckpt`` is
    a checkpoint directory of the train CLI (the ``best`` checkpoint,
    else the latest epoch's) or a flax variable tree saved as ``.npz``;
    empty gives random weights drawn from ``seed``."""
    config, hp = preset.train_config(tiny)
    size = hp["crop"]
    kw = dict(config)
    if genotype:
        kw["inter"], kw["fusion"] = load_genotypes(genotype)
        log_fn(f"building the model from searched genotypes: {genotype}")
    model = build_nppnet(device="cpu",
                         generator=torch.Generator().manual_seed(seed),
                         dtype=dtype, **kw)
    if ckpt.endswith(".npz"):
        load_jax_variables(model, load_npz(ckpt))
        log_fn(f"loaded flax variables from {ckpt}")
    elif ckpt:
        if not os.path.isdir(ckpt):
            raise FileNotFoundError(f"no checkpoint directory {ckpt}")
        meta = CheckpointManager(ckpt).restore_model(model)
        if meta is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt}")
        log_fn(f"loaded checkpoint meta: {meta}")
    model = model.to(device)
    if torch.device(device).type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model, size, kw
