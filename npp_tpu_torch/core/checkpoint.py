"""Checkpoints of the train state and of the search state.

Port of ``npp_tpu/core/checkpoint.py:24-110``: one manager per run
directory, an epoch checkpoint each epoch (the ``max_to_keep`` newest
kept) and named mirrors (``best``, ``warmed``, ``final``), with the
free-form metrics in JSON beside them. Storage is ``torch.save`` of the
model's state_dict (the supernet's holds its architecture parameters),
the lambdas, the optimizers' and the scheduler's state_dicts and the
update count; a train state adds the lambdas' accumulated gradients, a
search state the arch optimizer's state_dict:
``<dir>/<epoch>/state.pt`` with ``<dir>/meta_<epoch>.json``, and
``<dir>/<name>/state.pt`` with ``<dir>/<name>/meta.json``. Saves are
synchronous, so ``wait`` has nothing to wait for.

Under a process group every rank calls ``save`` (a ZeRO optimizer's state
is consolidated on rank 0 inside it, a collective), rank 0 alone writes,
and a barrier follows; every rank restores from the shared files onto
its own device. The blob holds the bare model's state_dict (never a DDP
wrapper's ``module.`` keys) and the whole optimizer state, so a
checkpoint written by N ranks, with or without ZeRO, restores in one
process and the other way round. A tensor-parallel model's channel
blocks (``parallel/tensor.py``) and their Adam moments are gathered over
its model group before rank 0 writes (every rank calls ``save``), so the
blob holds whole tensors under the unchanged keys; a restore into such a
model loads them and keeps this rank's blocks.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Optional

import torch

from npp_tpu_torch.core.search import SearchState
from npp_tpu_torch.core.train import TrainState
from npp_tpu_torch.parallel import mesh, tensor
from npp_tpu_torch.parallel.zero import (load_optimizer_state_dict,
                                         optimizer_state_dict)

_STATE_FILE = "state.pt"
_NAMED = ("best", "warmed", "final")
# The supernet's modules that npp_tpu saves stacked, in its default
# vmapped layout (``utils/convert.unroll_search_layout`` unstacks them):
# the encoder's and the decoder's injection ops and the fusion cells'
# candidate ops. No NPPNet parameter path coincides with a stacked leaf,
# so npp_tpu's merge takes none of them.
_STACKED_IN_JAX = re.compile(
    r"^(inj_ops[12]|up_inj_ops[12])\.|^(pose_net|par_net)\.\d+\.ops\.")


def state_dict(state: TrainState | SearchState) -> dict:
    """Everything a resumed run needs, as tensors and plain values. Under
    ZeRO or tensor parallelism every rank calls it, and under ZeRO the
    optimizer entries are None off rank 0."""
    if isinstance(state, SearchState):
        return {
            "model": state.model.state_dict(),
            "lamdas": {k: p.detach() for k, p in state.lamdas.items()},
            "w_optimizer": optimizer_state_dict(state.w_optimizer),
            "w_scheduler": state.w_scheduler.state_dict(),
            "a_optimizer": optimizer_state_dict(state.a_optimizer),
            "step": state.step,
        }
    return {
        "model": tensor.whole_state_dict(state.model),
        "lamdas": {k: p.detach() for k, p in state.lamdas.items()},
        "crit_accum": {k: (torch.zeros_like(p) if p.grad is None
                           else p.grad.detach())
                       for k, p in state.lamdas.items()},
        "optimizer": optimizer_state_dict(state.optimizer, state.model),
        "scheduler": state.scheduler.state_dict(),
        "step": state.step,
    }


def load_state_dict(state: TrainState | SearchState, blob: dict):
    """Load ``blob`` (from ``state_dict``) into ``state`` in place."""
    tensor.load_whole_state_dict(state.model, blob["model"])
    if isinstance(state, SearchState):
        with torch.no_grad():
            for k, p in state.lamdas.items():
                p.copy_(blob["lamdas"][k])
        state.w_optimizer.load_state_dict(blob["w_optimizer"])
        state.w_scheduler.load_state_dict(blob["w_scheduler"])
        state.a_optimizer.load_state_dict(blob["a_optimizer"])
        state.step = int(blob["step"])
        return state
    with torch.no_grad():
        for k, p in state.lamdas.items():
            p.copy_(blob["lamdas"][k])
            p.grad = blob["crit_accum"][k].to(p.device).clone()
    load_optimizer_state_dict(state.optimizer, blob["optimizer"], state.model)
    state.scheduler.load_state_dict(blob["scheduler"])
    state.step = int(blob["step"])
    return state


def _write(path: str, blob: dict, meta: dict, meta_path: str) -> None:
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, _STATE_FILE)
    tmp = f"{target}.{os.getpid()}.tmp"
    torch.save(blob, tmp)
    os.replace(tmp, target)
    with open(meta_path, "w") as f:
        json.dump(meta, f)


def _read(path: str, state):
    # Loaded on the CPU: each load_state_dict moves what it takes to its
    # parameters' device, and Adam keeps its step counts on the CPU (a
    # count on the card would make every update read it back).
    blob = torch.load(os.path.join(path, _STATE_FILE), map_location="cpu",
                      weights_only=True)
    return load_state_dict(state, blob)


def _read_meta(path: str, default: dict) -> dict:
    if not os.path.isfile(path):
        return default
    with open(path) as f:
        return json.load(f)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _epoch_dir(self, epoch: int) -> str:
        return os.path.join(self.directory, str(int(epoch)))

    def _meta_file(self, epoch: int) -> str:
        return os.path.join(self.directory, f"meta_{int(epoch)}.json")

    def _epochs(self) -> list[int]:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.isfile(
                          os.path.join(self.directory, d, _STATE_FILE)))

    def save(self, epoch: int, state,
             metrics: Optional[dict] = None, is_best: bool = False,
             tag: Optional[str] = None) -> None:
        """Save the epoch checkpoint, drop the ones beyond ``max_to_keep``,
        and mirror it to ``best`` (``is_best``) and to ``tag`` (``warmed``
        or ``final``). Under a process group every rank calls it and rank
        0 writes."""
        if tag is not None and tag not in _NAMED:
            raise ValueError(f"tag must be one of {_NAMED}, got {tag!r}")
        blob = state_dict(state)
        if mesh.is_primary():
            self._write_all(epoch, blob, metrics, is_best, tag)
        mesh.barrier()

    def _write_all(self, epoch, blob, metrics, is_best, tag) -> None:
        meta = {"epoch": int(epoch), **(metrics or {})}
        _write(self._epoch_dir(epoch), blob, meta, self._meta_file(epoch))
        for old in self._epochs()[:-self.max_to_keep]:
            shutil.rmtree(self._epoch_dir(old))
            if os.path.isfile(self._meta_file(old)):
                os.remove(self._meta_file(old))
        for name in (("best",) if is_best else ()) + ((tag,) if tag else ()):
            path = os.path.join(self.directory, name)
            _write(path, blob, meta, os.path.join(path, "meta.json"))

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def latest_epoch(self) -> Optional[int]:
        epochs = self._epochs()
        return epochs[-1] if epochs else None

    def restore(self, state, epoch: Optional[int] = None):
        """Load the epoch checkpoint (the latest by default) into ``state``;
        returns (state, meta), or (None, None) when there is none."""
        epoch = self.latest_epoch() if epoch is None else int(epoch)
        if epoch is None:
            return None, None
        _read(self._epoch_dir(epoch), state)
        return state, _read_meta(self._meta_file(epoch), {"epoch": epoch})

    def model_state(self):
        """The model state_dict (on the CPU) of the ``best`` checkpoint,
        else of the latest epoch's, and that checkpoint's meta; (None,
        None) when the directory holds no checkpoint."""
        best = os.path.join(self.directory, "best")
        if os.path.isfile(os.path.join(best, _STATE_FILE)):
            path, meta = best, os.path.join(best, "meta.json")
        else:
            epoch = self.latest_epoch()
            if epoch is None:
                return None, None
            path, meta = self._epoch_dir(epoch), self._meta_file(epoch)
        blob = torch.load(os.path.join(path, _STATE_FILE), map_location="cpu",
                          weights_only=True)
        return blob["model"], _read_meta(meta, {})

    def restore_model(self, model):
        """Load the model weights of the ``best`` checkpoint, else of the
        latest epoch's, into ``model``; returns the checkpoint's meta, or
        None when the directory holds no checkpoint."""
        weights, meta = self.model_state()
        if weights is None:
            return None
        tensor.load_whole_state_dict(model, weights)
        return meta

    def restore_named(self, state, name: str = "best"):
        path = os.path.join(self.directory, name)
        if not os.path.isfile(os.path.join(path, _STATE_FILE)):
            return None, None
        _read(path, state)
        return state, _read_meta(os.path.join(path, "meta.json"), {})


def load_pretrained_params(model, pretrained: dict, log_fn=print):
    """Shape-tolerant merge of a search checkpoint's supernet weights into
    ``model`` (an NPPNet), in place, as ``npp_tpu/core/checkpoint.py:
    112-137`` merges a search state's parameters: a parameter whose name
    is in ``pretrained`` (a SearchNet state_dict) with the same shape is
    copied; one whose shapes differ keeps its value and is logged as
    shape-skipped; the rest keep theirs. Parameters only: npp_tpu merges
    no batch statistics and no loss lambdas. The supernet's parameters
    that npp_tpu stores stacked (``_STACKED_IN_JAX``) take no part, so the
    counts are npp_tpu's. Returns (loaded names, shape-skipped names)."""
    loaded, skipped, n_params = [], [], 0
    with torch.no_grad():
        for name, param in model.named_parameters():
            n_params += 1
            value = pretrained.get(name)
            if value is None or _STACKED_IN_JAX.match(name):
                continue
            if tuple(value.shape) == tuple(param.shape):
                param.copy_(value)
                loaded.append(name)
            else:
                log_fn(f"skip {name}: shape {tuple(value.shape)} != "
                       f"{tuple(param.shape)}")
                skipped.append(name)
    log_fn(f"pretrained merge: {len(loaded)} loaded, {len(skipped)} "
           f"shape-skipped, {n_params - len(loaded) - len(skipped)} without "
           f"a counterpart, of {n_params} parameters")
    return loaded, skipped
