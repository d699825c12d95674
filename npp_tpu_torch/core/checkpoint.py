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
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import torch

from npp_tpu_torch.core.search import SearchState
from npp_tpu_torch.core.train import TrainState

_STATE_FILE = "state.pt"
_NAMED = ("best", "warmed", "final")


def state_dict(state: TrainState | SearchState) -> dict:
    """Everything a resumed run needs, as tensors and plain values."""
    if isinstance(state, SearchState):
        return {
            "model": state.model.state_dict(),
            "lamdas": {k: p.detach() for k, p in state.lamdas.items()},
            "w_optimizer": state.w_optimizer.state_dict(),
            "w_scheduler": state.w_scheduler.state_dict(),
            "a_optimizer": state.a_optimizer.state_dict(),
            "step": state.step,
        }
    return {
        "model": state.model.state_dict(),
        "lamdas": {k: p.detach() for k, p in state.lamdas.items()},
        "crit_accum": {k: (torch.zeros_like(p) if p.grad is None
                           else p.grad.detach())
                       for k, p in state.lamdas.items()},
        "optimizer": state.optimizer.state_dict(),
        "scheduler": state.scheduler.state_dict(),
        "step": state.step,
    }


def load_state_dict(state: TrainState | SearchState, blob: dict):
    """Load ``blob`` (from ``state_dict``) into ``state`` in place."""
    state.model.load_state_dict(blob["model"])
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
    state.optimizer.load_state_dict(blob["optimizer"])
    state.scheduler.load_state_dict(blob["scheduler"])
    state.step = int(blob["step"])
    return state


def _write(path: str, state, meta: dict, meta_path: str) -> None:
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, _STATE_FILE)
    tmp = f"{target}.{os.getpid()}.tmp"
    torch.save(state_dict(state), tmp)
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
        or ``final``)."""
        if tag is not None and tag not in _NAMED:
            raise ValueError(f"tag must be one of {_NAMED}, got {tag!r}")
        meta = {"epoch": int(epoch), **(metrics or {})}
        _write(self._epoch_dir(epoch), state, meta, self._meta_file(epoch))
        for old in self._epochs()[:-self.max_to_keep]:
            shutil.rmtree(self._epoch_dir(old))
            if os.path.isfile(self._meta_file(old)):
                os.remove(self._meta_file(old))
        for name in (("best",) if is_best else ()) + ((tag,) if tag else ()):
            path = os.path.join(self.directory, name)
            _write(path, state, meta, os.path.join(path, "meta.json"))

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

    def restore_named(self, state, name: str = "best"):
        path = os.path.join(self.directory, name)
        if not os.path.isfile(os.path.join(path, _STATE_FILE)):
            return None, None
        _read(path, state)
        return state, _read_meta(os.path.join(path, "meta.json"), {})
