"""Weight bridge: a flax NPPNet variable tree -> the port's state_dict.

``load_jax_variables(model, variables_np)`` takes the flax
``{"params": ..., "batch_stats": ...}`` tree of numpy arrays (standard
layout) and copies every leaf into the port's parameters and buffers.
It also takes the tree of a JAX ``TrainState``'s parameters,
``{"params": {"model": ..., "criterion": {"lamda_pose", "lamda_par"}},
"batch_stats": ...}``: the model part loads as above, and the lambdas
load into ``lamdas`` (the port's train-state lambdas) when it is given.
Adam's moments are not carried across.
The mapping is a fixed rule on the path, because the port's modules
carry the flax names (``utils/torch_convert.py:62-208`` matched modules
by ordinal buckets instead):

- a list member ``name_<i>`` becomes ``name.<i>`` (``cells1_3`` ->
  ``cells1.3``); compact children ``Conv_<k>`` and ``BatchNorm_<k>`` keep
  their names;
- the inner ``Conv_0`` of the JAX ``Conv`` wrapper is dropped
  (``.../Conv_1/Conv_0/kernel`` -> ``...Conv_1.weight``);
- leaves: conv ``kernel`` HWIO -> ``weight`` OIHW (depthwise (3,3,1,C) ->
  (C,1,3,3)), conv ``bias`` -> ``bias``, BN ``scale``/``bias`` ->
  ``weight``/``bias``, ``batch_stats`` ``mean``/``var`` ->
  ``running_mean``/``running_var``.

It raises on a flax leaf that maps to no key, on a key no leaf fills
(BN's ``num_batches_tracked`` counter aside), on a shape mismatch, and on
merged-stream trees (``vcells_*``, ``vstem_*``), which the port does not
run. Jax-free: it reads numpy arrays only.
"""
from __future__ import annotations

import re

import numpy as np
import torch
import torch.nn as nn

_COMPACT = re.compile(r"^(Conv|BatchNorm)_\d+$")
_LIST_MEMBER = re.compile(r"^(.+)_(\d+)$")
_PARAM_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def torch_key(collection: str, path: tuple[str, ...]) -> str:
    """The state_dict key that flax leaf ``collection/path`` maps to."""
    if path[0].startswith(("vcells_", "vstem_")):
        raise ValueError(
            f"merged-stream variable {'/'.join(path)}: the port runs the "
            f"standard layout only; unmerge the tree first")
    *mods, leaf = path
    if leaf in ("kernel", "bias") and len(mods) >= 2 and mods[-1] == "Conv_0":
        mods = mods[:-1]  # the JAX Conv wrapper's inner nn.Conv
    names = []
    for m in mods:
        hit = _LIST_MEMBER.match(m)
        if hit and not _COMPACT.match(m):
            names += [hit.group(1), hit.group(2)]
        else:
            names.append(m)
    table = _PARAM_LEAF if collection == "params" else _STAT_LEAF
    if collection not in ("params", "batch_stats") or leaf not in table:
        raise KeyError(f"unmapped flax leaf {collection}/{'/'.join(path)}")
    return ".".join(names + [table[leaf]])


def load_npz(path: str) -> dict:
    """A flax variable tree saved as ``.npz`` with '/'-joined keys
    (``params/stem0/Conv_0/Conv_0/kernel``) -> the nested dict."""
    tree: dict = {}
    with np.load(path) as f:
        for key in f.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = f[key]
    return tree


def _split_train_tree(variables_np: dict) -> tuple[dict, dict | None]:
    """(the flax model tree, the criterion lambdas or None) of a plain
    model tree or of a ``TrainState``-shaped one."""
    params = variables_np.get("params", {})
    if "model" not in params:
        return variables_np, None
    extra = set(params) - {"model", "criterion"}
    if extra:
        raise KeyError(f"unmapped train-state params {sorted(extra)}")
    return dict(variables_np, params=params["model"]), params.get("criterion")


def load_jax_variables(model: nn.Module, variables_np: dict,
                       lamdas: dict | None = None) -> nn.Module:
    """Copy a flax NPPNet tree (numpy leaves) into ``model`` in place; with
    a ``TrainState``-shaped tree and ``lamdas``, copy its lambdas too."""
    variables_np, crit = _split_train_tree(variables_np)
    if lamdas is not None and crit is not None:
        if set(crit) != set(lamdas):
            raise KeyError(f"criterion lambdas {sorted(crit)} != "
                           f"{sorted(lamdas)}")
        with torch.no_grad():
            for k, p in lamdas.items():
                arr = np.asarray(crit[k], np.float32)
                if tuple(arr.shape) != tuple(p.shape):
                    raise ValueError(f"{k}: flax shape {arr.shape} != "
                                     f"torch shape {tuple(p.shape)}")
                p.copy_(torch.from_numpy(arr))
    state = model.state_dict()
    filled = set()
    for collection in variables_np:
        for path, value in _flatten(variables_np[collection]):
            key = torch_key(collection, path)
            if key not in state:
                raise KeyError(f"unmapped flax leaf "
                               f"{collection}/{'/'.join(path)} -> {key}")
            arr = np.asarray(value, np.float32)
            if path[-1] == "kernel":
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            if tuple(arr.shape) != tuple(state[key].shape):
                raise ValueError(f"{key}: flax shape {arr.shape} != torch "
                                 f"shape {tuple(state[key].shape)}")
            with torch.no_grad():
                state[key].copy_(torch.from_numpy(np.ascontiguousarray(arr)))
            filled.add(key)
    missing = [k for k in state
               if k not in filled and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"{len(missing)} state_dict keys have no flax leaf, "
                       f"e.g. {missing[:5]}")
    return model
