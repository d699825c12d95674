"""Weight bridge: a flax NPPNet or SearchNet variable tree -> the port's
state_dict.

``load_jax_variables(model, variables_np)`` takes the flax
``{"params": ..., "batch_stats": ...}`` tree of numpy arrays (standard
layout) and copies every leaf into the port's parameters and buffers.
It also takes the tree of a JAX ``TrainState``'s parameters,
``{"params": {"model": ..., "criterion": {"lamda_pose", "lamda_par"}},
"batch_stats": ...}``: the model part loads as above, and the lambdas
load into ``lamdas`` (the port's train-state lambdas) when it is given.
The tree of a JAX ``SearchState`` loads the same way into the port's
``SearchNet``: its architecture parameters (``alphas1``, ...) sit at the
top of the model tree and keep their names. A supernet tree comes in the
unrolled layout (``vmap_fusion=False``, ``vmap_injections=False``) or in
the default vmapped one that ``tools/search_lip.py`` saves; the vmapped
one is unrolled on load (``unroll_search_layout``, a numpy copy of
``npp_tpu/utils/torch_convert.py:373-508``). Adam's moments are not
carried across.
The mapping is a fixed rule on the path, because the port's modules
carry the flax names (``utils/torch_convert.py:62-208`` matched modules
by ordinal buckets instead):

- a list member ``name_<i>`` becomes ``name.<i>`` (``cells1_3`` ->
  ``cells1.3``); compact children ``Conv_<k>``, ``BatchNorm_<k>`` and
  ``DilConvS_<k>`` keep their names; a parameter at the top of the tree
  (an architecture parameter) keeps its name;
- the inner ``Conv_0`` of the JAX ``Conv`` wrapper is dropped
  (``.../Conv_1/Conv_0/kernel`` -> ``...Conv_1.weight``);
- leaves: conv ``kernel`` HWIO -> ``weight`` OIHW (depthwise (3,3,1,C) ->
  (C,1,3,3)), conv ``bias`` -> ``bias``, BN ``scale``/``bias`` ->
  ``weight``/``bias``, ``batch_stats`` ``mean``/``var`` ->
  ``running_mean``/``running_var`` (an affine-free BN has only these).

NPPNet trees in npp_tpu's fused serving layouts (``neck1`` / ``neck2``
and the cells' ``sib_<g>`` groups, as ``fuse_neck_variables`` and
``fuse_sibling_variables`` emit them) load by the same rule into a port
model built in the same layout. So do npp_tpu's int8 collections, into a
model that ``ops/quantize.prepare_int8`` has prepared: ``qconst``
``qkernel`` (HWIO int8) -> the conv's ``qweight`` ((Cout, kh * kw * Cin),
the kernel's order) and ``wscale`` -> ``wscale``, and ``act_scales``
``scale`` -> the conv's static ``act_scale``. Those are buffers outside
the ``state_dict``.

A tree of int8 collections alone loads into a model that holds its
weights already. It raises on a flax leaf that maps to no key, on a key
no leaf fills (BN's ``num_batches_tracked`` counter aside), on a shape
mismatch, on an
int8 leaf for a conv that is not prepared, and on merged-stream trees
(``vcells_*``, ``vstem_*``), which the port does not run. Jax-free: it
reads numpy arrays only.
"""
from __future__ import annotations

import re

import numpy as np
import torch
import torch.nn as nn

_COMPACT = re.compile(r"^(Conv|BatchNorm|DilConvS)_\d+$")
_LIST_MEMBER = re.compile(r"^(.+)_(\d+)$")
_TABLES = {
    "params": {"kernel": "weight", "scale": "weight", "bias": "bias"},
    "batch_stats": {"mean": "running_mean", "var": "running_var"},
    "qconst": {"qkernel": "qweight", "wscale": "wscale"},
    "act_scales": {"scale": "act_scale"},
}
_INT8_COLLECTIONS = ("qconst", "act_scales")


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
    if collection == "params" and not mods:
        return leaf  # an architecture parameter
    conv_leaf = (leaf in ("kernel", "bias")
                 or collection in _INT8_COLLECTIONS)
    if conv_leaf and len(mods) >= 2 and mods[-1] == "Conv_0":
        mods = mods[:-1]  # the JAX Conv wrapper's inner nn.Conv
    names = []
    for m in mods:
        hit = _LIST_MEMBER.match(m)
        if hit and not _COMPACT.match(m):
            names += [hit.group(1), hit.group(2)]
        else:
            names.append(m)
    table = _TABLES.get(collection, {})
    if leaf not in table:
        raise KeyError(f"unmapped flax leaf {collection}/{'/'.join(path)}")
    return ".".join(names + [table[leaf]])


def _load_int8_leaf(model: nn.Module, key: str, value) -> None:
    """One ``qconst`` / ``act_scales`` leaf into its prepared conv."""
    from npp_tpu_torch.ops.quantize import Int8Conv2d
    mod_name, attr = key.rsplit(".", 1)
    try:
        conv = model.get_submodule(mod_name)
    except AttributeError:
        raise KeyError(f"int8 leaf {key}: no module {mod_name}") from None
    if not isinstance(conv, Int8Conv2d):
        raise ValueError(f"int8 leaf {key}: {mod_name} is not prepared "
                         f"(ops/quantize.prepare_int8)")
    dev = conv.weight.device
    if attr == "qweight":
        arr = np.asarray(value).astype(np.int8)
        arr = arr.transpose(3, 0, 1, 2).reshape(arr.shape[3], -1)
    else:
        arr = np.asarray(value, np.float32)
    new = torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
    old = getattr(conv, attr)
    if old is not None and tuple(old.shape) != tuple(new.shape):
        raise ValueError(f"{key}: flax shape {arr.shape} != torch shape "
                         f"{tuple(old.shape)}")
    setattr(conv, attr, new)


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


# The default (vmapped) SearchNet layout: the fusion cells' per-step
# stacks ``step_ops_<i>``, and per injection block the diagonal stream
# pairs ``<diag>_<i>`` and the per-source groups ``<grp>_<g>`` (a ``core``
# stacked over [stream 1 destinations, stream 2 destinations] and one
# ``projs_<k>`` per destination). Offsets of each destination group in the
# unrolled ``<p1>_<k>`` / ``<p2>_<k>`` lists.
_ENC_OFFSETS = (0, 1, 3, 6)
_DEC_OFFSETS = (0, 5, 11)


def _dec_dests(j: int) -> tuple:
    return tuple(range(3)) if j <= 3 else tuple(range(j - 3, 3))


def _unstack(tree: dict, n: int) -> list[dict]:
    """A vmapped subtree (every leaf with a leading axis of ``n``) -> the
    ``n`` subtrees."""
    def part(t, m):
        return {k: part(v, m) if hasattr(v, "items") else np.asarray(v)[m]
                for k, v in t.items()}
    return [part(tree, m) for m in range(n)]


def _unroll_fusion_cell(cell: dict, steps: int = 4) -> dict:
    out = {k: v for k, v in cell.items() if not k.startswith("step_ops_")}
    offset = 0
    for i in range(steps):
        for j, sub in enumerate(_unstack(cell[f"step_ops_{i}"], 3 + i)):
            out[f"ops_{offset + j}"] = sub
        offset += 3 + i
    return out


def _unroll_injections(tree: dict, p1, p2, diag, grp, offsets, diag_srcs,
                       grp_dests) -> dict:
    out = dict(tree)
    for i, j in diag_srcs:
        k = offsets[i] + j
        out[f"{p1}_{k}"], out[f"{p2}_{k}"] = _unstack(out.pop(f"{diag}_{i}"),
                                                      2)
    for g, (j, dests) in enumerate(sorted(grp_dests.items())):
        node = out.pop(f"{grp}_{g}")
        n_d = len(dests)
        cores = _unstack(node["core"], 2 * n_d)
        for s, prefix in ((0, p1), (1, p2)):
            for d, i in enumerate(dests):
                sub = dict(cores[s * n_d + d])
                if f"projs_{s * n_d + d}" in node:
                    sub["proj"] = node[f"projs_{s * n_d + d}"]
                out[f"{prefix}_{offsets[i] + j}"] = sub
    return out


def unroll_search_layout(tree: dict, steps: int = 4) -> dict:
    """One collection of a SearchNet tree in the default vmapped layout ->
    the unrolled layout; other trees come back as they are."""
    out = {k: (_unroll_fusion_cell(v, steps)
               if k.startswith(("pose_net_", "par_net_"))
               and "step_ops_0" in v else v)
           for k, v in tree.items()}
    if "inj_diag_0" in out:
        out = _unroll_injections(
            out, "inj_ops1", "inj_ops2", "inj_diag", "inj_grp", _ENC_OFFSETS,
            [(i, i) for i in range(4)],
            {j: tuple(range(j + 1, 4)) for j in range(3)})
    if "up_diag_0" in out:
        out = _unroll_injections(
            out, "up_inj_ops1", "up_inj_ops2", "up_diag", "up_grp",
            _DEC_OFFSETS, [(i, 4 + i) for i in range(3)],
            {j: _dec_dests(j) for j in range(6)})
    return out


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
    """Copy a flax NPPNet or SearchNet tree (numpy leaves) into ``model``
    in place; with a ``TrainState``- or ``SearchState``-shaped tree and
    ``lamdas``, copy its lambdas too."""
    variables_np, crit = _split_train_tree(variables_np)
    variables_np = {c: unroll_search_layout(t)
                    for c, t in variables_np.items()}
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
            if collection in _INT8_COLLECTIONS:
                _load_int8_leaf(model, key, value)
                continue
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
    if missing and set(variables_np) - set(_INT8_COLLECTIONS):
        raise KeyError(f"{len(missing)} state_dict keys have no flax leaf, "
                       f"e.g. {missing[:5]}")
    return model
