"""Weight bridge: a flax NPPNet, SearchNet or context-head variable tree
-> the port's state_dict.

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
``npp_tpu/utils/torch_convert.py:373-508``; ``roll_search_layout`` is
its inverse).
The mapping is a fixed rule on the path, because the port's modules
carry the flax names (``utils/torch_convert.py:62-208`` matched modules
by ordinal buckets instead):

- a list member ``name_<i>`` becomes ``name.<i>`` (``cells1_3`` ->
  ``cells1.3``); compact children ``Conv_<k>``, ``BatchNorm_<k>`` and
  ``DilConvS_<k>``, and the context heads' ``_ConvBN_<k>`` and
  ``StripPooling_<k>`` (``ops/heads.py``), keep their names; a
  parameter at the top of the tree (an architecture parameter) keeps
  its name;
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
(``vcells_*``, ``vstem_*``), which the port does not run.

The whole state of a run crosses too. ``load_jax_state(state, tree)``
loads an npp_tpu ``TrainState`` or ``SearchState``, given as its flat
tree (npp_tpu's own keys, ``jax.tree_util.keystr(path, simple=True,
separator="/")`` over ``tree_flatten_with_path``, as an ``.npz`` holds
it), into the port's state: the variables and lambdas as above, and the
optimizer state, each optax group's Adam count and moments into the
port's optimizer group of the same name, the schedule's count into the
update count and the scheduler. ``jax_state_tree(state)`` is its
inverse, for npp_tpu to restore by key. Jax-free: it reads numpy arrays
only.
"""
from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch
import torch.nn as nn

_COMPACT = re.compile(
    r"^(Conv|BatchNorm|DilConvS|_ConvBN|StripPooling)_\d+$")
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


def _nest(flat) -> dict:
    """'/'-joined keys -> the nested dict."""
    tree: dict = {}
    for key, value in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def load_npz(path: str) -> dict:
    """A flax variable tree saved as ``.npz`` with '/'-joined keys
    (``params/stem0/Conv_0/Conv_0/kernel``) -> the nested dict."""
    with np.load(path) as f:
        return _nest({key: f[key] for key in f.files})


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


def _stack(trees: list[dict]) -> dict:
    """``n`` subtrees of one structure -> one subtree of leaves stacked on a
    new leading axis of ``n``."""
    return {k: (_stack([t[k] for t in trees]) if hasattr(v, "items")
                else np.stack([np.asarray(t[k]) for t in trees]))
            for k, v in trees[0].items()}


def _roll_fusion_cell(cell: dict, steps: int = 4) -> dict:
    out = {k: v for k, v in cell.items() if not k.startswith("ops_")}
    offset = 0
    for i in range(steps):
        out[f"step_ops_{i}"] = _stack([cell[f"ops_{offset + j}"]
                                       for j in range(3 + i)])
        offset += 3 + i
    return out


def _roll_injections(tree: dict, p1, p2, diag, grp, offsets, diag_srcs,
                     grp_dests) -> dict:
    out = dict(tree)
    for i, j in diag_srcs:
        k = offsets[i] + j
        out[f"{diag}_{i}"] = _stack([out.pop(f"{p1}_{k}"),
                                     out.pop(f"{p2}_{k}")])
    for g, (j, dests) in enumerate(sorted(grp_dests.items())):
        n_d, cores, node = len(dests), [], {}
        for s, prefix in ((0, p1), (1, p2)):
            for d, i in enumerate(dests):
                sub = dict(out.pop(f"{prefix}_{offsets[i] + j}"))
                if "proj" in sub:
                    node[f"projs_{s * n_d + d}"] = sub.pop("proj")
                cores.append(sub)
        node["core"] = _stack(cores)
        out[f"{grp}_{g}"] = node
    return out


def roll_search_layout(tree: dict, steps: int = 4) -> dict:
    """One collection of a SearchNet tree in the unrolled layout -> the
    default vmapped one that npp_tpu's search CLI builds: the inverse of
    ``unroll_search_layout``, the stacking order of ``npp_tpu/utils/
    torch_convert.py:373-508``; other trees come back as they are."""
    out = {k: (_roll_fusion_cell(v, steps)
               if k.startswith(("pose_net_", "par_net_")) and "ops_0" in v
               else v)
           for k, v in tree.items()}
    if "inj_ops1_0" in out:
        out = _roll_injections(
            out, "inj_ops1", "inj_ops2", "inj_diag", "inj_grp", _ENC_OFFSETS,
            [(i, i) for i in range(4)],
            {j: tuple(range(j + 1, 4)) for j in range(3)})
    if "up_inj_ops1_0" in out:
        out = _roll_injections(
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


# -- the whole train or search state: npp_tpu's TrainState / SearchState ----

@dataclasses.dataclass(frozen=True)
class _Optax:
    """One ``optax.multi_transform`` of an npp_tpu state and the port's
    optimizer that runs it: the state's field, the port state's optimizer
    and scheduler attributes, the index of ``scale_by_adam`` in each
    group's chain, and the groups whose chain ends in a schedule (its
    count at the next index)."""
    field: str
    optimizer: str
    scheduler: str | None
    adam: int
    scheduled: tuple


# ``make_train_optimizer``: adam(schedule) for weights and backbone,
# adam(1e-4) for criterion. ``make_search_optimizers``: the same for
# weights and criterion (arch set to zero), and arch's chain(
# add_decayed_weights, scale_by_adam, scale) alone in the arch optimizer.
_TRAIN_OPTAX = (_Optax("opt_state", "optimizer", "scheduler", 0,
                       ("weights", "backbone")),)
_SEARCH_OPTAX = (_Optax("w_opt_state", "w_optimizer", "w_scheduler", 0,
                        ("weights",)),
                 _Optax("a_opt_state", "a_optimizer", None, 1, ()))
_OPT_LEAF = re.compile(
    r"^inner_states/([^/]+)/inner_state/(\d+)/(count|mu|nu)(?:/(.+))?$")
_FUSED = re.compile(r"^(neck[12]|sib_\d+)$")


def _is_search(state) -> bool:
    from npp_tpu_torch.core.search import SearchState
    return isinstance(state, SearchState)


def _jax_path(key: str, conv_modules) -> tuple[str, tuple[str, ...]]:
    """(collection, flax path) of state_dict ``key``: the inverse of
    ``torch_key`` for the standard layout. ``conv_modules`` names the
    modules that are convs (npp_tpu wraps each in a ``Conv`` whose inner
    ``Conv_0`` holds the kernel and bias)."""
    mod, _, leaf = key.rpartition(".")
    if not mod:
        return "params", (leaf,)  # an architecture parameter
    names: list[str] = []
    for m in mod.split("."):
        if m.isdigit():
            names[-1] += f"_{m}"
        else:
            names.append(m)
    if leaf in ("running_mean", "running_var"):
        path = ("batch_stats", (*names, leaf.removeprefix("running_")))
    elif mod in conv_modules:
        path = ("params", (*names, "Conv_0",
                           "kernel" if leaf == "weight" else leaf))
    else:
        path = ("params", (*names, "scale" if leaf == "weight" else leaf))
    if torch_key(*path) != key:
        raise KeyError(f"state_dict key {key} has no flax path")
    return path


def _whole(model: nn.Module) -> dict:
    """state_dict key -> (whole shape, the tensor) of ``model``; a tensor-
    parallel model's sharded leaves take their global width on dim 0."""
    from npp_tpu_torch.parallel.tensor import sharding_of
    tp = sharding_of(model)
    out = {}
    for k, t in model.state_dict().items():
        shape = tuple(t.shape)
        if tp is not None and k in tp.sharded:
            shape = (tp.sharded[k],) + shape[1:]
        out[k] = (shape, t)
    return out


def _from_flax(value, path, shape, like, where: str) -> torch.Tensor:
    """A flax leaf as a CPU tensor of ``shape`` (conv kernels HWIO -> OIHW)
    in ``like``'s dtype and strides, as torch's Adam makes its moments
    (``zeros_like``): a moment in another layout from its parameter (NCHW
    beside a channels_last weight) would push the foreach update off its
    fast path. ``shape`` may differ from ``like``'s on dim 0 (a tensor-
    parallel block's whole tensor), which is outermost in either layout."""
    arr = np.asarray(value)
    if path[-1] == "kernel":
        arr = arr.transpose(3, 2, 0, 1)
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"{where}: npp_tpu shape {arr.shape} != port shape "
                         f"{tuple(shape)}")
    arr = np.ascontiguousarray(arr)
    src = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
    if tuple(shape) == tuple(like.shape):
        out = torch.empty_like(like, device="cpu")
    else:
        out = torch.empty_strided(tuple(shape), like.stride(),
                                  dtype=like.dtype)
    return out.copy_(src)


def _to_flax(t: torch.Tensor, path) -> np.ndarray:
    arr = t.detach().float().cpu().numpy()
    return arr.transpose(2, 3, 1, 0) if path[-1] == "kernel" else arr


def _parse_optax(field: str, leaves: dict, opt: _Optax) -> dict:
    """The leaves under ``field`` (keys below it) -> {group: {"count",
    "schedule", "mu", "nu"}} with the moments as nested trees."""
    groups: dict = {}
    for key, value in leaves.items():
        hit = _OPT_LEAF.match(key)
        if hit is None:
            raise KeyError(f"npp_tpu leaf {field}/{key} maps to nothing in "
                           f"the port's optimizer state")
        label, index, kind, rest = hit.groups()
        g = groups.setdefault(label, {"count": None, "schedule": None,
                                      "mu": {}, "nu": {}})
        index = int(index)
        if kind == "count" and rest is None and index == opt.adam:
            g["count"] = int(value)
        elif (kind == "count" and rest is None and index == opt.adam + 1
              and label in opt.scheduled):
            g["schedule"] = int(value)
        elif kind in ("mu", "nu") and rest and index == opt.adam:
            g[kind][rest] = value
        else:
            raise KeyError(f"npp_tpu leaf {field}/{key} maps to nothing in "
                           f"the port's optimizer state")
    for g in groups.values():
        for kind in ("mu", "nu"):
            g[kind] = _nest(g[kind])
    return groups


def _moment_leaves(tree: dict, search: bool):
    """(where, flax path, value) of a moment tree ``{"model": ...,
    "criterion": ...}``; ``where`` is ("model", state_dict key) or
    ("criterion", lambda name)."""
    extra = set(tree) - {"model", "criterion"}
    if extra:
        raise KeyError(f"moments of {sorted(extra)} map to nothing")
    model = tree.get("model", {})
    if search:
        model = unroll_search_layout(model)
    for path, value in _flatten(model):
        yield ("model", torch_key("params", path)), path, value
    for name, value in tree.get("criterion", {}).items():
        yield ("criterion", name), (name,), value


def _where_of(state) -> dict:
    """id of each parameter -> ("model", state_dict key) or ("criterion",
    lambda name)."""
    where = {id(p): ("model", k) for k, p in state.model.named_parameters()}
    where.update({id(p): ("criterion", k) for k, p in state.lamdas.items()})
    return where


def _opt_blob(state, opt: _Optax, parsed: dict, whole: dict, step: int,
              search: bool) -> dict:
    """The whole optimizer state_dict that ``parsed`` (one field's groups)
    gives the port's optimizer after ``step`` updates."""
    optimizer = getattr(state, opt.optimizer)
    where_of = _where_of(state)
    group_of = {where_of[id(p)]: g["name"] for g in optimizer.param_groups
                for p in g["params"]}
    moments: dict = {}
    for label, g in parsed.items():
        for kind in ("mu", "nu"):
            for where, path, value in _moment_leaves(g[kind], search):
                leaf = (f"{opt.field}/inner_states/{label}/inner_state/"
                        f"{opt.adam}/{kind}/{where[0]}/{'/'.join(path)}")
                if where not in group_of:
                    raise KeyError(f"npp_tpu leaf {leaf} maps to nothing in "
                                   f"the port's {opt.optimizer}")
                if group_of[where] != label:
                    raise ValueError(
                        f"npp_tpu leaf {leaf} is in group {label!r}, the "
                        f"port's {where[1]} in {group_of[where]!r}: the "
                        f"group labels differ (an npp_tpu optimizer made "
                        f"with backbone_lr_scale=False?)")
                moments[kind, where] = (path, value, leaf)
    scheduler = getattr(state, opt.scheduler) if opt.scheduler else None
    entries, groups, index = {}, [], 0
    for i, group in enumerate(optimizer.param_groups):
        label = group["name"]
        g = parsed.get(label)
        base = f"{opt.field}/inner_states/{label}/inner_state"
        if g is None or g["count"] is None:
            raise KeyError(f"{base}/{opt.adam}/count: no such npp_tpu leaf")
        count, lr = g["count"], group["lr"]
        if label in opt.scheduled:
            if g["schedule"] is None:
                raise KeyError(f"{base}/{opt.adam + 1}/count: no such "
                               f"npp_tpu leaf")
            if g["schedule"] != step:
                raise ValueError(
                    f"{base}/{opt.adam + 1}/count is {g['schedule']}, step "
                    f"{step}: the port runs one LambdaLR per optimizer, at "
                    f"the update count")
        if scheduler is not None:
            lr = group["initial_lr"] * scheduler.lr_lambdas[i](step)
        ids = []
        for p in group["params"]:
            where = where_of[id(p)]
            ids.append(index)
            if count > 0:
                pair = [moments.get((kind, where)) for kind in ("mu", "nu")]
                if None in pair:
                    raise ValueError(
                        f"{opt.field}/inner_states/{label}: count {count} "
                        f"but no moments of {where[0]}/{where[1]}")
                shape, like = (whole[where[1]] if where[0] == "model"
                               else (tuple(p.shape), p))
                m, v = (_from_flax(value, path, shape, like, leaf)
                        for path, value, leaf in pair)
                entries[index] = {"step": torch.tensor(float(count)),
                                  "exp_avg": m, "exp_avg_sq": v}
            index += 1
        groups.append({**{k: v for k, v in group.items() if k != "params"},
                       "lr": lr, "params": ids})
    unknown = set(parsed) - {g["name"] for g in optimizer.param_groups}
    if unknown:
        raise KeyError(f"npp_tpu groups {sorted(unknown)} of {opt.field} map "
                       f"to nothing in the port's {opt.optimizer}")
    return {"state": entries, "param_groups": groups}


def _scheduler_blob(scheduler, count: int) -> dict:
    blob = scheduler.state_dict()
    blob.update(last_epoch=count, _step_count=count + 1,
                _last_lr=[base * f(count) for base, f in
                          zip(scheduler.base_lrs, scheduler.lr_lambdas)])
    return blob


def load_jax_state(state, tree: dict):
    """Load an npp_tpu ``TrainState`` or ``SearchState`` into the port's
    ``TrainState`` / ``SearchState`` ``state`` in place and return it.

    ``tree`` maps npp_tpu's keys (``jax.tree_util.keystr(path, simple=
    True, separator="/")`` over ``tree_flatten_with_path(state)``) to numpy
    arrays, as ``dict(np.load(path))`` of such an ``.npz`` gives them; its
    ``meta/*`` scalars are left to the caller. The weights, running
    statistics and lambdas load as ``load_jax_variables`` loads them;
    ``crit_accum`` becomes the lambdas' ``.grad``; each optax group's Adam
    count and moments become the ``step``, ``exp_avg`` and ``exp_avg_sq``
    of each parameter of the port's group of that name (none for a count
    of 0: torch creates Adam's state at the first update); the schedule's
    count and ``step`` become the update count, the scheduler's position
    and the groups' learning rates. BN's ``num_batches_tracked``, which
    npp_tpu does not keep and the port's BN does not read, becomes the
    count of train-mode forwards that the counts imply (the updates; a
    search adds the arch updates). A search tree comes in npp_tpu's
    default vmapped layout or the unrolled one.

    It goes through ``core/checkpoint.load_state_dict``, so ZeRO-1 and
    tensor-parallel states each keep their share. It raises, naming the
    leaf, on a leaf that maps to nothing, a group label the port's
    optimizer does not hold it under, moments missing where a count is
    above 0, schedule counts that disagree with each other or with
    ``step``, a shape mismatch, and merged-stream or fused trees."""
    from npp_tpu_torch.core import checkpoint
    search = _is_search(state)
    opts = _SEARCH_OPTAX if search else _TRAIN_OPTAX
    tops = {"step", "params", "batch_stats", "meta"} | {
        o.field for o in opts} | (set() if search else {"crit_accum"})
    for key in tree:
        if key.split("/", 1)[0] not in tops:
            raise KeyError(f"npp_tpu leaf {key} maps to nothing in the "
                           f"port's {type(state).__name__}")
    nested = _nest(tree)
    if "step" not in nested or "model" not in nested.get("params", {}):
        raise KeyError("not an npp_tpu state tree: it has no step or no "
                       "params/model")
    step = int(nested["step"])
    params = nested["params"]
    extra = set(params) - {"model", "criterion"}
    if extra:
        raise KeyError(f"npp_tpu leaves params/{sorted(extra)[0]}/... map "
                       f"to nothing")
    variables = {"params": params["model"],
                 "batch_stats": nested.get("batch_stats", {})}
    for collection, t in variables.items():
        for path, _ in _flatten(t):
            if any(_FUSED.match(m) for m in path):
                raise ValueError(
                    f"npp_tpu leaf {collection}/{'/'.join(path)} is in a "
                    f"fused serving layout: training runs in the standard "
                    f"layout")
    whole = _whole(state.model)
    model = {}
    for collection, t in variables.items():
        for path, value in _flatten(unroll_search_layout(t)):
            key = torch_key(collection, path)
            where = f"{collection}/{'/'.join(path)}"
            if key not in whole:
                raise KeyError(f"npp_tpu leaf {where} maps to nothing "
                               f"({key})")
            shape, like = whole[key]
            model[key] = _from_flax(value, path, shape, like, where)

    blob: dict = {"step": step}
    arch_count = 0
    for opt in opts:
        leaves = {k[len(opt.field) + 1:]: v for k, v in tree.items()
                  if k.startswith(opt.field + "/")}
        parsed = _parse_optax(opt.field, leaves, opt)
        blob[opt.optimizer] = _opt_blob(state, opt, parsed, whole, step,
                                        search)
        if opt.scheduler:
            blob[opt.scheduler] = _scheduler_blob(
                getattr(state, opt.scheduler), step)
        else:  # the arch optimizer: its updates are forwards too
            arch_count = parsed["arch"]["count"]
    for key, (shape, like) in whole.items():
        if key.endswith("num_batches_tracked"):
            model[key] = torch.tensor(step + arch_count, dtype=like.dtype)
    missing = set(whole) - set(model)
    if missing:
        raise KeyError(f"{len(missing)} state_dict keys have no npp_tpu "
                       f"leaf, e.g. {sorted(missing)[:5]}")
    blob["model"] = model

    crit = params.get("criterion", {})
    if set(crit) != set(state.lamdas):
        raise KeyError(f"criterion lambdas {sorted(crit)} != "
                       f"{sorted(state.lamdas)}")
    blob["lamdas"] = {k: _from_flax(crit[k], (k,), tuple(p.shape), p,
                                    f"params/criterion/{k}")
                      for k, p in state.lamdas.items()}
    if not search:
        accum = nested.get("crit_accum")
        if accum is None and state.criterion_grad_accum:
            raise ValueError(
                "the tree has no crit_accum (npp_tpu ran without "
                "criterion_grad_accum): build the port's state with "
                "criterion_grad_accum=False")
        if accum is not None and set(accum) != set(state.lamdas):
            raise KeyError(f"crit_accum {sorted(accum)} != "
                           f"{sorted(state.lamdas)}")
        blob["crit_accum"] = {
            k: (torch.zeros_like(p.detach(), device="cpu") if accum is None
                else _from_flax(accum[k], (k,), tuple(p.shape), p,
                                f"crit_accum/{k}"))
            for k, p in state.lamdas.items()}
    return checkpoint.load_state_dict(state, blob)


def _group_counts(blob: dict, name: str) -> dict:
    """Group name -> the Adam count of its parameters in an optimizer
    state_dict (0 before the first update); npp_tpu keeps one a group."""
    out = {}
    for g in blob["param_groups"]:
        steps = {int(blob["state"][i]["step"]) if i in blob["state"] else 0
                 for i in g["params"]}
        if len(steps) > 1:
            raise ValueError(f"{name} group {g['name']!r}: its parameters "
                             f"hold different Adam counts; npp_tpu keeps one "
                             f"per group")
        out[g["name"]] = steps.pop() if steps else 0
    return out


def jax_state_tree(state) -> dict | None:
    """The port's ``TrainState`` / ``SearchState`` as npp_tpu's flat tree
    (the keys ``load_jax_state`` reads, optax's masked leaves absent, a
    search in npp_tpu's default vmapped layout): ``np.savez(path,
    **tree)`` writes the exchange file. Under ZeRO or tensor parallelism
    every rank calls it (a collective) and rank 0 gets the tree, the
    others None."""
    from npp_tpu_torch.core import checkpoint
    from npp_tpu_torch.parallel import mesh
    blob = checkpoint.state_dict(state)
    if not mesh.is_primary():
        return None
    search = _is_search(state)
    roll = roll_search_layout if search else (lambda t: t)
    convs = {k.rsplit(".", 1)[0] for k, t in blob["model"].items()
             if k.endswith(".weight") and t.dim() == 4}
    variables: dict = {"params": {}, "batch_stats": {}}
    for key, t in blob["model"].items():
        if not key.endswith("num_batches_tracked"):
            collection, path = _jax_path(key, convs)
            variables[collection][path] = _to_flax(t, path)
    tree = {"step": np.asarray(state.step, np.int32)}
    for collection, flat in variables.items():
        sub = roll(_nest({"/".join(p): v for p, v in flat.items()}))
        prefix = "params/model" if collection == "params" else collection
        tree.update({f"{prefix}/{'/'.join(p)}": v for p, v in _flatten(sub)})
    for k, t in blob["lamdas"].items():
        tree[f"params/criterion/{k}"] = _to_flax(t, (k,))
    if not search and state.criterion_grad_accum:
        for k, t in blob["crit_accum"].items():
            tree[f"crit_accum/{k}"] = _to_flax(t, (k,))

    for opt in _SEARCH_OPTAX if search else _TRAIN_OPTAX:
        ob, where_of = blob[opt.optimizer], _where_of(state)
        order = [where_of[id(p)] for g in getattr(state, opt.optimizer)
                 .param_groups for p in g["params"]]
        counts = _group_counts(ob, opt.optimizer)
        for g in ob["param_groups"]:
            label = g["name"]
            base = f"{opt.field}/inner_states/{label}/inner_state"
            tree[f"{base}/{opt.adam}/count"] = np.asarray(counts[label],
                                                          np.int32)
            if label in opt.scheduled:
                tree[f"{base}/{opt.adam + 1}/count"] = np.asarray(
                    getattr(state, opt.scheduler).last_epoch, np.int32)
            for kind, name in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                parts: dict = {"model": {}, "criterion": {}}
                for i in g["params"]:
                    part, key = order[i]
                    entry = ob["state"].get(i)
                    if part == "model":
                        path, t = _jax_path(key, convs)[1], blob["model"][key]
                    else:
                        path, t = (key,), blob["lamdas"][key]
                    arr = _to_flax(t if entry is None else entry[name], path)
                    parts[part]["/".join(path)] = (np.zeros_like(arr)
                                                   if entry is None else arr)
                parts["model"] = roll(_nest(parts["model"]))
                for p, v in _flatten(parts):
                    tree[f"{base}/{opt.adam}/{kind}/{'/'.join(p)}"] = v
    return tree
