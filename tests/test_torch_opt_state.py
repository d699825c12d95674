"""npp_tpu's whole train and search state in the port and back, on the CPU:
``utils/convert.load_jax_state`` and ``jax_state_tree``.

An npp_tpu state crosses as its flat tree: npp_tpu's own keys
(``jax.tree_util.keystr(path, simple=True, separator="/")`` over
``tree_flatten_with_path``), numpy leaves. Here the trees are npp_tpu's
``TrainState`` and ``SearchState`` at L=4, C=8 (LIP: 20 classes, 16
joints; PPP: 7 and 14; the supernet in its default vmapped layout and,
by npp_tpu's own converter, the unrolled one), their variables from
``jax.eval_shape`` filled from a numpy RNG, and their optimizer states
those of npp_tpu's own transforms (``make_train_optimizer``,
``make_search_optimizers``) after seeded updates.

optax's Adam is elementwise, so each transform runs on the parameters of
each of its groups packed into one vector (``_Packing``): the same
transform, its labels taken from the packed tree's paths by npp_tpu's
label functions, at a fraction of the per-leaf dispatch cost; the state
is then unpacked by key onto the structure ``jax.eval_shape(tx.init)``
gives for the real tree, and flattened by npp_tpu's rule.

Tolerances: Adam's update against optax at rtol 1e-6 + atol 1e-7 (optax
rounds its bias corrections to float32 where torch keeps them in double,
``tests/test_torch_train.py``), the moments likewise (torch's ``lerp``
rounds otherwise than optax's multiply-add); the counts, the schedule's
position and every loaded tensor exact; the train step after a load at
``test_torch_train.py``'s bounds (losses rtol 1e-5, gradients by its
per-tensor and norm rule, running stats 1e-4 x max|ref|, the lambdas'
gradients rtol 1e-5); the round trip and the ZeRO-1 and tensor-parallel
loads bit for bit. One JAX program, module-scoped: npp_tpu's
value-and-gradient of ``compute_losses`` (``test_torch_train.py``'s).
"""
import copy
import functools
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from npp_tpu.core import search as jsearch
from npp_tpu.core import train as jtrain
from npp_tpu.models.augment import NPPNet as JNPPNet
from npp_tpu.models.search import SearchNet as JSearchNet
from npp_tpu.utils.torch_convert import (search_default_to_unrolled,
                                         search_unrolled_to_default)

from npp_tpu_torch.core import checkpoint as tckpt
from npp_tpu_torch.core import search as tsearch
from npp_tpu_torch.core import train as ttrain
from npp_tpu_torch.tools import augment_lip, search_lip
from npp_tpu_torch.utils import convert

from test_torch_ops import random_variables
from test_torch_parallel import _env, _free_port, _wait
from test_torch_train import (GRAD_TOL_NORM, LAMDAS, LOSS_KW, _equal_blobs,
                              _grad_errors, _host_batch, _jax_batch, _oihw,
                              _torch_batch)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
SIZE = 64
LIP = dict(num_classes=20, num_joints=16, layers=4, init_channels=8,
           refine_layers=1)
PPP = dict(LIP, num_classes=7, num_joints=14)
LR = 1e-3
OPT = dict(base_lr=LR, lr_step=(2,), lr_factor=0.2, steps_per_epoch=1)
SEARCH_OPT = dict(w_lr=LR, alpha_lr=LR, lr_step=(2,), lr_factor=0.2,
                  steps_per_epoch=1)
ADAM = dict(rtol=1e-6, atol=1e-7)


def _key(path) -> str:
    return jax.tree_util.keystr(path, simple=True, separator="/")


def npp_flat(tree) -> dict:
    """npp_tpu's flat tree of a state: its keys, numpy leaves."""
    return {_key(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def npp_restore(template, tree):
    """npp_tpu's state from a flat tree, by key onto ``template``'s
    structure and dtypes (a state or its ``jax.eval_shape``)."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
    return jax.tree_util.tree_unflatten(treedef, [
        np.asarray(tree[_key(p)], dtype=v.dtype) for p, v in leaves])


class _Packing:
    """One optax transform run on each label's parameters packed into one
    vector (module docstring). ``params`` is the real parameter tree,
    ``packed`` names the packed leaf of each label (the criterion's
    lambdas stay leaves of their own)."""

    def __init__(self, params, label_fn, packed: dict):
        flat = {"/".join(p): np.asarray(v)
                for p, v in flatten_dict(params).items()}
        labels = {"/".join(p): lab for p, lab in
                  flatten_dict(label_fn(params)).items()}
        self.index, ends = {}, {}
        for k, v in flat.items():
            pk = packed.get(labels[k], k)
            start = ends.get(pk, 0)
            self.index[k] = (pk, start, v.shape)
            ends[pk] = start + v.size
        self.real = flat

    def pack(self, real: dict) -> dict:
        """The packed vectors of the real leaves ``real`` holds."""
        parts: dict = {}
        for k, (pk, start, _) in self.index.items():
            if k in real:
                parts.setdefault(pk, []).append((start, np.ravel(real[k])))
        return {pk: np.concatenate([a for _, a in sorted(v, key=lambda t:
                                                         t[0])])
                for pk, v in parts.items()}

    def unpack(self, packed: dict) -> dict:
        return {k: np.asarray(packed[pk][s:s + int(np.prod(shape))]).reshape(
                    shape) for k, (pk, s, shape) in self.index.items()}

    def real_opt_state(self, template, packed_state) -> dict:
        """The flat real optimizer state (keys of ``template``, the
        ``eval_shape`` of ``tx.init`` on the real tree) of a packed one."""
        src = npp_flat(packed_state)
        out = {}
        for key in npp_flat_shapes(template):
            if key.endswith("/count"):
                out[key] = src[key]
                continue
            prefix, kind, rest = re.match(r"^(.*?)/(mu|nu)/(.*)$",
                                          key).groups()
            pk, s, shape = self.index[rest]
            out[key] = src[f"{prefix}/{kind}/{pk}"][
                s:s + int(np.prod(shape))].reshape(shape)
        return out

    def packed_opt_state(self, packed_template, real: dict):
        """The packed optimizer state of a flat real one (keys ``prefix/
        mu|nu/<param key>``)."""
        flat = {}
        for key in npp_flat_shapes(packed_template):
            if key.endswith("/count"):
                flat[key] = real[key]
                continue
            prefix, kind, pk = re.match(r"^(.*?)/(mu|nu)/(.*)$",
                                        key).groups()
            flat[key] = self.pack({k: real[f"{prefix}/{kind}/{k}"]
                                   for k, (p, _, _) in self.index.items()
                                   if p == pk})[pk]
        return npp_restore(packed_template, flat)


def npp_flat_shapes(template) -> list:
    return [_key(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(template)[0]]


def _nest(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        *parents, leaf = k.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _pack_train(params):
    return _Packing(params, lambda p: jtrain._label_params(p, True),
                    {"backbone": "model/stem", "weights": "model/head"})


def _pack_search(params):
    return _Packing(params, jsearch._label_search_params,
                    {"weights": "model/w", "arch": "model/alphas1"})


def _grads(packing, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(0, 1, v.shape).astype(np.float32)
            for k, v in packing.real.items()}


def _update(tx, packing, opt_state, params: dict, grads: dict):
    """One optax update on the packed tree: (new real params, state)."""
    upd, opt_state = tx.update(
        _nest({k: jnp.asarray(v) for k, v in packing.pack(grads).items()}),
        opt_state,
        _nest({k: jnp.asarray(v) for k, v in packing.pack(params).items()}))
    new = optax.apply_updates(_nest(packing.pack(params)), upd)
    return packing.unpack({"/".join(p): np.asarray(v)
                           for p, v in flatten_dict(new).items()}), opt_state


def _model_shapes(module):
    return jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False))


# -- npp_tpu's states ---------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _train_setup(preset: str):
    """npp_tpu's NPPNet variables (seed 0: ``test_torch_train.py``'s for
    LIP), its train optimizer, the packing and ``tx.init``'s structure."""
    kw = LIP if preset == "lip" else PPP
    v = random_variables(_model_shapes(JNPPNet(dtype=jnp.float32, **kw)),
                         seed=0)
    params = {"model": v["params"], "criterion": dict(LAMDAS)}
    tx = jtrain.make_train_optimizer(LR, lr_step=(2,), lr_factor=0.2,
                                     steps_per_epoch=1)
    return v, tx, _pack_train(params), jax.eval_shape(tx.init, params)


@functools.lru_cache(maxsize=None)
def _train_state(preset: str, accum: bool, n_updates: int = 3) -> dict:
    """npp_tpu's TrainState after ``n_updates`` of its optimizer from
    seeded gradients (the boundary at update 2 crossed), as a flat tree,
    with what the next update needs."""
    v, tx, packing, template = _train_setup(preset)
    real = dict(packing.real)
    opt = tx.init(_nest(packing.pack(real)))
    crit = {k: np.zeros(2, np.float32) for k in LAMDAS}
    for i in range(n_updates):
        g = _grads(packing, 100 + i)
        if accum:
            crit = {k: crit[k] + g[f"criterion/{k}"] for k in LAMDAS}
            g.update({f"criterion/{k}": crit[k] for k in LAMDAS})
        real, opt = _update(tx, packing, opt, real, g)
    state = jtrain.TrainState(
        step=np.int32(n_updates), params=_nest(real),
        batch_stats=v["batch_stats"],
        opt_state=npp_restore(template, packing.real_opt_state(template, opt)),
        crit_accum=crit if accum else None)
    return dict(tree=npp_flat(state), state=state, tx=tx, packing=packing,
                opt=opt, real=real, crit=crit, accum=accum,
                kw=LIP if preset == "lip" else PPP, template=template, v=v)


def _port_train(kw=LIP, accum=True, seed=7, **state_kw):
    return ttrain.init_train_state(
        generator=torch.Generator().manual_seed(seed), device="cpu",
        dtype=torch.float32, criterion_grad_accum=accum, **OPT, **kw,
        **state_kw)


def _port_search(seed=7):
    return tsearch.init_search_state(
        generator=torch.Generator().manual_seed(seed), device="cpu",
        dtype=torch.float32, **SEARCH_OPT, **LIP)


def _port_view(flat: dict, search=False) -> dict:
    """Real parameter keys (``model/...``, ``criterion/...``) -> the port's
    name (state_dict key or lambda) and OIHW value, through the existing
    weight bridge's rule."""
    model = _nest({k[6:]: v for k, v in flat.items()
                   if k.startswith("model/")})
    if search:
        model = convert.unroll_search_layout(model)
    out = {convert.torch_key("params", p): _oihw(p, v)
           for p, v in flatten_dict(model).items()}
    out.update({k[10:]: v for k, v in flat.items()
                if k.startswith("criterion/")})
    return out


def _port_tensors(state) -> dict:
    return {**dict(state.model.named_parameters()), **state.lamdas}


def _set_grads(state, grads: dict) -> None:
    """``.grad`` of every parameter and lambda from ``grads`` (port names)."""
    for k, t in _port_tensors(state).items():
        t.grad = torch.from_numpy(np.array(grads[k]))


def _assert_params(state, real: dict, search=False, **tol):
    ref = _port_view(real, search)
    tensors = _port_tensors(state)
    assert set(ref) == set(tensors)
    for k, t in tensors.items():
        np.testing.assert_allclose(t.detach().numpy(), ref[k], err_msg=k,
                                   **(tol or ADAM))


@pytest.fixture(scope="module")
def lip_accum():
    return _train_state("lip", True)


# -- into the port: the next update equals optax's ----------------------------

@pytest.mark.parametrize("accum", [True, False])
@pytest.mark.parametrize("preset", ["lip", "ppp"])
def test_next_update_after_load_matches_optax(lip_accum, preset, accum):
    """Three optax updates (the schedule's boundary before the third), the
    state loaded, then a fourth update from the same gradients on both
    sides: every parameter, lambda, moment and count."""
    run = _train_state(preset, accum)
    packing = run["packing"]
    state = _port_train(run["kw"], accum)
    convert.load_jax_state(state, run["tree"])
    assert state.step == 3 and state.scheduler.last_epoch == 3
    assert {g["name"]: g["lr"] for g in state.optimizer.param_groups} == \
        pytest.approx({"weights": 0.2 * LR, "backbone": 0.04 * LR,
                       "criterion": 1e-4}, rel=1e-12)
    _assert_params(state, run["real"], rtol=0, atol=0)
    for k, p in state.lamdas.items():
        np.testing.assert_array_equal(p.grad.numpy(), run["crit"][k])

    g = _grads(packing, 200)
    if accum:
        crit = {k: run["crit"][k] + g[f"criterion/{k}"] for k in LAMDAS}
        g_ref = dict(g, **{f"criterion/{k}": crit[k] for k in LAMDAS})
    else:
        g_ref = g
    real, opt = _update(run["tx"], packing, run["opt"], run["real"], g_ref)
    state.zero_grad()
    names = _port_view(g)
    tensors = _port_tensors(state)
    torch.autograd.backward(
        list(tensors.values()),
        [torch.from_numpy(np.ascontiguousarray(names[k])) for k in tensors])
    state.apply_update()
    _assert_params(state, real)
    # Moments and counts against optax's, group by group.
    flat = packing.real_opt_state(run["template"], opt)
    name_of = {id(p): k for k, p in tensors.items()}
    for group in state.optimizer.param_groups:
        base = f"inner_states/{group['name']}/inner_state/0"
        refs = {kind: _port_view({k[len(base) + 4:]: v for k, v in
                                  flat.items()
                                  if k.startswith(f"{base}/{kind}/")})
                for kind in ("mu", "nu")}
        assert int(flat[f"{base}/count"]) == 4
        for p in group["params"]:
            entry, k = state.optimizer.state[p], name_of[id(p)]
            assert int(entry["step"]) == 4
            for kind, name in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                np.testing.assert_allclose(entry[name].numpy(),
                                           refs[kind][k],
                                           err_msg=f"{k} {name}", **ADAM)


def test_moments_take_their_parameters_memory_format(lip_accum):
    """A moment in another layout from its parameter pushes torch's
    foreach Adam off its fast path: channels_last parameters (as on a
    card) get channels_last moments, dense ones dense moments."""
    state = _port_train()
    state.model.to(memory_format=torch.channels_last)
    convert.load_jax_state(state, lip_accum["tree"])
    n = 0
    for p in state.model.parameters():
        m = state.optimizer.state[p]["exp_avg"]
        assert m.stride() == p.stride() and m.shape == p.shape
        n += p.dim() == 4 and not p.is_contiguous()
    assert n > 50


# -- the search state -----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _search_setup(layout: str):
    """npp_tpu's supernet variables in ``layout`` (the unrolled one by
    npp_tpu's own converter), both optimizers, the packing and their
    ``tx.init`` structures."""
    if layout == "unrolled":
        v = jax.tree.map(np.asarray, search_default_to_unrolled(
            _search_setup("vmapped")[0]))
    else:
        v = random_variables(_model_shapes(JSearchNet(dtype=jnp.float32,
                                                      **LIP)), seed=3)
    params = {"model": v["params"], "criterion": dict(LAMDAS)}
    txs = jsearch.make_search_optimizers(**SEARCH_OPT)
    return (v, txs, _pack_search(params),
            tuple(jax.eval_shape(t.init, params) for t in txs))


def _search_state(layout: str, w_updates: int, a_updates: int) -> dict:
    v, (w_tx, a_tx), packing, (w_tmpl, a_tmpl) = _search_setup(layout)
    real = dict(packing.real)
    w_opt = w_tx.init(_nest(packing.pack(real)))
    a_opt = a_tx.init(_nest(packing.pack(real)))
    for i in range(w_updates):
        real, w_opt = _update(w_tx, packing, w_opt, real, _grads(packing, i))
        if i < a_updates:
            real, a_opt = _update(a_tx, packing, a_opt, real,
                                  _grads(packing, 50 + i))
    state = jsearch.SearchState(
        step=np.int32(w_updates), params=_nest(real),
        batch_stats=v["batch_stats"],
        w_opt_state=npp_restore(w_tmpl, packing.real_opt_state(w_tmpl,
                                                               w_opt)),
        a_opt_state=npp_restore(a_tmpl, packing.real_opt_state(a_tmpl,
                                                               a_opt)))
    return dict(tree=npp_flat(state), packing=packing, real=real,
                txs=(w_tx, a_tx), opts=(w_opt, a_opt))


@pytest.mark.parametrize("a_updates", [0, 2])
@pytest.mark.parametrize("layout", ["vmapped", "unrolled"])
def test_search_updates_after_load_match_optax(layout, a_updates):
    """Three weight updates and ``a_updates`` arch updates, the state
    loaded (no torch state for the arch Adam at count 0), then a weight
    update and an arch update from the same gradients on both sides."""
    run = _search_state(layout, 3, a_updates)
    packing, search = run["packing"], layout == "vmapped"
    state = _port_search()
    convert.load_jax_state(state, run["tree"])
    assert state.step == 3 and state.w_scheduler.last_epoch == 3
    assert len(state.a_optimizer.state) == (12 if a_updates else 0)
    steps = {int(s["step"]) for s in state.a_optimizer.state.values()}
    assert steps == ({a_updates} if a_updates else set())
    _assert_params(state, run["real"], search, rtol=0, atol=0)

    (w_tx, a_tx), (w_opt, a_opt) = run["txs"], run["opts"]
    real = run["real"]
    for i, (tx, opt, port_opt) in enumerate(
            ((w_tx, w_opt, state.w_optimizer),
             (a_tx, a_opt, state.a_optimizer))):
        g = _grads(packing, 300 + i)
        real, _ = _update(tx, packing, opt, real, g)
        _set_grads(state, _port_view(g, search))
        port_opt.step()
    _assert_params(state, real, search)


def test_roll_search_layout_is_npp_tpus_converter():
    """``roll_search_layout`` of the unrolled tree equals npp_tpu's
    ``search_unrolled_to_default``, leaf for leaf, and
    ``unroll_search_layout`` undoes it."""
    un = _search_setup("unrolled")[0]
    ref = jax.tree.map(np.asarray, search_unrolled_to_default(un))
    for collection in ("params", "batch_stats"):
        got = convert.roll_search_layout(un[collection])
        a, b = flatten_dict(got), flatten_dict(ref[collection])
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))
        back = flatten_dict(convert.unroll_search_layout(got))
        assert back.keys() == flatten_dict(un[collection]).keys()


# -- out of the port and back --------------------------------------------------

def test_exported_state_restores_into_npp_tpu_and_takes_its_update(lip_accum):
    """The port's state after a load and one update, exported: npp_tpu's
    template takes it by key (every key, no other), and npp_tpu's next
    update from it equals the port's."""
    run = lip_accum
    packing, tx = run["packing"], run["tx"]
    state = _port_train()
    convert.load_jax_state(state, run["tree"])
    g = _grads(packing, 400)
    _set_grads(state, _port_view(g))
    state.apply_update()
    tree = convert.jax_state_tree(state)
    npp = npp_flat(run["state"])
    assert set(tree) == set(npp)
    for k, v in tree.items():
        assert (v.dtype, v.shape) == (npp[k].dtype, npp[k].shape), k
    restored = npp_restore(run["state"], tree)
    assert int(restored.step) == 4

    real = {**{"model/" + "/".join(p): np.asarray(v) for p, v in
               flatten_dict(restored.params["model"]).items()},
            **{f"criterion/{k}": np.asarray(v)
               for k, v in restored.params["criterion"].items()}}
    opt = packing.packed_opt_state(
        jax.eval_shape(tx.init, _nest(packing.pack(real))),
        {k[len("opt_state/"):]: v for k, v in tree.items()
         if k.startswith("opt_state/")})
    crit = {k: np.asarray(v) for k, v in restored.crit_accum.items()}
    g = _grads(packing, 401)
    g_ref = dict(g, **{f"criterion/{k}": crit[k] + g[f"criterion/{k}"]
                       for k in LAMDAS})
    real, _ = _update(tx, packing, opt, real, g_ref)
    state.zero_grad()
    tensors = _port_tensors(state)
    names = _port_view(g)
    torch.autograd.backward(
        list(tensors.values()),
        [torch.from_numpy(np.ascontiguousarray(names[k])) for k in tensors])
    state.apply_update()
    _assert_params(state, real)


def test_train_round_trip_is_bit_for_bit(lip_accum):
    """A port state after two real train steps, exported and loaded into a
    state of another seed: every value of the checkpoint blob equal
    (model, running statistics and counters, lambdas and their gradient
    sum, moments, counts, learning rates, the schedule, the count); the
    loaded state takes the same next step."""
    step = ttrain.make_train_step(**LOSS_KW)
    state = _port_train(seed=0)
    convert.load_jax_state(state, lip_accum["tree"])
    for s in (3, 4):
        step(state, _torch_batch(_host_batch(s)))
    other = _port_train(seed=9)
    convert.load_jax_state(other, convert.jax_state_tree(state))
    _equal_blobs(tckpt.state_dict(state), tckpt.state_dict(other))
    a = step(state, _torch_batch(_host_batch(5)))["loss"].item()
    b = step(other, _torch_batch(_host_batch(5)))["loss"].item()
    assert a == b
    _equal_blobs(tckpt.state_dict(state), tckpt.state_dict(other))


def test_search_round_trip_is_bit_for_bit():
    """A port search state after a weight step and an arch step (both
    Adams hold state), through npp_tpu's default vmapped layout and back."""
    weight_step, arch_step = tsearch.make_search_steps(**LOSS_KW)
    state = _port_search(seed=0)
    batch = _torch_batch(_host_batch(3))
    weight_step(state, batch)
    arch_step(state, _torch_batch(_host_batch(4)), 1.0)
    tree = convert.jax_state_tree(state)
    assert "params/model/inj_diag_0/Conv_0/Conv_0/kernel" not in tree
    assert any(k.startswith("params/model/inj_grp_0/core/") for k in tree)
    assert int(tree["a_opt_state/inner_states/arch/inner_state/1/count"]) == 1
    other = _port_search(seed=9)
    convert.load_jax_state(other, tree)
    _equal_blobs(tckpt.state_dict(state), tckpt.state_dict(other))


def test_count_zero_gives_no_torch_state():
    """A fresh state exports counts of 0 and zero moments, and such a tree
    loads with no Adam state at all (torch creates it at the first
    update; a zero entry would change its ``step``)."""
    tree = convert.jax_state_tree(_port_train(seed=0))
    counts = {k: int(v) for k, v in tree.items() if k.endswith("/count")}
    assert counts and set(counts.values()) == {0}
    assert all(not v.any() for k, v in tree.items() if "/mu/" in k)
    state = _port_train()
    convert.load_jax_state(state, tree)
    assert len(state.optimizer.state) == 0 and state.step == 0


# -- refusals -------------------------------------------------------------------

def _without(tree, pattern):
    return {k: v for k, v in tree.items() if not re.search(pattern, k)}


def _relabel_backbone(tree):
    """The backbone's moments in the weights group, as npp_tpu's optimizer
    made with ``backbone_lr_scale=False`` holds them."""
    out = {}
    for k, v in tree.items():
        hit = re.match(r"^opt_state/inner_states/backbone/inner_state/0/"
                       r"(mu|nu)/(.*)$", k)
        out[(f"opt_state/inner_states/weights/inner_state/0/{hit[1]}/"
             f"{hit[2]}") if hit else k] = v
    return out


def _with(tree, **items):
    return {**tree, **{k.replace("__", "/"): v for k, v in items.items()}}


REFUSALS = {
    "unknown_leaf": (lambda t: _with(t, extra__leaf=np.zeros(1)),
                     KeyError, "extra/leaf maps to nothing"),
    "unknown_opt_leaf": (lambda t: _with(
        t, opt_state__inner_states__weights__inner_state__2__count=np.int32(
            3)), KeyError, "inner_state/2/count maps to nothing"),
    "unknown_group": (lambda t: _with(
        t, opt_state__inner_states__arch__inner_state__0__count=np.int32(3)),
        KeyError, r"groups \['arch'\]"),
    "group_labels": (_relabel_backbone, ValueError, "group labels differ"),
    "missing_moment": (lambda t: _without(
        t, r"inner_states/backbone/inner_state/0/nu/model/stem0/"),
        ValueError, "count 3 but no moments"),
    "schedule_vs_step": (lambda t: _with(
        t, opt_state__inner_states__backbone__inner_state__1__count=np.int32(
            2)), ValueError, "one LambdaLR"),
    "step_vs_schedule": (lambda t: _with(t, step=np.int32(4)), ValueError,
                         "one LambdaLR"),
    "shape": (lambda t: _with(
        t, params__criterion__lamda_par=np.zeros(3, np.float32)), ValueError,
        "shape"),
    "merged_stream": (lambda t: _with(
        t, params__model__vstem_a__Conv_0__Conv_0__kernel=np.zeros(
            (3, 3, 3, 8), np.float32)), ValueError, "merged-stream"),
    "fused": (lambda t: _with(
        t, params__model__neck1__Conv_0__Conv_0__kernel=np.zeros(
            (1, 1, 8, 8), np.float32)), ValueError, "fused serving layout"),
    "no_crit_accum": (lambda t: _without(t, r"^crit_accum/"), ValueError,
                      "criterion_grad_accum"),
    "missing_leaf": (lambda t: _without(t, r"^batch_stats/stem0/"), KeyError,
                     "no npp_tpu leaf"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_load_refuses(lip_accum, case):
    edit, error, match = REFUSALS[case]
    with pytest.raises(error, match=match):
        convert.load_jax_state(_port_train(), edit(dict(lip_accum["tree"])))


def test_a_search_tree_is_no_train_state():
    run = _search_state("vmapped", 1, 0)
    with pytest.raises(KeyError, match="w_opt_state.* maps to nothing"):
        convert.load_jax_state(_port_train(), run["tree"])


# -- one train step after the load, against npp_tpu's -------------------------

@pytest.fixture(scope="module")
def npp_step(lip_accum):
    """npp_tpu's train step from the loaded state (``make_train_step_body``:
    the value-and-gradient jitted, the lambdas' running sum, the
    optimizer's update) and the port's from the same state and batch."""
    run, v = lip_accum, lip_accum["v"]
    params = {"model": v["params"],
              "criterion": {k: jnp.asarray(a) for k, a in LAMDAS.items()}}
    tree = dict(run["tree"], **{f"params/{k}": a for k, a in
                                npp_flat(params).items()})
    host = _host_batch(3)
    jm = JNPPNet(dtype=jnp.float32, **LIP)
    jbatch = _jax_batch(host)

    def loss_fn(p):  # test_torch_train.py's program
        return jtrain.compute_losses(jm, p, v["batch_stats"], jbatch,
                                     train=True, **LOSS_KW)

    (_, (stats, metrics, _)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    g = {"/".join(p): np.asarray(x) for p, x in flatten_dict(
        jax.device_get(grads)).items()}
    g.update({f"criterion/{k}": run["crit"][k] + g[f"criterion/{k}"]
              for k in LAMDAS})
    real, _ = _update(run["tx"], run["packing"], run["opt"],
                      {k: np.asarray(a) for k, a in npp_flat(params).items()},
                      g)

    state = _port_train()
    convert.load_jax_state(state, tree)
    port_metrics = ttrain.make_train_step(**LOSS_KW)(state,
                                                     _torch_batch(host))
    return dict(jax=dict(metrics=jax.device_get(metrics), grads=g, real=real,
                         stats=jax.device_get(stats)),
                port=dict(state=state, metrics=port_metrics), tree=tree)


def test_train_step_after_load_matches_npp_tpu(npp_step, lip_accum):
    """The losses, every gradient, the lambdas' running sums and the
    running statistics of the port's step against npp_tpu's, and the
    counts after it."""
    ref, port = npp_step["jax"], npp_step["port"]
    state = port["state"]
    for k in ("loss", "loss_pose", "loss_par"):
        np.testing.assert_allclose(port["metrics"][k].item(),
                                   float(ref["metrics"][k]), rtol=1e-5)
    view = _port_view(ref["grads"])
    got = {k: p.grad.numpy() for k, p in state.model.named_parameters()}
    worst, key, norm = _grad_errors(got, {k: view[k] for k in got})
    assert worst <= 1.0 and norm <= GRAD_TOL_NORM, (worst, key, norm)
    for k, p in state.lamdas.items():
        np.testing.assert_allclose(p.grad.numpy(), view[k], rtol=1e-5)
    sd = state.model.state_dict()
    for path, r in flatten_dict(ref["stats"]).items():
        t = sd[convert.torch_key("batch_stats", path)].numpy()
        assert np.abs(t - r).max() <= 1e-4 * max(np.abs(r).max(), 1e-12)
    assert state.step == 4 and state.scheduler.last_epoch == 4
    assert {int(s["step"]) for s in state.optimizer.state.values()} == {4}


def test_update_from_npp_tpus_gradients_matches_its_step(npp_step,
                                                         lip_accum):
    """The update half of that step: the loaded port optimizer given
    npp_tpu's gradients lands on npp_tpu's parameters."""
    ref = npp_step["jax"]
    state = _port_train()
    convert.load_jax_state(state, npp_step["tree"])
    _set_grads(state, _port_view(ref["grads"]))
    state.apply_update()
    _assert_params(state, ref["real"])


# -- ZeRO-1 and tensor parallelism: the same file on two gloo ranks -----------

WORKER = r'''
import copy, os, sys
import numpy as np
import torch

from npp_tpu_torch.core import checkpoint as C, train as T
from npp_tpu_torch.parallel import mesh, tensor
from npp_tpu_torch.utils import convert

torch.set_num_threads(1)
OUT = sys.argv[1]
assert mesh.initialize_distributed("cpu")
rank = mesh.rank()
CFG = dict(np.load(os.path.join(OUT, "config.npz"), allow_pickle=True))
KW, OPT = CFG["kw"].item(), CFG["opt"].item()
tree = dict(np.load(os.path.join(OUT, "state.npz")))
grads = dict(np.load(os.path.join(OUT, "grads.npz")))


def state(**kw):
    return T.init_train_state(generator=torch.Generator().manual_seed(7),
                              device="cpu", dtype=torch.float32, **OPT,
                              **KW, **kw)


def run(st):
    convert.load_jax_state(st, tree)
    loaded = copy.deepcopy(C.state_dict(st))
    tp = tensor.sharding_of(st.model)
    for k, p in {**dict(st.model.named_parameters()), **st.lamdas}.items():
        g = torch.from_numpy(grads[k])
        if tp is not None and k in tp.sharded:
            g = tp.own(g, tp.sharded[k]).clone()
        p.grad = g
    st.apply_update()
    return {"loaded": loaded, "stepped": C.state_dict(st)}


out = {"zero": run(state(group=mesh.data_group(), zero=True)),
       "tp": run(state(grid=mesh.make_grid(1, 1, 2)))}
torch.save(out, os.path.join(OUT, f"rank{rank}.pt"))
torch.distributed.destroy_process_group()
print(f"WORKER_OK rank={rank}")
'''


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory, lip_accum):
    """Two gloo ranks (``WORKER``), started before the module's first test
    and read by the last: the inputs, the processes and where they
    write."""
    out = tmp_path_factory.mktemp("opt_state_ranks")
    np.savez(out / "state.npz", **lip_accum["tree"])
    grads = _port_view(_grads(lip_accum["packing"], 500))
    np.savez(out / "grads.npz", **grads)
    np.savez(out / "config.npz", kw=LIP, opt=OPT)
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(out)], cwd=ROOT,
        env=_env(RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                 MASTER_ADDR="localhost", MASTER_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    yield dict(out=out, procs=procs, grads=grads)
    for proc in procs:
        proc.kill()
        proc.communicate()


def test_zero_and_tensor_parallel_ranks_load_the_same_file(ranks):
    """Two gloo ranks load the same file under ZeRO-1 (world 2) and on a
    1x1x2 tensor-parallel grid, each keeping its share; the consolidated
    or gathered state equals one process's load, and an update from the
    same gradients equals one process's, bit for bit."""
    out = ranks["out"]
    one = _port_train()
    convert.load_jax_state(one, dict(np.load(out / "state.npz")))
    loaded = copy.deepcopy(tckpt.state_dict(one))
    _set_grads(one, ranks["grads"])
    one.apply_update()
    stepped = tckpt.state_dict(one)
    for rc, log in _wait(ranks["procs"], timeout=240):
        assert rc == 0, log[-4000:]
    for r in range(2):
        got_r = torch.load(out / f"rank{r}.pt", weights_only=False)
        for layout in ("zero", "tp"):
            got = got_r[layout]
            if layout == "zero" and r == 1:  # consolidated on rank 0
                assert got["loaded"]["optimizer"] is None
                continue
            _equal_blobs(got["loaded"], loaded, f"{layout}{r}/loaded")
            _equal_blobs(got["stepped"], stepped, f"{layout}{r}/stepped")


# -- the CLIs -------------------------------------------------------------------

def _resumable(state, step: int, counts: dict, epoch=None, seed=0) -> dict:
    """The port's fresh ``state`` exported, then set to an npp_tpu run's
    position: ``step``, each optimizer field's Adam count, random moments
    (``meta/epoch`` and the best scores where ``epoch`` is given)."""
    tree = convert.jax_state_tree(state)
    rng = np.random.default_rng(seed)
    for k, v in tree.items():
        hit = re.match(r"^(\w+)/inner_states/\w+/inner_state/(\d+)/count$",
                       k)
        if hit:  # scale_by_adam is the arch chain's second transform
            adam = int(hit[2]) == (hit[1] == "a_opt_state")
            tree[k] = np.int32(counts[hit[1]] if adam else step)
        elif "/mu/" in k:
            tree[k] = rng.normal(0, 1e-3, v.shape).astype(np.float32)
        elif "/nu/" in k:
            tree[k] = rng.uniform(0, 1e-6, v.shape).astype(np.float32)
    tree["step"] = np.int32(step)
    if epoch is not None:
        tree.update({"meta/epoch": np.int32(epoch),
                     "meta/best_iou": np.float32(0.25),
                     "meta/best_pck": np.float32(0.5)})
    return tree


def _tiny_train_state():
    model_kw, hp = augment_lip.LIP.train_config(tiny=True)
    return augment_lip.init_state(model_kw, hp, device="cpu",
                                  dtype=torch.float32, seed=1,
                                  steps_per_epoch=2), hp


def test_train_cli_resumes_an_npp_tpu_run(tmp_path):
    """Past the schedule's first boundary (epoch 150 at 2 steps an epoch):
    the CLI begins at the epoch after ``meta/epoch`` with the scheduled
    LR and the run's counts, and goes on from there."""
    state, hp = _tiny_train_state()
    tree = _resumable(state, 302, {"opt_state": 302}, epoch=150)
    np.savez(tmp_path / "state.npz", **tree)
    out = augment_lip.main([
        "--synthetic", "--tiny", "--steps", "2", "--epochs", "152",
        "--device", "cpu", "--dtype", "float32", "--out", str(tmp_path),
        "--resume-jax", str(tmp_path / "state.npz")])
    st = out["state"]
    assert out["begin_epoch"] == 151 and st.step == 304
    lrs = {g["name"]: g["lr"] for g in st.optimizer.param_groups}
    assert lrs == pytest.approx({"weights": 0.2 * hp["lr"],
                                 "backbone": 0.04 * hp["lr"],
                                 "criterion": 1e-4}, rel=1e-12)
    assert {int(s["step"]) for s in st.optimizer.state.values()} == {304}
    assert (tmp_path / "lip" / "augment" / "tiny" / "checkpoints" / "151"
            / "state.pt").is_file()


@pytest.mark.parametrize("case", ["with_resume", "mid_epoch", "meta"])
def test_train_cli_refuses(tmp_path, case):
    state, _ = _tiny_train_state()
    step, epoch = {"with_resume": (4, 1), "mid_epoch": (3, None),
                   "meta": (4, 3)}[case]
    np.savez(tmp_path / "state.npz",
             **_resumable(state, step, {"opt_state": step}, epoch=epoch))
    argv = ["--synthetic", "--tiny", "--steps", "2", "--epochs", "3",
            "--device", "cpu", "--dtype", "float32", "--out", str(tmp_path),
            "--resume-jax", str(tmp_path / "state.npz")]
    if case == "with_resume":
        with pytest.raises(SystemExit):
            augment_lip.main(argv + ["--resume"])
    else:
        with pytest.raises(ValueError, match={
                "mid_epoch": "not at the end of an epoch",
                "meta": "meta/epoch says 3"}[case]):
            augment_lip.main(argv)


def test_search_cli_resumes_an_npp_tpu_run(tmp_path):
    """A search past its warmup and its first boundary (epoch 71 at one
    step an epoch): the CLI begins at epoch 72 with a bi-level epoch, the
    weight schedule's LR and both Adams' counts."""
    model_kw, hp = search_lip.LIP.search_config(tiny=True)
    state = search_lip.init_state(model_kw, hp, device="cpu",
                                  dtype=torch.float32, seed=1,
                                  steps_per_epoch=1)
    tree = _resumable(state, 72, {"w_opt_state": 72, "a_opt_state": 57},
                      epoch=71)
    np.savez(tmp_path / "state.npz", **tree)
    out = search_lip.main([
        "--synthetic", "--tiny", "--steps", "1", "--epochs", "73",
        "--device", "cpu", "--dtype", "float32", "--out", str(tmp_path),
        "--resume-jax", str(tmp_path / "state.npz")])
    st = out["state"]
    assert out["begin_epoch"] == 72 and st.step == 73
    lrs = {g["name"]: g["lr"] for g in st.w_optimizer.param_groups}
    assert lrs == pytest.approx({"weights": 0.2 * hp["w_lr"],
                                 "criterion": 1e-4}, rel=1e-12)
    assert {int(s["step"]) for s in st.a_optimizer.state.values()} == {58}
    assert {int(s["step"]) for s in st.w_optimizer.state.values()} == {73}
    with pytest.raises(SystemExit):
        search_lip.main(["--synthetic", "--tiny", "--device", "cpu",
                         "--resume", "--resume-jax",
                         str(tmp_path / "state.npz")])
