"""The port's train slice against npp_tpu on the CPU: the train-mode
forward and BN running stats, the losses and every gradient, Adam's
groups and schedule with the lambda-gradient accumulation, the group
labels, the target-weighted pose loss, the shuffled loader order, the
checkpoints and the train CLI.

One JAX program, module-scoped: the jitted value-and-gradient of
``npp_tpu.core.train.compute_losses`` at L=4, C=8, 64x64, batch 4, 20
classes, 16 joints, ``ohem_keep=256``. Weights: the flax tree's structure
from ``jax.eval_shape``, every leaf filled from a numpy RNG, loaded into
the port through the weight bridge as a ``TrainState``-shaped tree.
Everything in fp32; NHWC <-> NCHW at compare.

Tolerances: the JAX BN takes one-pass moments (E[x^2] - E[x]^2) and the
port's two-pass ones; both then go through 4 cells and the decoder, so
outputs and running stats are held at 1e-4 x max|ref| per tensor (as the
eval-mode checks of ``test_torch_model.py``) and the losses at rtol 1e-5.
The gradients of this net in fp32 are ill-conditioned: BN in train mode
subtracts a batch mean from gradients that are mostly that mean, and
over few samples per channel (4 at the 1x1 maps of the deepest pooled
convs) it divides by small batch deviations all the way back, so fp32
keeps only a few digits of them. Each tensor is held at 5e-2 x its
max|g_ref| plus 1e-5 x the model's max|g_ref| (the second term holds the
conv biases that feed a train-mode BN, whose true gradient is 0 and
whose computed one is rounding noise on both sides), and all of them at
||g - g_ref|| <= 1e-2 ||g_ref||; ``test_fp32_gradients_of_both_packages_
against_fp64`` holds both packages' fp32 gradients against the port's
fp64 ones at the same bounds, so the bounds sit above the fp32 floor.
The batch's images get a brightness each: noise images alone average
out to nearly equal features at the 1x1 maps, which makes the floor
several times higher. Adam runs the same
formula; optax rounds its bias corrections 1 - 0.999^t to float32
(1.3e-5 off at t=1) where torch keeps them in double, so each update of
size ~lr = 1e-3 may differ by ~1e-8: parameters at rtol 1e-6 + atol 1e-7.
"""
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from npp_tpu.core import criterion as jcrit
from npp_tpu.core import train as jtrain
from npp_tpu.data import loader as jloader
from npp_tpu.models.augment import NPPNet as JNPPNet

from npp_tpu_torch import engine
from npp_tpu_torch.core import checkpoint as tckpt
from npp_tpu_torch.core import criterion as tcrit
from npp_tpu_torch.core import train as ttrain
from npp_tpu_torch.data import loader as tloader
from npp_tpu_torch.data.synthetic import SyntheticDataset
from npp_tpu_torch.models.augment import build_nppnet
from npp_tpu_torch.tools import augment_lip
from npp_tpu_torch.utils import convert

from test_torch_ops import assert_close, random_variables

torch.set_num_threads(1)
SMALL = dict(num_classes=20, num_joints=16, layers=4, init_channels=8,
             refine_layers=1)
SIZE, BATCH, OHEM_KEEP = 64, 4, 256
LOSS_KW = dict(class_weights=jcrit.LIP_CLASS_WEIGHTS, ohem_keep=OHEM_KEEP)
LAMDAS = {"lamda_pose": np.array([-2.5, -2.0], np.float32),
          "lamda_par": np.array([2.3, 2.0], np.float32)}
GRAD_TOL, GRAD_TOL_MODEL, GRAD_TOL_NORM = 5e-2, 1e-5, 1e-2


def _host_batch(seed):
    ds = SyntheticDataset(length=BATCH, crop_size=(SIZE, SIZE),
                          num_joints=16, num_classes=20, seed=seed,
                          device_normalize=True)
    host = tloader.collate([ds[i] for i in range(BATCH)])
    host["par"][1, :8, :20] = 255  # ignored pixels
    # A brightness per image, so that the deepest features (1x1 at 1/64)
    # differ across the batch: noise images alone average out to nearly
    # equal ones there, and a BN over such a batch amplifies rounding.
    gain = np.linspace(0.25, 1.0, BATCH, dtype=np.float32)
    host["image"] = (host["image"] * gain[:, None, None, None]).astype(
        np.uint8)
    return host


KEYS = ("image", "par", "joints", "visibility")


def _torch_batch(host):
    b = {k: torch.from_numpy(host[k]) for k in KEYS}
    b.update(tloader.make_target_renderer(normalize_images=True)(
        *(b[k] for k in KEYS)))
    return b


def _jax_batch(host):
    b = {k: jnp.asarray(host[k]) for k in KEYS}
    b.update(jloader.make_target_renderer(normalize_images=True)(
        *(b[k] for k in KEYS)))
    return b


def _small_state(seed=0, **kw):
    return ttrain.init_train_state(
        generator=torch.Generator().manual_seed(seed), device="cpu",
        base_lr=1e-3, lr_step=(2,), lr_factor=0.2, steps_per_epoch=1,
        dtype=torch.float32, **SMALL, **kw)


def _lamdas():
    return {k: nn.Parameter(torch.zeros(2)) for k in LAMDAS}


def _oihw(path, arr):
    arr = np.asarray(arr)
    return arr.transpose(3, 2, 0, 1) if path[-1] == "kernel" else arr


@pytest.fixture(scope="module")
def variables():
    jm = JNPPNet(dtype=jnp.float32, **SMALL)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    return jm, random_variables(shapes, seed=0)


@pytest.fixture(scope="module")
def one_step(variables):
    """The JAX value-and-gradient of compute_losses (train=True) and the
    port's compute_losses + backward on the same weights and batch."""
    jm, v = variables
    host = _host_batch(3)
    params = {"model": v["params"],
              "criterion": {k: jnp.asarray(a) for k, a in LAMDAS.items()}}
    jbatch = _jax_batch(host)

    def loss_fn(p):
        return jtrain.compute_losses(jm, p, v["batch_stats"], jbatch,
                                     train=True, **LOSS_KW)

    (_, (new_stats, jmetrics, jouts)), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)

    tm = build_nppnet(device="cpu", train=True, dtype=torch.float32,
                             generator=torch.Generator().manual_seed(1),
                             **SMALL)
    lamdas = _lamdas()
    convert.load_jax_variables(
        tm, {"params": {"model": v["params"], "criterion": LAMDAS},
             "batch_stats": v["batch_stats"]}, lamdas)
    loss, metrics, outs = ttrain.compute_losses(tm, lamdas,
                                                _torch_batch(host), **LOSS_KW)
    loss.backward()
    flat = lambda o: [t for stage in o for pair in stage for t in pair]
    return dict(jax=dict(stats=new_stats, metrics=jmetrics, outs=flat(jouts),
                         grads=jgrads),
                port=dict(model=tm, lamdas=lamdas, metrics=metrics,
                          outs=flat(outs)))


@pytest.mark.parametrize("index", range(8))
def test_train_mode_outputs_match_jax(one_step, index):
    """pose/aux/par/edge x 2 stages with batch statistics, 1e-4 x max|ref|."""
    ours, ref = one_step["port"]["outs"], one_step["jax"]["outs"]
    assert len(ours) == len(ref) == 8
    assert_close(ours[index], np.asarray(ref[index]))


@pytest.mark.parametrize("leaf", ["mean", "var"])
def test_train_mode_running_stats_match_jax(one_step, leaf):
    """Every BN's updated running mean / var (unbiased variance), 1e-4 x
    max|ref| per tensor."""
    state = one_step["port"]["model"].state_dict()
    flat = flatten_dict(jax.device_get(one_step["jax"]["stats"]))
    n = 0
    for path, ref in flat.items():
        if path[-1] != leaf:
            continue
        ref = np.asarray(ref)
        got = state[convert.torch_key("batch_stats", path)].numpy()
        scale = max(float(np.abs(ref).max()), 1e-12)
        assert float(np.abs(got - ref).max()) <= 1e-4 * scale, path
        n += 1
    assert n > 100


def test_train_losses_match_jax(one_step):
    ours, ref = one_step["port"]["metrics"], one_step["jax"]["metrics"]
    for k in ("loss", "loss_pose", "loss_par"):
        np.testing.assert_allclose(ours[k].item(), float(ref[k]), rtol=1e-5,
                                   err_msg=k)


def _grad_errors(grads, ref):
    """(worst per-tensor share of the GRAD_TOL rule, its tensor, norm
    error) of ``grads`` against ``ref`` (numpy arrays by state_dict key)."""
    assert grads.keys() == ref.keys()
    model_max = max(float(np.abs(g).max()) for g in ref.values())
    worst, worst_key, sq_err, sq_ref = 0.0, "", 0.0, 0.0
    for k, r in ref.items():
        d = grads[k].astype(np.float64) - r
        bound = GRAD_TOL * float(np.abs(r).max()) + GRAD_TOL_MODEL * model_max
        if float(np.abs(d).max()) / bound > worst:
            worst, worst_key = float(np.abs(d).max()) / bound, k
        sq_err += float(np.sum(d ** 2))
        sq_ref += float(np.sum(r.astype(np.float64) ** 2))
    return worst, worst_key, (sq_err / sq_ref) ** 0.5


def _port_grads(model):
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert all(g is not None for g in grads.values())
    return {k: g.numpy() for k, g in grads.items()}


def _jax_grads(one_step):
    return {convert.torch_key("params", path): _oihw(path, g)
            for path, g in flatten_dict(jax.device_get(
                one_step["jax"]["grads"]["model"])).items()}


def test_train_gradients_match_jax(one_step):
    """Every model parameter's gradient (tolerances: module docstring)."""
    worst, key, norm = _grad_errors(_port_grads(one_step["port"]["model"]),
                                    _jax_grads(one_step))
    assert worst <= 1.0 and norm <= GRAD_TOL_NORM, (worst, key, norm)


def test_fp32_gradients_of_both_packages_against_fp64(variables, one_step):
    """The gradient tolerances hold each package's fp32 gradients against
    the port's in fp64 on the same weights and batch, so they measure the
    fp32 rounding floor and not a fault (``pytest -s`` prints it)."""
    _, v = variables
    tm = build_nppnet(device="cpu", train=True, dtype=torch.float32,
                      generator=torch.Generator().manual_seed(1), **SMALL)
    lamdas = _lamdas()
    convert.load_jax_variables(
        tm, {"params": {"model": v["params"], "criterion": LAMDAS},
             "batch_stats": v["batch_stats"]}, lamdas)
    tm.double()
    lamdas = {k: nn.Parameter(p.detach().double()) for k, p in lamdas.items()}
    batch = {k: t.double() if t.is_floating_point() else t
             for k, t in _torch_batch(_host_batch(3)).items()}
    loss, _, _ = ttrain.compute_losses(tm, lamdas, batch, **LOSS_KW)
    loss.backward()
    ref = _port_grads(tm)
    for name, grads in (("port fp32", _port_grads(one_step["port"]["model"])),
                        ("jax fp32", _jax_grads(one_step))):
        worst, key, norm = _grad_errors(grads, ref)
        print(f"{name} vs port fp64: worst tensor {worst:.3g} of the "
              f"per-tensor bound ({key}), norm {norm:.3g}")
        assert worst <= 1.0 and norm <= GRAD_TOL_NORM, name


def test_lamda_gradients_match_jax(one_step):
    ref = one_step["jax"]["grads"]["criterion"]
    for k, p in one_step["port"]["lamdas"].items():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("accum", [True, False])
def test_adam_groups_schedule_and_crit_accum_match_optax(variables, accum):
    """Three updates from the same numpy gradients, the schedule's boundary
    (epoch 2, one step per epoch) before the third; with ``accum`` Adam
    sees the running sum of the lambda gradients on both sides."""
    _, v = variables
    params = {"model": jax.tree.map(jnp.asarray, v["params"]),
              "criterion": {k: jnp.asarray(a) for k, a in LAMDAS.items()}}
    tx = jtrain.make_train_optimizer(1e-3, lr_step=(2,), lr_factor=0.2,
                                     steps_per_epoch=1)
    opt_state = tx.init(params)
    state = _small_state(criterion_grad_accum=accum)
    convert.load_jax_variables(
        state.model, {"params": {"model": v["params"], "criterion": LAMDAS},
                      "batch_stats": v["batch_stats"]}, state.lamdas)
    named = dict(state.model.named_parameters())
    flat_model = flatten_dict(v["params"])
    rng = np.random.default_rng(11)
    accum_j = {k: np.zeros(2, np.float32) for k in LAMDAS}
    for _ in range(3):
        g_model = {p: rng.normal(0, 1, np.shape(a)).astype(np.float32)
                   for p, a in flat_model.items()}
        g_crit = {k: rng.normal(0, 1, 2).astype(np.float32) for k in LAMDAS}
        if accum:
            accum_j = {k: accum_j[k] + g_crit[k] for k in LAMDAS}
        grads = {"model": unflatten_dict(g_model),
                 "criterion": accum_j if accum else g_crit}
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)

        state.zero_grad()
        tensors = [named[convert.torch_key("params", p)] for p in g_model]
        tensors += [state.lamdas[k] for k in g_crit]
        grads_t = [torch.from_numpy(np.ascontiguousarray(_oihw(p, g)))
                   for p, g in g_model.items()]
        grads_t += [torch.from_numpy(g_crit[k]) for k in g_crit]
        # accumulates into .grad as a loss's backward would
        torch.autograd.backward(tensors, grads_t)
        state.apply_update()
    assert state.step == 3
    for path, ref in flatten_dict(jax.device_get(params["model"])).items():
        got = named[convert.torch_key("params", path)].detach().numpy()
        np.testing.assert_allclose(got, _oihw(path, ref), rtol=1e-6,
                                   atol=1e-7, err_msg=str(path))
    for k, p in state.lamdas.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(params["criterion"][k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_train_backward_gives_every_parameter_and_lambda_a_gradient():
    """torch's Adam skips a parameter whose ``.grad`` is None, where optax
    moves every count and moment: an optimizer state carried across from
    npp_tpu (``utils/convert.load_jax_state``) stays npp_tpu's only if
    each step reaches every parameter and lambda, as the supernet's does
    (``test_torch_search.py``)."""
    state = _small_state()
    ttrain.make_train_step(**LOSS_KW)(state, _torch_batch(_host_batch(3)))
    tensors = [*state.model.parameters(), *state.lamdas.values()]
    assert all(p.grad is not None for p in tensors)
    assert len(state.optimizer.state) == len(tensors)


def test_multistep_lr_matches_optax_schedule():
    ref = jtrain.multistep_lr(1.0, (2, 4, 4), 0.1, steps_per_epoch=10)
    ours = ttrain.multistep_lr((2, 4, 4), 0.1, steps_per_epoch=10)
    for t in range(0, 60):
        assert ours(t) == pytest.approx(float(ref(t)), rel=1e-6), t


def test_param_groups_match_jax_labels(variables):
    """Each state_dict key's group is ``_label_params``'s label of its flax
    path, and the optimizer holds each parameter in that group."""
    _, v = variables
    labels = flatten_dict(jtrain._label_params(
        {"model": v["params"], "criterion": dict(LAMDAS)},
        backbone_lr_scale=True))
    state = _small_state()
    names = {id(p): n for n, p in state.model.named_parameters()}
    in_group = {}
    for g in state.optimizer.param_groups:
        for p in g["params"]:
            in_group[names.get(id(p), "criterion")] = g["name"]
    seen = {"backbone": 0, "weights": 0}
    for path, label in labels.items():
        if path[0] == "criterion":
            assert label == "criterion"
            continue
        key = convert.torch_key("params", path[1:])
        assert ttrain.param_group(key) == label == in_group[key], key
        seen[label] += 1
    assert seen["backbone"] > 0 and seen["weights"] > 0
    assert sum(seen.values()) == len(names)
    groups = {g["name"]: g["lr"] for g in state.optimizer.param_groups}
    assert groups == pytest.approx({"weights": 1e-3, "backbone": 2e-4,
                                    "criterion": 1e-4})


def test_pose_loss_with_target_weight_matches_jax():
    rng = np.random.default_rng(5)
    outs = [(rng.normal(0, 1, (2, 8, 8, 16)).astype(np.float32),
             rng.normal(0, 1, (2, 8, 8, 16)).astype(np.float32))
            for _ in range(2)]
    target = rng.random((2, 16, 16, 16)).astype(np.float32)
    target_aux = rng.random((2, 16, 16, 16)).astype(np.float32)
    tw = (rng.random((2, 16)) > 0.3).astype(np.float32)
    lam = np.array([-2.5, -2.0], np.float32)
    ref = jcrit.pose_loss([tuple(map(jnp.asarray, o)) for o in outs],
                          jnp.asarray(target), jnp.asarray(target_aux),
                          jnp.asarray(lam), target_weight=jnp.asarray(tw))
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)
    ours = tcrit.pose_loss([tuple(map(nchw, o)) for o in outs], nchw(target),
                           nchw(target_aux), torch.from_numpy(lam),
                           target_weight=torch.from_numpy(tw))
    np.testing.assert_allclose(ours.item(), float(ref), rtol=1e-5)
    assert tcrit.PASCAL_CLASS_WEIGHTS == jcrit.PASCAL_CLASS_WEIGHTS


@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_shuffled_order_matches_jax(drop_last):
    ds = SyntheticDataset(length=11, crop_size=(16, 16))
    ours = tloader.DataLoader(ds, 4, device="cpu", shuffle=True,
                              drop_last=drop_last, seed=5)
    ref = jloader.DataLoader(ds, 4, shuffle=True, drop_last=drop_last,
                             seed=5, process_index=0, process_count=1)
    for epoch in range(2):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = ours._indices(), ref._indices()
        assert len(ours) == len(ref) == len(got)
        assert [b.tolist() for b in got] == [b.tolist() for b in want]
    assert ours._indices()[0].tolist() != sorted(ours._indices()[0].tolist())


def _equal_blobs(a, b, where=""):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _equal_blobs(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_blobs(x, y, f"{where}/{i}")
    else:
        assert a == b, where


def test_checkpoint_round_trip_and_resume_are_exact(tmp_path):
    step = ttrain.make_train_step(**LOSS_KW)
    batches = [_torch_batch(_host_batch(s)) for s in (3, 4, 5)]
    state = _small_state()
    step(state, batches[0])
    mgr = tckpt.CheckpointManager(str(tmp_path), max_to_keep=2)
    mgr.save(0, state, metrics={"mean_iou": 0.5}, is_best=True)

    resumed = _small_state(seed=9)
    _, meta = mgr.restore(resumed)
    assert meta == {"epoch": 0, "mean_iou": 0.5}
    _equal_blobs(tckpt.state_dict(state), tckpt.state_dict(resumed))
    for b in batches[1:]:
        m_a, m_b = step(state, b), step(resumed, b)
        assert m_a["loss"].item() == m_b["loss"].item()
    _equal_blobs(tckpt.state_dict(state), tckpt.state_dict(resumed))

    for epoch in (1, 2):
        mgr.save(epoch, state, tag="final" if epoch == 2 else None)
    assert mgr.latest_epoch() == 2 and mgr._epochs() == [1, 2]
    named = _small_state(seed=8)
    _, meta = mgr.restore_named(named, "final")
    assert meta["epoch"] == 2
    _equal_blobs(tckpt.state_dict(state), tckpt.state_dict(named))
    assert mgr.restore_named(named, "warmed") == (None, None)


@pytest.mark.parametrize("task", ["pose", "par", "both"])
def test_compute_losses_task_selects_the_loss(task):
    state = _small_state()
    with torch.no_grad():
        _, m, _ = ttrain.compute_losses(state.model, state.lamdas,
                                        _torch_batch(_host_batch(3)),
                                        task=task, **LOSS_KW)
    want = {"pose": m["loss_pose"], "par": m["loss_par"],
            "both": m["loss_pose"] + m["loss_par"]}[task]
    assert m["loss"].item() == want.item()
    with pytest.raises(ValueError, match="task"):
        ttrain.compute_losses(state.model, state.lamdas, {}, task="joint",
                              **LOSS_KW)


def test_bridge_rejects_unknown_train_state_params(variables):
    _, v = variables
    bad = {"params": {"model": v["params"], "criterion": LAMDAS,
                      "opt_state": {}}, "batch_stats": v["batch_stats"]}
    with pytest.raises(KeyError, match="opt_state"):
        convert.load_jax_variables(_small_state().model, bad, _lamdas())


def test_train_epoch_reads_the_loss_at_print_freq():
    calls = []

    def fake_step(state, batch):
        calls.append(batch)
        return {"loss": torch.tensor(float(len(calls))),
                "loss_pose": torch.tensor(0.0), "loss_par": torch.tensor(0.0)}

    avg, gstep = engine.train_epoch(fake_step, None, [0, 1, 2, 3, 4],
                                    epoch=0, print_freq=2)
    assert avg == pytest.approx(3.0) and gstep == 0 and len(calls) == 5
    assert engine.is_best_checkpoint(0.5, 0.0, 0.4, 0.0)
    assert not engine.is_best_checkpoint(0.3, 0.0, 0.4, 0.0)


def test_train_cli_runs_tiny_on_cpu(tmp_path):
    out = augment_lip.main(["--synthetic", "--tiny", "--steps", "2",
                            "--epochs", "1", "--device", "cpu", "--dtype",
                            "float32", "--out", str(tmp_path)])
    assert np.isfinite(out["train_loss"])
    assert np.isfinite(out["result"]["loss"])
    assert out["state"].step == 2
    for name in ("0", "best", "final"):
        assert (tmp_path / "lip" / "augment" / "tiny" / "checkpoints" / name
                / "state.pt").is_file()
