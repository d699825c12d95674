"""npp_tpu's one-dispatch programs in the port, on the CPU: the scanned
train step and epoch, the scanned eval epoch with its tail batch, the
loader's batch caches, the two CLI flags and their refusal under a
process group.

On the CPU the port runs the plain version of each program, which is
what these tests hold against npp_tpu: the scanned train step runs
``train.train_update``, the body that a card captures into its graph,
K times, each step's learning rates read from ``train.lr_table`` as the
graph reads them, with the plain Adam where the card's is capturable;
the scanned eval runs its per-batch body batch by batch. The captured
programs themselves run only on a card (``chip_smoke.py`` phase 23). The tiny configuration: L=4, C=8, 64x64, batch 2, K=2, 20
classes, 16 joints, ``ohem_keep=256``; weights from a numpy seed loaded
into both packages through the weight bridge; fp32.

Two npp_tpu programs, module-scoped: ``make_train_step_scanned`` (traced
at K=2 and at the tail's K=1) and ``make_eval_epoch`` (the epoch over
two stacked batches and its per-batch step for the tail).

Tolerances. The eval is a forward: the confusion matrix exact, the batch
losses at rtol 1e-4 and the decoded joints at 1e-4 px (as
``test_torch_ppp.py`` / ``test_torch_serve.py``). Training: the first
step's losses at rtol 1e-5 (``test_torch_train.py``); after that the
fp32 gradients of this net keep only ~2-3 digits (``test_torch_train.py``'s
docstring) and Adam's first update is lr x sign(g), so a parameter whose
gradient is rounding noise on both sides may move +lr on one and -lr on
the other: the later losses at rtol 1e-3, every tensor of the weights
within 2 lr_total (the sum of the chunk's learning rates) of npp_tpu's
and all of them at ||w - w_ref|| <= 0.1 ||w_ref - w_0|| (the update's own
norm), the lambdas (whose gradients are well conditioned) at 1e-6, the
Adam counts exact. The port's scanned step against its own eager steps
is exact: the same body, with ``lr_table``'s rates where the eager step
has ``LambdaLR``'s, which must be the same numbers. ``lr_table`` is also
held directly against npp_tpu's optax schedules.
"""
import contextlib
import inspect
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from npp_tpu import engine as jengine
from npp_tpu.core import criterion as jcrit
from npp_tpu.core import evaluate as jeval
from npp_tpu.core import train as jtrain
from npp_tpu.data import loader as jloader
from npp_tpu.models.augment import NPPNet as JNPPNet

from npp_tpu_torch import engine
from npp_tpu_torch.core import evaluate as teval
from npp_tpu_torch.core import graphs
from npp_tpu_torch.core import train as ttrain
from npp_tpu_torch.data import loader as tloader
from npp_tpu_torch.data.synthetic import SyntheticDataset
from npp_tpu_torch.models.augment import build_nppnet
from npp_tpu_torch.utils import convert

from test_torch_ops import random_variables

torch.set_num_threads(1)
SMALL = dict(num_classes=20, num_joints=16, layers=4, init_channels=8,
             refine_layers=1)
SIZE, BATCH, K, OHEM_KEEP, LR = 64, 2, 2, 256, 1e-3
LR_STEP, LR_FACTOR = (1,), 0.2   # boundary at update 1: inside chunk 1
LOSS_KW = dict(class_weights=jcrit.LIP_CLASS_WEIGHTS, ohem_keep=OHEM_KEEP)
LAMDAS = {"lamda_pose": np.array([-2.5, -2.0], np.float32),
          "lamda_par": np.array([2.3, 2.0], np.float32)}
KEYS = ("image", "par", "joints", "visibility")
HOST_KEYS = ("scale", "crop_param")   # read by the eval step's decode
N_TRAIN = 3        # batches: a chunk of K = 2, then a tail chunk of 1
N_VAL = 5          # samples: two batches of 2, then a tail batch of 1
EVAL_KW = dict(num_classes=20, class_weights=jcrit.LIP_CLASS_WEIGHTS,
               ohem_keep=OHEM_KEEP, decode_hw=(SIZE, SIZE))
LOSS_RTOL, LATER_LOSS_RTOL, KP_ATOL = 1e-5, 1e-3, 1e-4
STATS_RTOL = 5e-2


def _host_batch(seed, n=BATCH):
    ds = SyntheticDataset(length=n, crop_size=(SIZE, SIZE), num_joints=16,
                          num_classes=20, seed=seed, device_normalize=True)
    host = tloader.collate([ds[i] for i in range(n)])
    host["par"][0, :8, :20] = 255  # ignored pixels
    gain = np.linspace(0.25, 1.0, n, dtype=np.float32)  # a brightness each
    host["image"] = (host["image"] * gain[:, None, None, None]).astype(
        np.uint8)
    return host


def _torch_batch(host):
    b = {k: torch.from_numpy(host[k]) for k in HOST_KEYS}
    b.update({k: torch.from_numpy(host[k]) for k in KEYS})
    b.update(tloader.make_target_renderer(normalize_images=True)(
        *(b[k] for k in KEYS)))
    return b


def _jax_batch(host):
    b = {k: jnp.asarray(host[k]) for k in HOST_KEYS}
    b.update({k: jnp.asarray(host[k]) for k in KEYS})
    b.update(jloader.make_target_renderer(normalize_images=True)(
        *(b[k] for k in KEYS)))
    return b


def _oihw(path, arr):
    arr = np.asarray(arr)
    return arr.transpose(3, 2, 0, 1) if path[-1] == "kernel" else arr


@contextlib.contextmanager
def _fast_compiles():
    """npp_tpu's programs compiled with most XLA optimisations off (as
    ``test_torch_spatial.py``): a tenth of the compile time, the same
    arithmetic order for these ops on the CPU to the bounds used here."""
    fast = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", fast)


@pytest.fixture(scope="module")
def variables():
    jm = JNPPNet(dtype=jnp.float32, **SMALL)
    return jm, _variables(jm)


def _load(model, lamdas, v):
    convert.load_jax_variables(
        model, {"params": {"model": v["params"], "criterion": LAMDAS},
                "batch_stats": v["batch_stats"]}, lamdas)


def _port_state(v):
    state = ttrain.init_train_state(
        generator=torch.Generator().manual_seed(1), device="cpu",
        base_lr=LR, lr_step=LR_STEP, lr_factor=LR_FACTOR, steps_per_epoch=1,
        dtype=torch.float32, **SMALL)
    _load(state.model, state.lamdas, v)
    return state


def _jstack(batches):
    return {k: jnp.stack([b[k] for b in batches]) for k in batches[0]}


def _tstack(batches):
    return {k: graphs.stack([b[k] for b in batches]) for k in batches[0]}


def _variables(jm):
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    return random_variables(shapes, seed=0)


# -- npp_tpu's programs, each in a worker process of its own ------------------
#
# Tracing npp_tpu's scanned train step takes ~18 s a chunk size on this CPU
# (the value-and-gradient and the optimizer over ~1,400 leaves), so the
# chunk of 2, the tail chunk of 1 and the eval epoch run in three worker
# processes started with the module, beside the port's tests. The tail's
# worker traces its program on the first state, then waits for the chunk
# worker's state.

ROOT = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent
WORKER = ("import sys; sys.path[:0] = [sys.argv[3], sys.argv[4]]; "
          "import conftest; import test_torch_dispatch as t; "
          "t._worker(sys.argv[1], sys.argv[2])")
WORKERS = ("chunk", "tail", "eval")
WORKER_TIMEOUT_S = 900


def _jax_setup():
    """npp_tpu's side of the train comparisons: the seeded variables, the
    first state (step 0, Adam fresh, a zero lambda-gradient sum), the
    scanned step and the rendered batches."""
    jm = JNPPNet(dtype=jnp.float32, **SMALL)
    v = _variables(jm)
    tx = jtrain.make_train_optimizer(LR, lr_step=LR_STEP,
                                     lr_factor=LR_FACTOR, steps_per_epoch=1)
    params = {"model": v["params"],
              "criterion": {k: jnp.asarray(a) for k, a in LAMDAS.items()}}
    state0 = jtrain.TrainState(
        step=jnp.int32(0), params=params, batch_stats=v["batch_stats"],
        opt_state=jax.jit(tx.init)(params),
        crit_accum={k: jnp.zeros(2, jnp.float32) for k in LAMDAS})
    multi = jtrain.make_train_step_scanned(jm, tx, donate=False, **LOSS_KW)
    jb = [_jax_batch(_host_batch(10 + i)) for i in range(N_TRAIN)]
    return jm, v, state0, multi, jb


def _summary(prefix, jstate, metrics) -> dict:
    """npp_tpu's state as flat numpy arrays under the port's names."""
    out = {f"{prefix}/w/{convert.torch_key('params', p)}": _oihw(p, a)
           for p, a in flatten_dict(jax.device_get(
               jstate.params["model"])).items()}
    out.update({f"{prefix}/s/{convert.torch_key('batch_stats', p)}":
                np.asarray(a) for p, a in flatten_dict(jax.device_get(
                    jstate.batch_stats)).items()})
    for k in LAMDAS:
        out[f"{prefix}/l/{k}"] = np.asarray(jstate.params["criterion"][k])
        out[f"{prefix}/a/{k}"] = np.asarray(jstate.crit_accum[k])
    out[f"{prefix}/step"] = np.asarray(jstate.step)
    out.update({f"{prefix}/m/{k}": np.asarray(v) for k, v in metrics.items()})
    return out


def _save(path: Path, arrays: dict) -> None:
    part = path.with_suffix(".part.npz")
    np.savez(part, **arrays)
    os.replace(part, path)


def _worker(kind: str, out: str) -> None:
    """One of WORKERS, writing ``<out>/<kind>.npz``."""
    out = Path(out)
    with _fast_compiles():
        if kind == "eval":
            jm = JNPPNet(dtype=jnp.float32, **SMALL)
            v = _variables(jm)
            hosts = _val_hosts()
            batches = [dict(_jax_batch(h), names=h["names"], index=h["index"])
                       for h in hosts]
            params = {"model": v["params"], "criterion": {
                k: jnp.asarray(a) for k, a in LAMDAS.items()}}
            res = jeval.validate_scanned(
                jeval.make_eval_epoch(jm, **EVAL_KW), params,
                v["batch_stats"], batches, num_classes=20,
                log_fn=lambda s: None)
            arrays = {f"r/{k}": np.asarray(x) for k, x in res.items()
                      if k != "names"}
            arrays["names"] = np.asarray(res["names"])
            _save(out / "eval.npz", arrays)
            return
        _, _, state0, multi, jb = _jax_setup()
        if kind == "chunk":
            state1, m1 = multi(state0, _jstack(jb[:K]))
            arrays = {f"leaf/{i}": np.asarray(x) for i, x in
                      enumerate(jax.tree_util.tree_leaves(state1))}
            arrays.update(_summary("chunk", state1, m1))
            _save(out / "chunk.npz", arrays)
            return
        stack01, stack2 = _jstack(jb[:K]), _jstack(jb[K:])
        multi(state0, stack2)  # the tail's program, while the chunk runs
        deadline = time.monotonic() + WORKER_TIMEOUT_S
        while not (out / "chunk.npz").exists():
            assert time.monotonic() < deadline, "no chunk state"
            time.sleep(0.2)
        chunk = dict(np.load(out / "chunk.npz"))
        treedef = jax.tree_util.tree_structure(state0)
        state1 = jax.tree_util.tree_unflatten(treedef, [
            jnp.asarray(chunk[f"leaf/{i}"])
            for i in range(treedef.num_leaves)])
        m1 = {k.split("/")[-1]: v for k, v in chunk.items()
              if k.startswith("chunk/m/")}
        state2, m2 = multi(state1, stack2)

        def dispatch(state, stacked):
            """npp_tpu's scanned step; its chunk of K answered from the
            chunk worker's run of the same program on the same batches."""
            if stacked["image"].shape[0] == K:
                assert state is state0
                assert all(np.array_equal(stacked[k], stack01[k])
                           for k in stacked)
                return state1, m1
            return multi(state, stacked)

        jstate, jloss, jgstep = jengine.train_epoch_scanned(
            dispatch, state0, jb, epoch=0, steps_per_dispatch=K)
        arrays = _summary("tail", state2, m2)
        arrays.update(_summary("epoch", jstate, {}))
        arrays.update({"epoch/loss": np.asarray(jloss),
                       "epoch/gstep": np.asarray(jgstep)})
        _save(out / "tail.npz", arrays)


@pytest.fixture(scope="module", autouse=True)
def workers(tmp_path_factory):
    """The three workers, started with the module."""
    out = tmp_path_factory.mktemp("dispatch")
    procs = {kind: subprocess.Popen(
        [sys.executable, "-c", WORKER, kind, str(out), str(TESTS), str(ROOT)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for kind in WORKERS}
    yield out, procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
        p.communicate()


def _results(workers, kind: str) -> dict:
    out, procs = workers
    log, _ = procs[kind].communicate(timeout=WORKER_TIMEOUT_S)
    assert procs[kind].returncode == 0, log[-4000:]
    return dict(np.load(out / f"{kind}.npz"))


def _part(arrays: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


@pytest.fixture(scope="module")
def jax_train(workers):
    chunk, tail = _results(workers, "chunk"), _results(workers, "tail")
    return dict(chunk={p: _part(chunk, f"chunk/{p}/") for p in "wslam"}
                | {"step": int(chunk["chunk/step"])},
                tail={p: _part(tail, f"tail/{p}/") for p in "wslam"}
                | {"step": int(tail["tail/step"])},
                epoch={p: _part(tail, f"epoch/{p}/") for p in "wsla"}
                | {"step": int(tail["epoch/step"]),
                   "loss": float(tail["epoch/loss"]),
                   "gstep": int(tail["epoch/gstep"])})


@pytest.fixture(scope="module")
def jax_eval(workers):
    arrays = _results(workers, "eval")
    res = _part(arrays, "r/")
    res["names"] = [str(n) for n in arrays["names"]]
    return res


# -- the port's runs ----------------------------------------------------------

@pytest.fixture(scope="module")
def train_runs(variables):
    """The port's scanned step over a chunk of K=2 (across the schedule's
    boundary) and a tail chunk of 1, its eager steps and its
    train_epoch_scanned, on npp_tpu's weights and batches."""
    _, v = variables
    tb = [_torch_batch(_host_batch(10 + i)) for i in range(N_TRAIN)]
    scanned = ttrain.make_train_step_scanned(**LOSS_KW)
    port = _port_state(v)
    w0 = {k: p.detach().clone() for k, p in port.model.named_parameters()}
    p1 = scanned(port, _tstack(tb[:K]))
    after1 = _snapshot(port)
    p2 = scanned(port, _tstack(tb[K:]))
    eager = _port_state(v)
    step = ttrain.make_train_step(**LOSS_KW)
    e1 = [step(eager, b) for b in tb[:K]]
    eager_after1 = _snapshot(eager)
    epoch = _port_state(v)
    tloss, tgstep = engine.train_epoch_scanned(scanned, epoch, tb, epoch=0,
                                               steps_per_dispatch=K)
    return dict(w0=w0, p1=(after1, p1), p2=(_snapshot(port), p2),
                e1=(eager_after1, e1),
                pepoch=(_snapshot(epoch), tloss, tgstep))


def _snapshot(state):
    """The state's tensors as numpy: weights, BN statistics, lambdas and
    their gradient sum, Adam's counts and moments, the schedule."""
    opt = state.optimizer
    names = {id(p): n for n, p in state.model.named_parameters()}
    names.update({id(p): f"criterion/{k}" for k, p in state.lamdas.items()})
    adam = {}
    for group in opt.param_groups:
        for p in group["params"]:
            st = opt.state[p]
            adam[names[id(p)]] = (float(st["step"]),
                                  st["exp_avg"].numpy().copy(),
                                  st["exp_avg_sq"].numpy().copy())
    return dict(
        model={k: t.detach().numpy().copy()
               for k, t in state.model.state_dict().items()},
        lamdas={k: p.detach().numpy().copy() for k, p in state.lamdas.items()},
        accum={k: p.grad.numpy().copy() for k, p in state.lamdas.items()},
        adam=adam, step=state.step,
        lr=[g["lr"] for g in opt.param_groups])


def _check_against_jax(snap, ref, w0, lr_total, what):
    """The port's state ``snap`` against npp_tpu's summary ``ref``
    (module docstring's bounds)."""
    sq_d = sq_u = 0.0
    for k, r in ref["w"].items():
        d = snap["model"][k].astype(np.float64) - r
        assert float(np.abs(d).max()) <= 2 * lr_total, (what, k)
        sq_d += float(np.sum(d ** 2))
        sq_u += float(np.sum((r.astype(np.float64) - w0[k].numpy()) ** 2))
    assert (sq_d / sq_u) ** 0.5 <= 0.1, (what, (sq_d / sq_u) ** 0.5)
    worst = max(float(np.abs(snap["model"][k] - r).max())
                / max(float(np.abs(r).max()), 1e-12)
                for k, r in ref["s"].items())
    assert worst <= STATS_RTOL, (what, worst)
    for k in LAMDAS:
        np.testing.assert_allclose(snap["lamdas"][k], ref["l"][k],
                                   rtol=1e-6, atol=1e-7, err_msg=what)
        np.testing.assert_allclose(snap["accum"][k], ref["a"][k],
                                   rtol=LATER_LOSS_RTOL, err_msg=what)
    assert snap["step"] == ref["step"], what
    assert {a[0] for a in snap["adam"].values()} == {float(ref["step"])}


LR_CHUNK1 = LR * (1 + LR_FACTOR)   # updates 0 and 1: the boundary between


def test_scanned_step_schedule_steps_as_single_steps(train_runs):
    """After the chunk the schedule stands where K single steps leave it:
    update 2 at lr x factor (the backbone at 0.2 x that, the lambdas at
    their constant rate)."""
    snap = train_runs["p1"][0]
    assert snap["step"] == K
    np.testing.assert_allclose(
        snap["lr"], [LR * LR_FACTOR, 0.2 * LR * LR_FACTOR,
                     ttrain.CRITERION_LR], rtol=1e-12)


class _Backbone(torch.nn.Module):
    """A model with one parameter in each of the optimizer's model
    groups (``train.param_group``): ``stem`` the backbone's, ``head``
    the other weights'."""

    def __init__(self):
        super().__init__()
        self.stem = torch.nn.Linear(2, 2)
        self.head = torch.nn.Linear(2, 2)


@pytest.mark.parametrize("t0", [0, 1, 3, 5])
def test_lr_table_is_npp_tpu_schedule(t0):
    """``lr_table`` from update ``t0`` on, across two boundaries (epochs 1
    and 2 of 2 updates each), against npp_tpu's optax schedules of the
    three groups, update by update (npp_tpu's rates are float32)."""
    lr_step, factor, per_epoch, k = (1, 2), 0.1, 2, 6
    lamdas = {n: torch.nn.Parameter(torch.zeros(2)) for n in LAMDAS}
    opt, sched = ttrain.make_train_optimizer(
        _Backbone(), lamdas, base_lr=LR, lr_step=lr_step, lr_factor=factor,
        steps_per_epoch=per_epoch)
    state = ttrain.TrainState(model=_Backbone(), lamdas=lamdas,
                              optimizer=opt, scheduler=sched)
    for _ in range(t0):
        opt.step()
        sched.step()
    table = ttrain.lr_table(state, k)
    assert table.shape == (k, 3) and table.dtype == torch.float64
    want = [jtrain.multistep_lr(LR, lr_step, factor, per_epoch),
            jtrain.multistep_lr(0.2 * LR, lr_step, factor, per_epoch),
            lambda t: inspect.signature(jtrain.make_train_optimizer)
            .parameters["criterion_lr"].default]
    ref = np.array([[float(f(t0 + i)) for f in want] for i in range(k)])
    np.testing.assert_allclose(table.numpy(), ref, rtol=1e-6)
    # Before each update the table's row is the rate LambdaLR sets.
    for row in table:
        np.testing.assert_array_equal(row.numpy(), sched.get_last_lr())
        opt.step()
        sched.step()


@pytest.mark.parametrize("part", ["metrics", "model", "lamdas", "adam"])
def test_scanned_step_equals_eager_steps_on_the_cpu(train_runs, part):
    """On the CPU the scanned step (the shared body, the rates from
    ``lr_table``) equals the eager step (the rates from ``LambdaLR``) K
    times across the boundary: equal bit for bit."""
    (snap, p1), (esnap, e1) = train_runs["p1"], train_runs["e1"]
    if part == "metrics":
        for key in p1:
            np.testing.assert_array_equal(
                p1[key].numpy(), torch.stack([m[key] for m in e1]).numpy())
    elif part == "adam":
        assert snap["adam"].keys() == esnap["adam"].keys()
        for k, (c, m, v) in snap["adam"].items():
            ec, em, ev = esnap["adam"][k]
            assert c == ec
            np.testing.assert_array_equal(m, em, err_msg=k)
            np.testing.assert_array_equal(v, ev, err_msg=k)
    else:
        for k, a in snap[part].items():
            np.testing.assert_array_equal(a, esnap[part][k], err_msg=k)


# -- the scanned eval ---------------------------------------------------------

def _val_hosts():
    """Two batches of 2 and a tail batch of 1, with names and indices."""
    hosts = [_host_batch(30 + i, n) for i, n in enumerate((2, 2, 1))]
    start = 0
    for h in hosts:
        n = len(h["names"])
        h["names"] = [f"val_{start + i}" for i in range(n)]
        h["index"] = np.arange(start, start + n, dtype=np.int64)
        start += n
    return hosts


@pytest.fixture(scope="module")
def eval_runs(variables):
    """The port's validate_scanned and validate on npp_tpu's weights."""
    _, v = variables
    hosts = _val_hosts()
    model = build_nppnet(device="cpu", train=False, dtype=torch.float32,
                         generator=torch.Generator().manual_seed(1), **SMALL)
    lamdas = {k: torch.nn.Parameter(torch.zeros(2)) for k in LAMDAS}
    _load(model, lamdas, v)
    crit = {k: p.detach() for k, p in lamdas.items()}
    tbatches = [dict(_torch_batch(h), names=h["names"], index=h["index"])
                for h in hosts]
    scanned = teval.validate_scanned(teval.make_eval_epoch(model, **EVAL_KW),
                                     crit, tbatches, num_classes=20,
                                     log_fn=lambda s: None)
    plain = teval.validate(teval.make_eval_step(model, **EVAL_KW), crit,
                           tbatches, num_classes=20, log_fn=lambda s: None)
    return dict(scanned=scanned, plain=plain)


@pytest.mark.parametrize("key", ["cm", "loss", "pose_preds", "names"])
def test_validate_scanned_equals_validate(eval_runs, key):
    """The port's one-dispatch pass equals its per-batch pass bit for bit
    (the same step, the same order of sums)."""
    got, ref = eval_runs["scanned"], eval_runs["plain"]
    if key == "names":
        assert got["names"] == ref["names"]
    elif key == "loss":
        assert got["loss"] == ref["loss"]
    else:
        np.testing.assert_array_equal(got[key], ref[key])


def test_stack_batches_splits_the_tail_and_keeps_the_layout():
    batches = [dict(_torch_batch(h), names=h["names"], index=h["index"])
               for h in _val_hosts()]
    for b in batches:  # the loader's images on a card: channels_last
        b["image"] = b["image"].contiguous(memory_format=torch.channels_last)
    stacked, names, idxs, tail = teval.stack_batches(batches)
    assert stacked["image"].shape == (2, 2, 3, SIZE, SIZE)
    assert stacked["image"][1].is_contiguous(
        memory_format=torch.channels_last)
    assert torch.equal(stacked["image"][1], batches[1]["image"])
    assert tail is batches[2]
    assert names == [f"val_{i}" for i in range(N_VAL)]
    np.testing.assert_array_equal(idxs, np.arange(N_VAL))
    with pytest.raises(ValueError, match="shape-uniform"):
        teval.stack_batches([batches[2], batches[0], batches[1]])


# -- the capture helpers ------------------------------------------------------

def test_constant_is_made_once_per_value_dtype_and_device():
    a = graphs.constant((1.0, 2.0), torch.float32, "cpu")
    assert graphs.constant((1.0, 2.0), torch.float32, "cpu") is a
    assert graphs.constant((1.0, 2.0), torch.float64, "cpu") is not a
    np.testing.assert_array_equal(a.numpy(), [1.0, 2.0])


def test_program_captures_cuda_tensors_only():
    with pytest.raises(ValueError, match="CUDA graph captures CUDA"):
        graphs.Program(lambda x: x, {"x": torch.zeros(2)})


def test_a_launch_outside_a_capture_counts_as_launched():
    """``count_launch`` on a stream that is not capturing (the CPU here)
    counts a launch, not a recorded call."""
    from npp_tpu_torch.ops import heatmaps

    def wrapper():
        pass
    wrapper.launches = wrapper.captured = 0
    heatmaps.count_launch(wrapper)
    assert (wrapper.launches, wrapper.captured) == (1, 0)
    assert all(hasattr(k, "captured") for k in graphs.KERNELS)


# -- the loader's caches ------------------------------------------------------

class _Counting:
    """A dataset that counts its reads."""

    def __init__(self, ds):
        self.ds, self.reads = ds, 0

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        self.reads += 1
        return self.ds[i]


def _counting_renderer(calls):
    render = tloader.make_target_renderer(normalize_images=True)

    def counted(*args):
        calls.append(1)
        return render(*args)
    return counted


@pytest.mark.parametrize("cache", ["cache_batches", "cache_on_device"])
def test_loader_cache_replays_the_first_epoch(cache):
    """Both packages' caches: the second epoch's batches equal the first's;
    ``cache_batches`` reads no sample again but renders again,
    ``cache_on_device`` does neither. The port's first epoch equals
    npp_tpu's loader's (its host arrays and rendered targets)."""
    ds = _Counting(SyntheticDataset(length=5, crop_size=(SIZE, SIZE),
                                    seed=3, device_normalize=True))
    calls = []
    loader = tloader.DataLoader(ds, 2, device="cpu", num_workers=1,
                                renderer=_counting_renderer(calls),
                                **{cache: True})
    first = list(loader)
    reads, renders = ds.reads, len(calls)
    second = list(loader)
    assert ds.reads == reads == 5
    assert len(calls) == (renders if cache == "cache_on_device"
                          else 2 * renders)
    assert len(first) == len(second) == 3
    for a, b in zip(first, second):
        assert a["names"] == b["names"]
        np.testing.assert_array_equal(a["index"], b["index"])
        for k, t in a.items():
            if isinstance(t, torch.Tensor):
                assert torch.equal(t, b[k]), k
    jl = jloader.DataLoader(ds.ds, 2, shuffle=False, num_workers=1,
                            drop_last=False, renderer=jloader.
                            make_target_renderer(normalize_images=True),
                            **{cache: True})
    jfirst, jsecond = list(jl), list(jl)
    for a, ja, jb in zip(first, jfirst, jsecond):
        for k in ("par", "joints", "pose", "edge"):
            np.testing.assert_array_equal(np.asarray(ja[k]),
                                          np.asarray(jb[k]))
            ref = np.asarray(ja[k])
            if k == "pose":  # npp_tpu's maps are NHWC
                ref = ref.transpose(0, 3, 1, 2)
            np.testing.assert_allclose(a[k].numpy(), ref, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("cache", ["cache_batches", "cache_on_device"])
@pytest.mark.parametrize("package", ["port", "npp_tpu"])
def test_loader_cache_requires_no_shuffle(cache, package):
    ds = SyntheticDataset(length=4, crop_size=(SIZE, SIZE), seed=3)
    with pytest.raises(AssertionError, match="shuffle=False"):
        if package == "port":
            tloader.DataLoader(ds, 2, device="cpu", shuffle=True,
                               **{cache: True})
        else:
            jloader.DataLoader(ds, 2, shuffle=True, **{cache: True})


def test_loader_cache_is_not_filled_by_a_cut_epoch():
    loader = tloader.DataLoader(
        SyntheticDataset(length=6, crop_size=(SIZE, SIZE), seed=3), 2,
        device="cpu", num_workers=1, cache_on_device=True,
        renderer=tloader.make_target_renderer(normalize_images=True))
    it = iter(loader)
    next(it)
    it.close()
    assert loader._device_cache is None
    assert len(list(loader)) == 3 and len(loader._device_cache) == 3


# -- the CLIs -----------------------------------------------------------------

CPU = ["--synthetic", "--tiny", "--device", "cpu", "--dtype", "float32"]


def test_augment_lip_steps_per_dispatch_on_the_cpu(tmp_path):
    """``--steps-per-dispatch 2`` over 3 steps (a chunk and a tail) ends
    where the per-step CLI ends, bit for bit: on the CPU it is the same
    steps."""
    from npp_tpu_torch.tools import augment_lip
    argv = CPU + ["--steps", "3", "--epochs", "1"]
    scanned = augment_lip.main(argv + ["--steps-per-dispatch", "2",
                                       "--out", str(tmp_path / "a")])
    plain = augment_lip.main(argv + ["--out", str(tmp_path / "b")])
    assert np.isfinite(scanned["train_loss"])
    assert scanned["state"].step == plain["state"].step == 3
    a = scanned["state"].model.state_dict()
    for k, t in plain["state"].model.state_dict().items():
        assert torch.equal(a[k], t), k
    assert scanned["result"]["mean_iou"] == plain["result"]["mean_iou"]


@pytest.mark.parametrize("int8", [False, True])
def test_eval_lip_scanned_on_the_cpu(int8):
    """``--scanned`` (with ``--int8`` too) gives the per-batch CLI's
    result."""
    from npp_tpu_torch.tools import eval_lip
    argv = CPU + ["--batch", "2"] + (["--int8"] if int8 else [])
    scanned = eval_lip.main(argv + ["--scanned"])
    plain = eval_lip.main(argv)
    np.testing.assert_array_equal(scanned["cm"], plain["cm"])
    np.testing.assert_array_equal(scanned["pose_preds"], plain["pose_preds"])
    assert scanned["loss"] == plain["loss"]


def test_steps_per_dispatch_must_be_positive(capsys):
    from npp_tpu_torch.tools import augment_lip
    with pytest.raises(SystemExit):
        augment_lip.main(CPU + ["--steps-per-dispatch", "0"])
    assert "at least 1" in capsys.readouterr().err


# -- the refusal under a process group ----------------------------------------

@pytest.fixture
def gloo_group():
    """A gloo process group of one rank in this process."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("what", ["augment_lip", "eval_lip", "train_step",
                                  "validate_scanned"])
def test_one_dispatch_paths_refuse_a_process_group(gloo_group, what, capsys,
                                                   tmp_path):
    """Under a gloo group of one rank each flag and each library call
    refuses, naming npp_tpu's path that is not ported."""
    from npp_tpu_torch.tools import augment_lip, eval_lip
    if what == "augment_lip":
        with pytest.raises(SystemExit):
            augment_lip.main(CPU + ["--steps-per-dispatch", "2", "--out",
                                    str(tmp_path)])
        err = capsys.readouterr().err
        assert "ZeRO steps_per_dispatch" in err and "process group" in err
        return
    if what == "eval_lip":
        with pytest.raises(SystemExit):
            eval_lip.main(CPU + ["--scanned"])
        err = capsys.readouterr().err
        assert "multi-process validate_scanned" in err
        return
    model = build_nppnet(device="cpu", train=False, dtype=torch.float32,
                         generator=torch.Generator().manual_seed(1), **SMALL)
    if what == "train_step":
        step = ttrain.make_train_step_scanned(**LOSS_KW)
        state = ttrain.TrainState(model=model, lamdas={}, optimizer=None,
                                  scheduler=None)
        with pytest.raises(ValueError, match="ZeRO steps_per_dispatch"):
            step(state, _tstack([_torch_batch(_host_batch(1))]))
    else:
        with pytest.raises(ValueError,
                           match="multi-process validate_scanned"):
            teval.validate_scanned(
                teval.make_eval_epoch(model, **EVAL_KW), {}, [],
                num_classes=20)


# -- against npp_tpu (the workers' results; last, so that the port's tests
# run while the workers trace) ------------------------------------------------

def test_scanned_step_losses_match_npp_tpu_across_lr_boundary(train_runs,
                                                              jax_train):
    """Chunk 1's (K,) metrics: step 0 from equal weights at 1e-5, step 1
    (after one update at the full rate) at 1e-3."""
    p1, m1 = train_runs["p1"][1], jax_train["chunk"]["m"]
    for key in ("loss", "loss_pose", "loss_par"):
        got, ref = p1[key].numpy(), m1[key]
        assert got.shape == ref.shape == (K,)
        np.testing.assert_allclose(got[0], ref[0], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got[1], ref[1], rtol=LATER_LOSS_RTOL)


def test_scanned_step_state_matches_npp_tpu_across_lr_boundary(train_runs,
                                                               jax_train):
    """Weights, BN statistics, lambdas, their gradient sum and Adam's
    counts after the chunk that straddles the boundary."""
    _check_against_jax(train_runs["p1"][0], jax_train["chunk"],
                       train_runs["w0"], LR_CHUNK1, "chunk 1")


def test_scanned_tail_chunk_matches_npp_tpu(train_runs, jax_train):
    """The tail chunk of 1 after the chunk of 2: its loss at 1e-3 and the
    state after all three updates."""
    snap, p2 = train_runs["p2"]
    ref = jax_train["tail"]
    assert p2["loss"].shape == ref["m"]["loss"].shape == (1,)
    np.testing.assert_allclose(p2["loss"].numpy(), ref["m"]["loss"],
                               rtol=LATER_LOSS_RTOL)
    _check_against_jax(snap, ref, train_runs["w0"],
                       LR_CHUNK1 + LR * LR_FACTOR, "tail")


def test_train_epoch_scanned_matches_npp_tpu(train_runs, jax_train):
    """The epoch of a chunk and a tail chunk: its mean loss (the mean of
    the dispatches' means, weighted by their steps), no log step without
    a writer, and the final state, which is the two dispatches'."""
    ref = jax_train["epoch"]
    snap, tloss, tgstep = train_runs["pepoch"]
    np.testing.assert_allclose(tloss, ref["loss"], rtol=LATER_LOSS_RTOL)
    assert tgstep == ref["gstep"] == 0
    _check_against_jax(snap, ref, train_runs["w0"],
                       LR_CHUNK1 + LR * LR_FACTOR, "epoch")
    for k, a in train_runs["p2"][0]["model"].items():
        np.testing.assert_array_equal(snap["model"][k], a, err_msg=k)
    for k, a in jax_train["tail"]["w"].items():
        np.testing.assert_array_equal(ref["w"][k], a, err_msg=k)


@pytest.mark.parametrize("key", ["cm", "loss", "pose_preds", "names"])
def test_validate_scanned_with_tail_matches_npp_tpu(eval_runs, jax_eval,
                                                    key):
    got, ref = eval_runs["scanned"], jax_eval
    if key == "cm":  # npp_tpu returns the matrix's metrics, not the matrix
        for k, r in ref.items():
            if k not in ("loss", "pose_preds", "names"):
                np.testing.assert_array_equal(got[k], r, err_msg=k)
    elif key == "loss":
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-4)
    elif key == "pose_preds":
        assert got["pose_preds"].shape == (N_VAL, 16, 3)
        np.testing.assert_allclose(got["pose_preds"], ref["pose_preds"],
                                   atol=KP_ATOL)
    else:
        assert got["names"] == ref["names"] == [f"val_{i}"
                                                for i in range(N_VAL)]
