"""The port's data parallelism against npp_tpu on the CPU: two gloo ranks
at batch 2 each against npp_tpu's one-process train step at batch 4 on
the rank-ordered batch, the negative control, world size 1 under a group,
ZeRO-1, the search pair, the loader's shards, the eval merge and gather
(the PCKh of the gathered predictions), rank-0 checkpoints and the train
CLI under torchrun.

The workers are fresh interpreters that import no JAX (``WORKER``, the
repo's idiom of ``tests/test_multiprocess.py``): the test writes the JAX
weights as ``.npz`` and the host batches, the two ranks load the weights
through the bridge (``utils/convert``), each trains on its half of the
batch and dumps what it holds. They start before the module's one JAX
program (the value-and-gradient of ``npp_tpu.core.train.compute_losses``
at L=4, C=8, 64x64, batch 4, ``ohem_keep=256``, as in
``tests/test_torch_train.py``) and run beside it, as do two
``python -m torch.distributed.run --nproc_per_node=2`` train CLIs.

Tolerances are ``tests/test_torch_train.py``'s: losses and lambda
gradients at rtol 1e-5, running stats at 1e-4 x max|ref| per tensor,
gradients by its per-tensor and norm rule. The weights after one Adam
step: Adam's first update is lr * g / (|g| + eps), about +-lr whatever
|g| is, so an element whose two computed gradients differ in sign ends 2
lr apart. Every element whose gradient on both sides has one sign is
held at rtol 1e-6 + atol 1e-7, as the optimizer test holds Adam fed equal
gradients, and the elements with opposite signs at 2 lr + 1e-7; those are
gradients that are rounding noise (e.g. the conv biases before a
train-mode BN), and the gradient rule holds them. Between two ranks and
one rank of the port (the search pair) the same bounds hold.
"""
import os
import socket
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

from npp_tpu.core import criterion as jcrit
from npp_tpu.core import evaluate as jeval
from npp_tpu.core import train as jtrain
from npp_tpu.data import loader as jloader
from npp_tpu.utils import metrics as jmetrics
from npp_tpu.models.augment import NPPNet as JNPPNet

from npp_tpu_torch.core import checkpoint as tckpt
from npp_tpu_torch.core import evaluate as teval
from npp_tpu_torch.core import search as tsearch
from npp_tpu_torch.core import train as ttrain
from npp_tpu_torch.core.criterion import LIP_CLASS_WEIGHTS
from npp_tpu_torch.data import loader as tloader
from npp_tpu_torch.data.synthetic import SyntheticDataset
from npp_tpu_torch.tools import eval_lip
from npp_tpu_torch.utils import convert
from npp_tpu_torch.utils import metrics as tmetrics

from test_torch_ops import random_variables
from test_torch_train import (GRAD_TOL_NORM, KEYS, LAMDAS, _grad_errors,
                              _host_batch, _jax_batch, _oihw, _torch_batch)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(num_classes=20, num_joints=16, layers=4, init_channels=8,
             refine_layers=1)
SIZE, OHEM_KEEP, LR = 64, 256, 1e-3
WORLD, PER_RANK = 2, 2
OPT = dict(base_lr=LR, lr_step=(2,), lr_factor=0.2, steps_per_epoch=1)
SEARCH_OPT = dict(w_lr=LR, alpha_lr=LR, lr_step=(2,), lr_factor=0.2,
                  steps_per_epoch=1)
N_VAL = 5  # validation set: 5 images, which two ranks do not divide

WORKER = r'''
import os, sys
import numpy as np
import torch
import torch.distributed as dist

from npp_tpu_torch.core import checkpoint as C, evaluate as E
from npp_tpu_torch.core import search as S, train as T
from npp_tpu_torch.core.criterion import LIP_CLASS_WEIGHTS
from npp_tpu_torch.data import loader as L
from npp_tpu_torch.data.synthetic import SyntheticDataset
from npp_tpu_torch.models.augment import build_nppnet
from npp_tpu_torch.parallel import mesh
from npp_tpu_torch.utils import convert

torch.set_num_threads(1)
OUT = sys.argv[1]
CFG = dict(np.load(os.path.join(OUT, "config.npz"), allow_pickle=True))
SMALL, OPT, SEARCH_OPT = (CFG[k].item() for k in ("small", "opt",
                                                  "search_opt"))
LOSS = dict(class_weights=LIP_CLASS_WEIGHTS, ohem_keep=int(CFG["ohem_keep"]))
assert mesh.initialize_distributed("cpu")
rank, world, group = mesh.rank(), mesh.world_size(), mesh.data_group()
variables = convert.load_npz(os.path.join(OUT, "weights.npz"))
render = L.make_target_renderer(normalize_images=True)
KEYS = ("image", "par", "joints", "visibility")


def shard(name, r=rank, n=int(CFG["per_rank"])):
    host = np.load(os.path.join(OUT, name + ".npz"))
    b = {k: torch.from_numpy(np.ascontiguousarray(host[k][r * n:(r + 1) * n]))
         for k in KEYS}
    b.update(render(*(b[k] for k in KEYS)))
    return b


def train_state(g, zero=False):
    st = T.init_train_state(generator=torch.Generator().manual_seed(0),
                            device="cpu", dtype=torch.float32, group=g,
                            zero=zero, **OPT, **SMALL)
    convert.load_jax_variables(st.model, variables, st.lamdas)
    return st


def dump(name, state, metrics):
    out = {f"metric/{k}": v for k, v in metrics.items()}
    for k, p in state.model.named_parameters():
        out[f"param/{k}"] = p.detach()
        if p.grad is not None:
            out[f"grad/{k}"] = p.grad
    for k, b in state.model.named_buffers():
        out[f"buffer/{k}"] = b
    for k, p in state.lamdas.items():
        out[f"lamda/{k}"] = p.detach()
        out[f"lamda_grad/{k}"] = p.grad
    torch.save({k: v.clone() for k, v in out.items()},
               os.path.join(OUT, f"{name}_{rank}.pt"))


batch = shard("train")
step = T.make_train_step(**LOSS)

# One DDP step, and its rank-0 checkpoint.
st = train_state(group)
dump("ddp", st, step(st, batch))
C.CheckpointManager(os.path.join(OUT, "ckpt_ddp")).save(0, st)

# The same under ZeRO-1.
st = train_state(group, zero=True)
dump("zero", st, step(st, batch))
C.CheckpointManager(os.path.join(OUT, "ckpt_zero")).save(0, st)

# The negative control: DDP and the cross-rank BN, per-rank losses.
st = train_state(group)
st.net.train()
st.zero_grad()
loss, m, _ = T.compute_losses(st.net, st.lamdas, batch, **LOSS)
T.backward(loss, st.lamdas, st.group)
st.apply_update()
dump("control", st, m)

# The lambdas' running sum grows by the mean of this step's gradients.
lam = {"a": torch.nn.Parameter(torch.zeros(2))}
lam["a"].grad = torch.tensor([10.0, 20.0])
T.backward((rank + 1.0) * lam["a"].sum() * torch.tensor([1.0, 2.0]).sum(),
           lam, group)
np.save(os.path.join(OUT, f"accum_{rank}.npy"), lam["a"].grad.numpy())

# World size 1 under a group (rank 0 alone) against no group: two steps.
solo = dist.new_group([0])
if rank == 0:
    plain, wrapped = train_state(None), train_state(solo)
    assert type(wrapped.net).__name__ == "DistributedDataParallel"
    for b in (batch, shard("train", r=1)):
        m_plain, m_wrapped = step(plain, b), step(wrapped, b)
    dump("solo_none", plain, m_plain)
    dump("solo_group", wrapped, m_wrapped)

# The search pair.
ss = S.init_search_state(generator=torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32, group=group,
                         **SEARCH_OPT, **SMALL)
weight_step, arch_step = S.make_search_steps(**LOSS)
dump("search_w", ss, weight_step(ss, batch))
dump("search_pair", ss, arch_step(ss, shard("mini"), 1.0))
ss = S.init_search_state(generator=torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32, group=group,
                         **SEARCH_OPT, **SMALL)
dump("search_a", ss, arch_step(ss, shard("mini"), 1.0))

# validate and validate_ppp over a set the ranks do not divide.
model = build_nppnet(device="cpu", generator=torch.Generator().manual_seed(0),
                     train=False, dtype=torch.float32, **SMALL)
crit = T.criterion.init_criterion_params(2)
ds = SyntheticDataset(length=int(CFG["n_val"]), crop_size=(64, 64), seed=3,
                      device_normalize=True)
loader = L.DataLoader(ds, 2, device="cpu", num_workers=1, renderer=render)
res = E.validate(E.make_eval_step(model, num_classes=20, decode_hw=(64, 64),
                                  class_weights=LIP_CLASS_WEIGHTS,
                                  ohem_keep=LOSS["ohem_keep"]),
                 crit, loader, num_classes=20,
                 pred_csv=os.path.join(OUT, "pred.csv"),
                 gt_csv=os.path.join(OUT, "gt.csv"), log_fn=lambda s: None)
ppp_model = build_nppnet(device="cpu", train=False, dtype=torch.float32,
                         generator=torch.Generator().manual_seed(0),
                         **dict(SMALL, num_classes=7, num_joints=14))
ppp_ds = SyntheticDataset(length=int(CFG["n_val"]), crop_size=(64, 64),
                          num_joints=14, num_classes=7, seed=4,
                          device_normalize=True)
ppp_render = L.make_target_renderer(num_joints=14, normalize_images=True)
ppp = E.validate_ppp(
    E.make_ppp_eval_step(ppp_model, num_classes=7,
                         class_weights=LIP_CLASS_WEIGHTS[:7],
                         ohem_keep=LOSS["ohem_keep"]),
    crit, L.DataLoader(ppp_ds, 2, device="cpu", num_workers=1,
                       renderer=ppp_render),
    num_classes=7, log_fn=lambda s: None)
np.savez(os.path.join(OUT, f"validate_{rank}.npz"), cm=res["cm"],
         loss=res["loss"], preds=res["pose_preds"],
         names=np.asarray(res["names"]), pck=res["pck"], ppp_cm=ppp["cm"],
         ppp_pck=ppp["pck"], ppp_loss=ppp["loss"])
dist.destroy_process_group()
print(f"WORKER_OK rank={rank}")
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", PYTHONWARNINGS="ignore", **extra)
    return env


def _launch_workers(out: Path) -> list:
    port = str(_free_port())
    return [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(out)], cwd=ROOT,
        env=_env(RANK=str(r), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(r),
                 MASTER_ADDR="localhost", MASTER_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]


def _launch_cli(out: Path, *extra) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={WORLD}", "-m", "npp_tpu_torch.tools.augment_lip",
         "--device", "cpu", "--tiny", "--synthetic", "--steps", "2",
         "--epochs", "1", "--dtype", "float32", "--out", str(out), *extra],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _wait(procs, timeout=240) -> list:
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out))
    return outs


def _host(seed, extra_ignore):
    """test_torch_train's batch of 4 with more ignored pixels in sample 3:
    the two shards hold different counts of ignored and edge pixels."""
    host = _host_batch(seed)
    host["par"][3, extra_ignore:, :40] = 255
    return host


def _write_gt_csv(path, n, seed):
    """A LIP pose ground-truth CSV of ``n`` rows (x, y, visibility per
    joint, a few joints missing) over 64x64 images."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n):
            cells = []
            for _ in range(16):
                if rng.random() < 0.1:
                    cells += ["nan", "nan", "0"]
                else:
                    cells += [f"{rng.uniform(0, 64):.1f}",
                              f"{rng.uniform(0, 64):.1f}", "1"]
            f.write(",".join([f"im{i}"] + cells) + "\n")


def _write_npz(path, tree):
    np.savez(path, **{"/".join(k): np.asarray(v)
                      for k, v in flatten_dict(tree).items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two worker ranks and the two torchrun CLIs (started first), and
    npp_tpu's value-and-gradient and Adam step at batch 4 beside them."""
    out = tmp_path_factory.mktemp("parallel")
    clis = [_launch_cli(out / "cli"), _launch_cli(out / "cli_zero", "--zero")]
    jm = JNPPNet(dtype=jnp.float32, **SMALL)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    v = random_variables(shapes, seed=0)
    _write_npz(out / "weights.npz",
               {"params": {"model": v["params"], "criterion": LAMDAS},
                "batch_stats": v["batch_stats"]})
    host, mini = _host(3, 40), _host(5, 20)
    np.savez(out / "train.npz", **{k: host[k] for k in KEYS})
    np.savez(out / "mini.npz", **{k: mini[k] for k in KEYS})
    np.savez(out / "config.npz", small=SMALL, opt=OPT, search_opt=SEARCH_OPT,
             ohem_keep=OHEM_KEEP, per_rank=PER_RANK, n_val=N_VAL)
    _write_gt_csv(out / "gt.csv", N_VAL, seed=6)
    procs = _launch_workers(out) + clis
    try:
        params = {"model": v["params"],
                  "criterion": {k: jnp.asarray(a) for k, a in LAMDAS.items()}}
        jbatch = _jax_batch(host)
        tx = jtrain.make_train_optimizer(LR, lr_step=(2,), lr_factor=0.2,
                                         steps_per_epoch=1)

        def program(p):
            def loss_fn(p):
                return jtrain.compute_losses(
                    jm, p, v["batch_stats"], jbatch, train=True,
                    class_weights=jcrit.LIP_CLASS_WEIGHTS,
                    ohem_keep=OHEM_KEEP)

            (_, (stats, metrics, _)), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(p)
            updates, _ = tx.update(grads, tx.init(p), p)
            return dict(metrics=metrics, grads=grads, stats=stats,
                        params=optax.apply_updates(p, updates))

        jax_ref = jax.device_get(jax.jit(program)(params))
    finally:
        results = _wait(procs)
    for rc, log in results:
        assert rc == 0, log[-4000:]
    return dict(out=out, jax=jax_ref, host=host, mini=mini, dumps={})


def _dump(runs, name, rank):
    key = (name, rank)
    if key not in runs["dumps"]:
        blob = torch.load(runs["out"] / f"{name}_{rank}.pt",
                          weights_only=True)
        runs["dumps"][key] = {k: v.numpy() for k, v in blob.items()}
    return runs["dumps"][key]


def _section(d, prefix):
    return {k[len(prefix) + 1:]: v for k, v in d.items()
            if k.startswith(prefix + "/")}


def _jax_model(tree, collection):
    return {convert.torch_key(collection, p): _oihw(p, a)
            for p, a in flatten_dict(tree).items()}


def _mean_metric(runs, name, key):
    return np.mean([_dump(runs, name, r)[f"metric/{key}"]
                    for r in range(WORLD)])


def _adam_close(got, ref, g_got, g_ref, where):
    """One Adam step from equal weights (module docstring): the step is
    lr * g / (|g| + eps), so the weights may be apart by lr times the
    difference of that function of the two gradients, plus Adam's
    rounding."""
    u = lambda g: g.astype(np.float64) / (np.abs(g) + 1e-8)
    bound = LR * np.abs(u(g_got) - u(g_ref)) + 1e-7 + 1e-6 * np.abs(ref)
    assert np.all(np.abs(got - ref) <= bound), where


@pytest.mark.parametrize("key", ["loss", "loss_pose", "loss_par"])
def test_two_ranks_losses_match_jax_at_the_global_batch(runs, key):
    np.testing.assert_allclose(_mean_metric(runs, "ddp", key),
                               float(runs["jax"]["metrics"][key]), rtol=1e-5)


def test_two_ranks_gradients_match_jax(runs):
    """DDP's averaged gradients, the same on both ranks, against npp_tpu's
    at batch 4 (``test_torch_train.py``'s rule)."""
    g0 = _section(_dump(runs, "ddp", 0), "grad")
    g1 = _section(_dump(runs, "ddp", 1), "grad")
    for k in g0:
        np.testing.assert_array_equal(g0[k], g1[k], err_msg=k)
    worst, key, norm = _grad_errors(
        g0, _jax_model(runs["jax"]["grads"]["model"], "params"))
    assert worst <= 1.0 and norm <= GRAD_TOL_NORM, (worst, key, norm)


def test_two_ranks_running_stats_match_jax(runs):
    ref = _jax_model(runs["jax"]["stats"], "batch_stats")
    bufs = [_section(_dump(runs, "ddp", r), "buffer") for r in range(WORLD)]
    for k, want in ref.items():
        np.testing.assert_array_equal(bufs[0][k], bufs[1][k], err_msg=k)
        scale = max(float(np.abs(want).max()), 1e-12)
        assert float(np.abs(bufs[0][k] - want).max()) <= 1e-4 * scale, k
    assert len(ref) > 100


def test_two_ranks_lamdas_and_adam_step_match_jax(runs):
    d = _dump(runs, "ddp", 0)
    jgrads, jparams = runs["jax"]["grads"], runs["jax"]["params"]
    for k in LAMDAS:
        np.testing.assert_allclose(d[f"lamda_grad/{k}"],
                                   np.asarray(jgrads["criterion"][k]),
                                   rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(d[f"lamda/{k}"],
                                   np.asarray(jparams["criterion"][k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    ref = _jax_model(jparams["model"], "params")
    gref = _jax_model(jgrads["model"], "params")
    params, grads = _section(d, "param"), _section(d, "grad")
    for k in ref:
        _adam_close(params[k], ref[k], grads[k], gref[k], k)


def test_per_rank_losses_miss_jax(runs):
    """The negative control: the same two ranks with DDP and the
    cross-rank BN but each rank's own loss miss the global batch's loss
    and lambda gradients."""
    ref = runs["jax"]
    got = _mean_metric(runs, "control", "loss_par")
    want = float(ref["metrics"]["loss_par"])
    assert abs(got - want) > 10 * 1e-5 * abs(want), (got, want)
    d = _dump(runs, "control", 0)
    g = d["lamda_grad/lamda_par"]
    want_g = np.asarray(ref["grads"]["criterion"]["lamda_par"])
    assert np.abs(g - want_g).max() > 10 * 1e-5 * np.abs(want_g).max()


def test_lamda_running_sum_grows_by_the_mean_gradient(runs):
    """Each rank held [10, 20] and its loss gave (rank + 1) * 3: the sum
    grows by the mean, 4.5, on both ranks."""
    for r in range(WORLD):
        np.testing.assert_array_equal(
            np.load(runs["out"] / f"accum_{r}.npy"), [14.5, 24.5])


def test_world_size_one_under_a_group_is_the_plain_step_bit_for_bit(runs):
    plain, wrapped = (_dump(runs, "solo_none", 0),
                      _dump(runs, "solo_group", 0))
    assert plain.keys() == wrapped.keys()
    for k in plain:
        np.testing.assert_array_equal(plain[k], wrapped[k], err_msg=k)


def test_zero_equals_plain_ddp(runs):
    for r in range(WORLD):
        ddp, zero = _dump(runs, "ddp", r), _dump(runs, "zero", r)
        assert ddp.keys() == zero.keys()
        for k in ddp:
            np.testing.assert_array_equal(ddp[k], zero[k], err_msg=k)


def _search_state():
    return tsearch.init_search_state(
        generator=torch.Generator().manual_seed(0), device="cpu",
        dtype=torch.float32, **SEARCH_OPT, **SMALL)


def _snapshot(state, metrics) -> dict:
    out = {f"metric/{k}": v.item() for k, v in metrics.items()}
    for k, p in state.model.named_parameters():
        out[f"param/{k}"] = p.detach().numpy().copy()
        out[f"grad/{k}"] = p.grad.numpy().copy()
    out.update({f"buffer/{k}": b.numpy().copy()
                for k, b in state.model.named_buffers()})
    out.update({f"lamda/{k}": p.detach().numpy().copy()
                for k, p in state.lamdas.items()})
    return out


@pytest.fixture(scope="module")
def one_rank_search(runs):
    """The port's search steps at one rank x 4 from the seeded state: a
    weight step, the arch step after it (the pair), and an arch step
    alone; with the seeded weights and the architecture parameters'
    names."""
    weight_step, arch_step = tsearch.make_search_steps(
        class_weights=LIP_CLASS_WEIGHTS, ohem_keep=OHEM_KEEP)
    host, mini = _torch_batch(runs["host"]), _torch_batch(runs["mini"])
    state = _search_state()
    arch = {id(p) for p in state.model.arch_parameters().values()}
    out = {"seeded": {k: p.detach().numpy().copy()
                      for k, p in state.model.named_parameters()},
           "arch": {k for k, p in state.model.named_parameters()
                    if id(p) in arch}}
    out["w"] = _snapshot(state, weight_step(state, host))
    out["pair"] = _snapshot(state, arch_step(state, mini, 1.0))
    state = _search_state()
    out["a"] = _snapshot(state, arch_step(state, mini, 1.0))
    return out


STATS_ATOL = 1e-6  # chip_smoke.py's: BNs whose batch mean is rounding noise


@pytest.mark.parametrize("which", ["w", "a"])
def test_search_steps_two_ranks_match_one_rank_at_the_global_batch(
        runs, one_rank_search, which):
    """A weight step (``w``), or an arch step (``a``, entropy on), from the
    seeded state at two ranks x 2 against the port's one rank x 4: the
    losses, the gradients and updates of the parameters the step trains
    (weights and lambdas, or the architecture parameters with the L2
    decay the arch Adam adds to their gradient), and the running stats
    (1e-4 x max|ref| plus STATS_ATOL: the extra BN after a pool
    normalises a BN's output, so its running mean is rounding noise near
    0)."""
    ref, seeded = one_rank_search[which], one_rank_search["seeded"]
    name = f"search_{which}"
    for k in ("loss", "loss_pose", "loss_par"):
        np.testing.assert_allclose(_mean_metric(runs, name, k),
                                   ref[f"metric/{k}"], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(_mean_metric(runs, name, "entropy"),
                               ref["metric/entropy"], rtol=1e-6)
    d = [_dump(runs, name, r) for r in range(WORLD)]
    for k in d[0]:
        if not k.startswith("metric/"):
            np.testing.assert_array_equal(d[0][k], d[1][k], err_msg=k)
    trained = [k for k in seeded
               if (k in one_rank_search["arch"]) == (which == "a")]
    worst, key, norm = _grad_errors({k: d[0][f"grad/{k}"] for k in trained},
                                    {k: ref[f"grad/{k}"] for k in trained})
    assert worst <= 1.0 and norm <= GRAD_TOL_NORM, (worst, key, norm)
    decay = tsearch.ALPHA_WEIGHT_DECAY if which == "a" else 0.0
    for k in trained:
        _adam_close(d[0][f"param/{k}"], ref[f"param/{k}"],
                    d[0][f"grad/{k}"] + decay * seeded[k],
                    ref[f"grad/{k}"] + decay * seeded[k], k)
    for k in LAMDAS:
        np.testing.assert_allclose(d[0][f"lamda/{k}"], ref[f"lamda/{k}"],
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    for k, want in ref.items():
        if k.startswith("buffer/"):
            scale = max(float(np.abs(want).max()), 1e-12)
            assert np.abs(d[0][k] - want).max() <= \
                1e-4 * scale + STATS_ATOL, k


def test_search_pair_two_ranks_match_one_rank(runs, one_rank_search):
    """The pair as the search epoch runs it (weight step, then arch step)
    at two ranks against one: after the weight step the weights differ
    where Adam's first step met opposite signs, so the arch step's losses
    are held at test_torch_search.py's rtol 1e-3, and its architecture
    gradients differ past the gradient rule (6.7 of it here; the arch
    step alone holds them). The arch Adam's first update is held by its
    rule on each side's own gradient plus the L2 decay."""
    ref = one_rank_search["pair"]
    for k in ("loss", "loss_pose", "loss_par"):
        np.testing.assert_allclose(_mean_metric(runs, "search_pair", k),
                                   ref[f"metric/{k}"], rtol=1e-3, err_msg=k)
    d = _dump(runs, "search_pair", 0)
    arch, seeded = one_rank_search["arch"], one_rank_search["seeded"]
    decay = tsearch.ALPHA_WEIGHT_DECAY
    for k in arch:
        _adam_close(d[f"param/{k}"], ref[f"param/{k}"],
                    d[f"grad/{k}"] + decay * seeded[k],
                    ref[f"grad/{k}"] + decay * seeded[k], k)


# --------------------------------------------------------------------------
# The loader's shards and the eval merge (no processes).

@pytest.mark.parametrize("count", [1, 2, 3])
@pytest.mark.parametrize("length", [12, 11])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_loader_shards_match_jax(count, length, shuffle, drop_last):
    ds = SyntheticDataset(length=length, crop_size=(16, 16))
    for index in range(count):
        ours = tloader.DataLoader(ds, 2, device="cpu", shuffle=shuffle,
                                  drop_last=drop_last, seed=5,
                                  process_index=index, process_count=count)
        ref = jloader.DataLoader(ds, 2, shuffle=shuffle, drop_last=drop_last,
                                 seed=5, process_index=index,
                                 process_count=count)
        for epoch in (0, 1):
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            got, want = ours._indices(), ref._indices()
            assert len(ours) == len(ref) == len(got)
            assert [b.tolist() for b in got] == [b.tolist() for b in want]


@pytest.mark.parametrize("count", [2, 3])
@pytest.mark.parametrize("by", ["names", "names_src"])
def test_merge_eval_shards_matches_jax(count, by):
    n = 7
    total = -(-n // count) * count
    idx = np.concatenate([np.arange(n), np.arange(total - n)])
    idxs = np.concatenate([idx[r::count] for r in range(count)])
    preds = np.random.default_rng(count).normal(0, 1, (total, 16, 3))
    table = [f"im{i}" for i in range(n)]
    kw = ({"names": [table[i] for i in idxs]} if by == "names"
          else {"names_src": table})
    got = teval.merge_eval_shards(preds, idxs, **kw)
    want = jeval.merge_eval_shards(preds, idxs, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == table


# --------------------------------------------------------------------------
# The eval gather, checkpoints and the CLI.

def test_two_rank_validate_is_the_same_on_both_ranks_in_dataset_order(runs):
    """Both ranks return one result; the predictions, in dataset order,
    equal the one-process pass's; the summed confusion matrices count the
    wrap-padding duplicate (npp_tpu's quirk), so they hold the valid
    pixels of N_VAL + 1 images."""
    v = [dict(np.load(runs["out"] / f"validate_{r}.npz"))
         for r in range(WORLD)]
    for k in v[0]:
        np.testing.assert_array_equal(v[0][k], v[1][k], err_msg=k)
    model = ttrain.build_nppnet(device="cpu", train=False,
                                dtype=torch.float32,
                                generator=torch.Generator().manual_seed(0),
                                **SMALL)
    ds = SyntheticDataset(length=N_VAL, crop_size=(64, 64), seed=3,
                          device_normalize=True)
    render = tloader.make_target_renderer(normalize_images=True)
    one = teval.validate(
        teval.make_eval_step(model, num_classes=20, decode_hw=(64, 64),
                             class_weights=LIP_CLASS_WEIGHTS,
                             ohem_keep=OHEM_KEEP),
        ttrain.criterion.init_criterion_params(2),
        tloader.DataLoader(ds, 2, device="cpu", num_workers=1,
                           renderer=render), num_classes=20)
    # The gathered names come from the dataset's table, as in npp_tpu;
    # the synthetic set's table adds ".jpg" to its samples' names.
    assert list(v[0]["names"]) == ds.image_names()
    assert [n + ".jpg" for n in one["names"]] == ds.image_names()
    np.testing.assert_allclose(v[0]["preds"], one["pose_preds"], atol=1e-4)
    valid = [int((ds[i]["par"] != 255).sum()) for i in range(N_VAL)]
    assert v[0]["cm"].sum() == sum(valid) + valid[0] == \
        one["cm"].sum() + valid[0]
    assert v[0]["ppp_cm"].sum() > 0 and np.isfinite(v[0]["ppp_pck"]).all()
    lines = (runs["out"] / "pred.csv").read_text().splitlines()
    assert len(lines) == N_VAL
    # Every rank's PCKh, from the gathered predictions in memory, is the
    # CSV protocol's on the file that rank 0 wrote.
    np.testing.assert_array_equal(v[0]["pck"], tmetrics.calc_pck_lip(
        str(runs["out"] / "gt.csv"), str(runs["out"] / "pred.csv"),
        eval_num=N_VAL))


@pytest.mark.parametrize("seed", [0, 1])
def test_pckh_of_predictions_in_memory_is_the_csv_protocols(tmp_path, seed):
    """``validate``'s PCKh reads the predictions as the pose CSV holds
    them (integer pixels in LIP joint order, a negative read as 1): equal
    to npp_tpu's ``calc_pck_lip`` on the written file, fractional and
    negative coordinates included."""
    gt = str(tmp_path / "gt.csv")
    _write_gt_csv(gt, 6, seed=seed)
    preds = np.random.default_rng(seed).uniform(-3, 66, (6, 16, 3))
    preds = preds.astype(np.float32)
    csv_path = str(tmp_path / "pred.csv")
    tmetrics.save_pose_csv([f"im{i}" for i in range(6)], preds, csv_path)
    got = tmetrics.pckh_against_csv(gt, tmetrics.as_pose_csv_reads(preds),
                                    eval_num=6)
    np.testing.assert_array_equal(got, jmetrics.calc_pck_lip(
        gt, csv_path, eval_num=6))


@pytest.mark.parametrize("name", ["ddp", "zero"])
def test_rank0_checkpoint_restores_in_one_process(runs, name):
    directory = runs["out"] / f"ckpt_{name}"
    blob = torch.load(directory / "0" / "state.pt", weights_only=True)
    assert not any("module." in k for k in blob["model"])
    state = ttrain.init_train_state(
        generator=torch.Generator().manual_seed(9), device="cpu",
        dtype=torch.float32, **OPT, **SMALL)
    _, meta = tckpt.CheckpointManager(str(directory)).restore(state)
    assert meta["epoch"] == 0 and state.step == 1
    d = _dump(runs, name, 0)
    for k, p in state.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), d[f"param/{k}"])
    for k, p in state.lamdas.items():
        np.testing.assert_array_equal(p.grad.numpy(), d[f"lamda_grad/{k}"])
    opt = state.optimizer.state_dict()
    assert len(opt["state"]) == sum(len(g["params"])
                                    for g in opt["param_groups"])


@pytest.mark.parametrize("cli", ["cli", "cli_zero"])
def test_train_cli_under_torchrun_and_its_checkpoint_in_eval_lip(runs, cli):
    root = runs["out"] / cli / "lip" / "augment" / "tiny"
    logs = list(root.glob("*.log"))
    assert len(logs) == 1  # rank 0's alone
    text = logs[0].read_text()
    assert "rank 0 of 2" in text and "train loss" in text
    loss = float(text.split("train loss ")[1].split()[0])
    assert np.isfinite(loss)
    ckpt = root / "checkpoints"
    for name in ("0", "best", "final"):
        blob = torch.load(ckpt / name / "state.pt", weights_only=True)
        assert not any(k.startswith("module.") for k in blob["model"])
    result = eval_lip.main(["--synthetic", "--tiny", "--batch", "2",
                            "--device", "cpu", "--dtype", "float32",
                            "--ckpt", str(ckpt)])
    assert np.isfinite(result["loss"]) and len(result["names"]) == 4
