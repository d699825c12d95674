"""The port's spatial partitioning against npp_tpu on the CPU: the
``data x space`` grids 1x2, 1x4 and 2x2 of one group of four gloo ranks.

npp_tpu's own sp tests (``tests/test_spatial.py``) hold the H-sharded
forward to the unsharded one at 1e-4 abs and the dp x sp train step to
the one-device step, at 64 px with n_space up to 4; the port does the
halo exchanges itself (``npp_tpu_torch/parallel/spatial.py``), so here:

- every op that reads across rows, alone at heights 16 and 12 (at
  n_space 4 the shards of 12 rows are odd and the strided ops gather),
  in eval mode and in train mode with its input and weight gradients,
  against the same op unsharded, on every rank's rows (both image edges
  included);
- NPPNet (L=4, C=8, 64 px; at n_space 4 its 1/16 level is one row a
  rank and its 1/32 and 1/64 levels are held whole) in eval mode
  against the port's unsharded forward at 1e-4 abs (npp_tpu's bound),
  and the negative control: the same shards through the unconverted
  model miss that bound;
- the dp x sp train step (``init_train_state(grid=)``,
  ``make_train_step(grid=)``) at the global batch of 4 against npp_tpu's
  one-device step, to ``tests/test_torch_parallel.py``'s bounds: losses,
  train-mode outputs (1e-4 x max|ref|, ``tests/test_torch_model.py``'s
  bound), gradients, running stats, lambdas and the Adam step (Adam's
  first step applied to npp_tpu's gradients by the port's optimizer,
  which ``tests/test_torch_train.py`` holds to optax: tracing optax's
  update over the ~1,000 leaves here would double the JAX program);
- ``Predictor(mesh=)`` with pose scales and padding against npp_tpu's
  unsharded Predictor on npp_tpu's canvases, to
  ``tests/test_torch_serve.py``'s bounds;
- ``multi_scale_inference(mesh=)`` against the port's unsharded one
  (which ``tests/test_torch_serve.py`` holds against npp_tpu's);
- ``test_lip --mesh`` under ``python -m torch.distributed.run`` against
  the one-process CLI;
- the loader's ``grid=``: each rank's data shard, rendered at full
  height, and its rows;
- ``check_divisibility``'s and the grid's messages against npp_tpu's.

The four ranks (``WORKER``) import torch only; they start first and run
beside the module's two JAX programs (npp_tpu's value-and-gradient and
its pose-scales Predictor), which are compiled with most XLA
optimisations off to keep the file short.
"""
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

cv2 = pytest.importorskip("cv2")

from npp_tpu.core import criterion as jcrit  # noqa: E402
from npp_tpu.core import train as jtrain  # noqa: E402
from npp_tpu.core.predictor import Predictor as JPredictor  # noqa: E402
from npp_tpu.models.augment import NPPNet as JNPPNet  # noqa: E402
from npp_tpu.parallel import spatial as jspatial  # noqa: E402

from npp_tpu_torch.core import train as ttrain  # noqa: E402
from npp_tpu_torch.data import loader as tloader  # noqa: E402
from npp_tpu_torch.data.synthetic import SyntheticDataset  # noqa: E402
from npp_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from npp_tpu_torch.parallel import spatial as tspatial  # noqa: E402
from npp_tpu_torch.tools import test_lip  # noqa: E402
from npp_tpu_torch.utils import convert  # noqa: E402

from test_torch_ops import random_variables  # noqa: E402
from test_torch_parallel import (_adam_close, _env, _free_port,  # noqa: E402
                                 _jax_model, _wait, _write_npz)
from test_torch_train import (GRAD_TOL_NORM, KEYS, LAMDAS,  # noqa: E402
                              _grad_errors, _host_batch, _jax_batch)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(num_classes=20, num_joints=16, layers=4, init_channels=8,
             refine_layers=1)
SIZE, OHEM_KEEP, LR = 64, 256, 1e-3
WORLD = 4
GRIDS = ("1x2", "1x4", "2x2")
POSE_SCALES = (1.0, 0.75)
# (h, w) of the raw images: five, which the device batch pads to 8.
SERVE_SIZES = ((31, 47), (100, 80), (50, 90), (64, 64), (90, 61))
FWD_ATOL = 1e-4      # npp_tpu's bound for the sharded forward
OUT_REL = 1e-4       # outputs and running stats: 1e-4 x max|ref|
OP_REL = 1e-5        # one op against itself unsharded: x max|ref|
KP_ATOL = 1e-4       # crop px (tests/test_torch_serve.py)
MARGIN = 1e-4        # top-2 logit margin under which labels may differ
MS_REL = 1e-5        # multi-scale against the port's unsharded one

WORKER = r'''
import os, sys
import numpy as np
import torch
import torch.distributed as dist

from npp_tpu_torch.core import train as T
from npp_tpu_torch.core.criterion import LIP_CLASS_WEIGHTS
from npp_tpu_torch.core.multiscale import multi_scale_inference
from npp_tpu_torch.core.predictor import Predictor
from npp_tpu_torch.core.test_seg import make_parsing_apply_fn
from npp_tpu_torch.data import loader as L
from npp_tpu_torch.models.augment import _Stem, build_nppnet, init_weights
from npp_tpu_torch.models.cells import InterOp
from npp_tpu_torch.ops.primitives import make_op
from npp_tpu_torch.parallel import mesh, spatial
from npp_tpu_torch.utils import convert

torch.set_num_threads(1)
OUT = sys.argv[1]
CFG = dict(np.load(os.path.join(OUT, "config.npz"), allow_pickle=True))
SMALL, OPT = CFG["small"].item(), CFG["opt"].item()
LOSS = dict(class_weights=LIP_CLASS_WEIGHTS, ohem_keep=int(CFG["ohem_keep"]))
POSE_SCALES = tuple(CFG["pose_scales"])
assert mesh.initialize_distributed("cpu")
rank = mesh.rank()
variables = convert.load_npz(os.path.join(OUT, "weights.npz"))
data = dict(np.load(os.path.join(OUT, "data.npz")))
host = {k: torch.from_numpy(data[k]) for k in ("image", "par", "joints",
                                                  "visibility")}
batch = dict(host)
batch.update(L.make_target_renderer(normalize_images=True)(
    *(host[k] for k in ("image", "par", "joints", "visibility"))))
eval_image = torch.from_numpy(data["eval_image"])
ms_image = torch.from_numpy(data["ms_image"])
serve = np.load(os.path.join(OUT, "serve.npz"))
images = [serve[f"im{i}"] for i in range(int(serve["n"]))]
# npp_tpu's (cv2) preprocess of each image at each pose scale.
table = {(im.shape, float(sm)): (serve[f"canvas{i}_{j}"], serve[f"cp{i}_{j}"],
                                 float(serve[f"scale{i}_{j}"]))
         for i, im in enumerate(images) for j, sm in enumerate(POSE_SCALES)}


def jax_preprocess(im, scale_mult=1.0):
    return table[(im.shape, float(scale_mult))]


def eval_model():
    m = build_nppnet(device="cpu", generator=torch.Generator().manual_seed(0),
                     dtype=torch.float32, **SMALL)
    return convert.load_jax_variables(m, variables)


def predictor(**kw):
    p = Predictor(eval_model(), crop_size=(64, 64), pose_scales=POSE_SCALES,
                  flip_test=False, **kw)
    p.preprocess = jax_preprocess
    return p


def flat(outs):
    return [t.detach().clone() for stage in outs for pair in stage
            for t in pair]


def message(fn):
    try:
        fn()
    except (ValueError, RuntimeError) as e:
        return str(e)
    return ""


# -- one op alone ---------------------------------------------------------

C_OP = 4
OPS = [("stem", 2)] + [(n, s) for n in (
    "avg_pool_3x3", "max_pool_3x3", "std_conv_3x3", "dil_conv_3x3_2",
    "dil_conv_3x3_4", "dil_conv_5x5_4", "se_connect", "conv_7x1_1x7",
    "sep_conv_3x3", "sep_conv_5x5", "poled_conv_x1", "poled_conv_x2")
    for s in (1, 2)] + [("std_conv_1x1", 1), ("skip_connect", 2),
                        ("none", 2), ("inter_x2", 1), ("inter_x0.5", 1),
                        ("inter_x0.25", 1)]


def build_op(name, stride, seed):
    if name == "stem":
        op = _Stem(3, C_OP, stride)
    elif name.startswith("inter_x"):
        op = InterOp("std_conv_3x3", C_OP, 2 * C_OP,
                     float(name[len("inter_x"):]), adapt=True)
    else:
        op = make_op(name, C_OP, stride)
    init_weights(op, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():  # BN statistics that are not the identity
        for m in op.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.5, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    return op


def rows(t, grid, n_b):
    """This rank's batch shard and rows of a whole (B, C, H, W) tensor
    (all rows where the height does not divide: a level held whole)."""
    b = n_b // grid.n_data
    t = t[grid.d * b:(grid.d + 1) * b]
    return spatial.own_rows(t, grid)


def op_case(grid, name, stride, height, seed):
    """Max errors of the sharded op against itself unsharded: eval output,
    train output, input gradient, weight gradients (summed over ranks)."""
    c_in = 3 if name == "stem" else C_OP
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(2, c_in, height, 16, generator=gen)
    ref, op = build_op(name, stride, seed), build_op(name, stride, seed)
    spatial.convert_spatial(op, grid)
    err = {}
    ref.eval(), op.eval()
    with torch.no_grad():
        want = ref(x)
        got = op(rows(x, grid, 2))
    err["eval"] = ((got - rows(want, grid, 2)).abs().max().item(),
                   want.abs().max().item())
    ref.train(), op.train()
    xr = x.clone().requires_grad_()
    want = ref(xr)
    w = torch.randn(want.shape, generator=gen)
    (want * w).sum().backward()
    xl = rows(x, grid, 2).clone().requires_grad_()
    got = op(xl)
    share = 1.0 if got.shape[-2] != want.shape[-2] or grid.n_space == 1 \
        else 1.0 / grid.n_space  # a level held whole: each rank a share
    (got * rows(w, grid, 2)).sum().mul(share).backward()
    err["train"] = ((got - rows(want.detach(), grid, 2)).abs().max().item(),
                    want.abs().max().item())
    err["grad_in"] = ((xl.grad - rows(xr.grad, grid, 2)).abs().max().item(),
                      xr.grad.abs().max().item())
    gw, gr = 0.0, 0.0
    for (k, p), (_, q) in zip(op.named_parameters(), ref.named_parameters()):
        total = mesh.all_sum(p.grad, grid.world)
        gw = max(gw, (total - q.grad).abs().max().item())
        gr = max(gr, q.grad.abs().max().item())
    err["grad_w"] = (gw, gr)
    return err


# -- NPPNet ---------------------------------------------------------------

def train_state(grid):
    st = T.init_train_state(generator=torch.Generator().manual_seed(0),
                            device="cpu", dtype=torch.float32, grid=grid,
                            **OPT, **SMALL)
    convert.load_jax_variables(st.model, variables, st.lamdas)
    return st


def same_on_every_rank(t, grid):
    """max |t - t on the grid's first rank| over the grid."""
    first = t.clone()
    src = dist.get_process_group_ranks(grid.world)[0]
    dist.broadcast(first, src=src, group=grid.world)
    return mesh.all_sum((t - first).abs().max().reshape(1),
                        grid.world).item()


def run_grid(grid, ms_ref):
    out = {"d": grid.d, "s": grid.s}
    # The eval forward, its unsharded reference and the no-halo control.
    ref, sp = eval_model(), eval_model()
    spatial.convert_spatial(sp, grid)
    local = spatial.shard_batch_spatial({"image": eval_image}, grid)["image"]
    with torch.no_grad():
        out["fwd"] = flat(sp(local))
        out["fwd_ref"] = [rows(t, grid, len(eval_image))
                          for t in flat(ref(eval_image))]
        # The control's shards are 64 rows, so that the unconverted model
        # runs on them: at 64 px a shard's deepest level has no row left.
        tall = torch.from_numpy(data["tall_image"][..., :64 * grid.n_space,
                                                   :])
        out["control"] = flat(ref(spatial.shard_batch_spatial(
            {"image": tall}, grid)["image"]))
        out["control_ref"] = [rows(t, grid, len(tall))
                              for t in flat(ref(tall))]
    out["bad_height"] = message(lambda: sp(local[:, :, :15]))
    # The dp x sp train step.
    st = train_state(grid)
    outs = {}
    st.model.register_forward_hook(
        lambda m, a, o: outs.__setitem__("train", flat(o)))
    step = T.make_train_step(**LOSS, grid=grid)
    metrics = step(st, spatial.shard_batch_spatial(batch, grid))
    out["metrics"] = {k: v.item() for k, v in metrics.items()}
    out["train_outs"] = outs["train"]
    vec = torch.cat([p.grad.reshape(-1) for p in st.model.parameters()]
                    + [p.reshape(-1) for p in st.model.parameters()]
                    + [b.float().reshape(-1) for b in st.model.buffers()]
                    + [p.grad.reshape(-1) for p in st.lamdas.values()])
    out["rank_spread"] = same_on_every_rank(vec.detach(), grid)
    if dist.get_process_group_ranks(grid.world)[0] == rank:
        out["state"] = {
            **{f"grad/{k}": p.grad.clone()
               for k, p in st.model.named_parameters()},
            **{f"param/{k}": p.detach().clone()
               for k, p in st.model.named_parameters()},
            **{f"buffer/{k}": b.clone()
               for k, b in st.model.named_buffers()},
            **{f"lamda/{k}": p.detach().clone()
               for k, p in st.lamdas.items()},
            **{f"lamda_grad/{k}": p.grad.clone()
               for k, p in st.lamdas.items()}}
    del st
    # Serving.
    res = predictor(mesh=grid).predict_batch(images)
    out["serve"] = [{k: r[k] for k in ("keypoints", "parsing",
                                       "parsing_crop")} for r in res]
    ms = multi_scale_inference(make_parsing_apply_fn(eval_model()), ms_image,
                               num_classes=SMALL["num_classes"],
                               crop_size=(64, 64), scales=(0.5, 1.0),
                               mesh=grid)
    out["ms_err"] = ((ms - ms_ref).abs().max().item(),
                     ms_ref.abs().max().item())
    # Each op alone.
    out["ops"] = {}
    for i, (name, stride) in enumerate(OPS):
        for height in (16, 12):
            out["ops"][(name, stride, height)] = op_case(
                grid, name, stride, height, 100 + i)
    return out


pairs = [mesh.make_grid(1, 2, ranks=[0, 1]), mesh.make_grid(1, 2,
                                                             ranks=[2, 3])]
grids = {"1x2": pairs[0] or pairs[1], "1x4": mesh.make_grid(1, 4),
         "2x2": mesh.make_grid(2, 2)}
ms_ref = multi_scale_inference(make_parsing_apply_fn(eval_model()), ms_image,
                               num_classes=SMALL["num_classes"],
                               crop_size=(64, 64), scales=(0.5, 1.0))
result = {name: run_grid(g, ms_ref) for name, g in grids.items()}
result["grid_message"] = message(lambda: mesh.make_grid(3, 1))
result["crop_message"] = message(
    lambda: Predictor(eval_model(), crop_size=(64, 72), mesh=grids["1x4"]))
if rank == 0:  # the unsharded port's fused logits: the label margins
    one = Predictor(eval_model(), crop_size=(64, 64), flip_test=False)
    pre = [jax_preprocess(im) for im in images]
    logits = one.fuse(torch.from_numpy(np.stack([p[0] for p in pre])),
                      torch.from_numpy(np.stack([p[1] for p in pre]))[None])[0]
    top2 = np.sort(logits.numpy(), axis=1)[:, -2:]
    result["margin"] = top2[:, 1] - top2[:, 0]
torch.save(result, os.path.join(OUT, f"rank{rank}.pt"))
dist.destroy_process_group()
print(f"WORKER_OK rank={rank}")
'''


def _launch(out: Path) -> list:
    port = str(_free_port())
    workers = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(out)], cwd=ROOT,
        env=_env(RANK=str(r), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(r),
                 MASTER_ADDR="localhost", MASTER_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    cli = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "-m", "npp_tpu_torch.tools.test_lip",
         "--synthetic", "--tiny", "--device", "cpu", "--dtype", "float32",
         "--limit", "1", "--mesh"], cwd=ROOT, env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return workers + [cli]


def _serve_images() -> list:
    rng = np.random.default_rng(21)
    ims = []
    for h, w in SERVE_SIZES:
        im = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        yy, xx = np.mgrid[:h, :w]  # a bright blob: some structure
        blob = np.exp(-((yy - h / 2) ** 2 + (xx - w / 3) ** 2) / (h * w / 8))
        ims.append(np.clip(im * 0.4 + 150 * blob[..., None], 0,
                           255).astype(np.uint8))
    return ims


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks and the torchrun test_lip (started first), and the
    two JAX programs beside them."""
    out = tmp_path_factory.mktemp("spatial")
    jm = JNPPNet(dtype=jnp.float32, **SMALL)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    v = random_variables(shapes, seed=0)
    _write_npz(out / "weights.npz",
               {"params": {"model": v["params"], "criterion": LAMDAS},
                "batch_stats": v["batch_stats"]})
    host = _host_batch(3)
    rng = np.random.default_rng(4)
    np.savez(out / "data.npz", **{k: host[k] for k in KEYS},
             eval_image=rng.standard_normal((2, 3, SIZE, SIZE)).astype(
                 np.float32),
             ms_image=rng.standard_normal((1, 3, 70, 90)).astype(np.float32),
             tall_image=rng.standard_normal((2, 3, 256, SIZE)).astype(
                 np.float32))
    ims = _serve_images()
    jp = JPredictor(jm, v, crop_size=(SIZE, SIZE), pose_scales=POSE_SCALES,
                    flip_test=False)
    serve = {"n": len(ims)}
    for i, im in enumerate(ims):
        serve[f"im{i}"] = im
        for j, sm in enumerate(POSE_SCALES):
            canvas, cp, scale = jp.preprocess(im, scale_mult=sm)
            serve.update({f"canvas{i}_{j}": canvas, f"cp{i}_{j}": cp,
                          f"scale{i}_{j}": scale})
    np.savez(out / "serve.npz", **serve)
    np.savez(out / "config.npz", small=SMALL, ohem_keep=OHEM_KEEP,
             opt=dict(base_lr=LR, lr_step=(2,), lr_factor=0.2,
                      steps_per_epoch=1),
             pose_scales=np.asarray(POSE_SCALES))
    procs = _launch(out)
    fast = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        params = {"model": v["params"],
                  "criterion": {k: jnp.asarray(a) for k, a in LAMDAS.items()}}

        def program(p, batch):
            def loss_fn(p):
                return jtrain.compute_losses(
                    jm, p, v["batch_stats"], batch, train=True,
                    class_weights=jcrit.LIP_CLASS_WEIGHTS,
                    ohem_keep=OHEM_KEEP)

            (_, (stats, metrics, outs)), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(p)
            return dict(metrics=metrics, grads=grads, stats=stats,
                        outs=[t for stage in outs for pair in stage
                              for t in pair])

        # XLA compiles without the GIL: the train program compiles on a
        # thread while the Predictor's program is traced and compiled.
        jbatch = _jax_batch(host)
        lowered = jax.jit(program).lower(params, jbatch)
        compiled = []
        thread = threading.Thread(
            target=lambda: compiled.append(lowered.compile()))
        thread.start()
        jax_serve = jp.predict_batch(ims)
        thread.join()
        jax_ref = jax.device_get(compiled[0](params, jbatch))
        one_cli = test_lip.main(["--synthetic", "--tiny", "--device", "cpu",
                                 "--dtype", "float32", "--limit", "1"])
    finally:
        jax.config.update("jax_disable_most_optimizations", fast)
        results = _wait(procs)
    for rc, log in results:
        assert rc == 0, log[-4000:]
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    jax_ref["params"] = _adam_step(v, jax_ref["grads"])
    return dict(jax=jax_ref, serve=jax_serve, ranks=ranks, ims=ims,
                preprocess=jp.preprocess, one_cli=one_cli,
                cli_log=results[-1][1])


def _adam_step(variables, grads) -> dict:
    """The weights after Adam's first step from npp_tpu's weights and
    gradients, by the port's optimizer (groups, learning rates and
    schedule; ``tests/test_torch_train.py`` holds it to optax fed the
    same gradients): state_dict keys and lambda names to numpy arrays."""
    state = ttrain.init_train_state(
        generator=torch.Generator().manual_seed(0), device="cpu",
        base_lr=LR, lr_step=(2,), lr_factor=0.2, steps_per_epoch=1,
        dtype=torch.float32, **SMALL)
    convert.load_jax_variables(
        state.model, {"params": {"model": variables["params"],
                                 "criterion": LAMDAS},
                      "batch_stats": variables["batch_stats"]}, state.lamdas)
    model_grads = _jax_model(grads["model"], "params")
    for k, p in state.model.named_parameters():
        p.grad = torch.from_numpy(np.ascontiguousarray(model_grads[k]))
    for k, p in state.lamdas.items():
        p.grad = torch.from_numpy(np.asarray(grads["criterion"][k]))
    state.apply_update()
    return {"model": {k: p.detach().numpy()
                      for k, p in state.model.named_parameters()},
            "criterion": {k: p.detach().numpy()
                          for k, p in state.lamdas.items()}}


def _grid_ranks(runs, grid):
    """The ranks of grid ``grid`` (for 1x2: the grid of ranks 0 and 1)."""
    ranks = runs["ranks"][:2] if grid == "1x2" else runs["ranks"]
    return [r[grid] for r in ranks]


def _rows(ref, d, s, n_data, n_space, nhwc=True):
    """Data shard d, rows s of a whole (B, H, W, C) (or NCHW) map."""
    b = ref.shape[0] // n_data
    ref = ref[d * b:(d + 1) * b]
    dim = 1 if nhwc else 2
    h = ref.shape[dim] // n_space
    return np.take(ref, range(s * h, (s + 1) * h), axis=dim)


def _shape(grid):
    return tuple(int(n) for n in grid.split("x"))


# -- the ops ----------------------------------------------------------------

OP_CASES = [(g, key) for g in GRIDS for key in (
    [("stem", 2, h) for h in (16, 12)]
    + [(n, s, h) for n in ("avg_pool_3x3", "max_pool_3x3", "std_conv_3x3",
                           "dil_conv_3x3_2", "dil_conv_3x3_4",
                           "dil_conv_5x5_4", "se_connect", "conv_7x1_1x7",
                           "sep_conv_3x3", "sep_conv_5x5", "poled_conv_x1",
                           "poled_conv_x2")
       for s in (1, 2) for h in (16, 12)]
    + [(n, s, h) for n, s in (("std_conv_1x1", 1), ("skip_connect", 2),
                              ("none", 2), ("inter_x2", 1),
                              ("inter_x0.5", 1), ("inter_x0.25", 1))
       for h in (16, 12)])]


@pytest.mark.parametrize("grid,key", OP_CASES,
                         ids=[f"{g}-{k[0]}-s{k[1]}-h{k[2]}"
                              for g, k in OP_CASES])
def test_op_on_rows_matches_itself_unsharded(runs, grid, key):
    """One op on every rank's rows (both image edges included) against
    the op unsharded, in eval mode and in train mode (cross-rank BN), with
    its input gradient and its weight gradients summed over the ranks;
    OP_REL x max|ref| each."""
    for r in _grid_ranks(runs, grid):
        for what, (err, scale) in r["ops"][key].items():
            assert err <= OP_REL * max(scale, 1.0), (what, err, scale)


# -- the forward ------------------------------------------------------------

@pytest.mark.parametrize("grid", GRIDS)
def test_sharded_forward_matches_unsharded(runs, grid):
    """Every rank's rows of all 8 outputs (eval mode) within npp_tpu's
    1e-4 abs of the port's unsharded forward."""
    for r in _grid_ranks(runs, grid):
        assert len(r["fwd"]) == 8
        for got, want in zip(r["fwd"], r["fwd_ref"]):
            assert got.shape == want.shape
            assert (got - want).abs().max().item() <= FWD_ATOL


@pytest.mark.parametrize("grid", GRIDS)
def test_shards_without_halo_miss_the_bound(runs, grid):
    """The negative control: shards through the unconverted model (each
    rank pads its own edges, no exchange) miss the bound. Its image is
    64 rows a rank, so that the plain model runs on a shard."""
    worst = max(max((got - want).abs().max().item()
                    for got, want in zip(r["control"], r["control_ref"]))
                for r in _grid_ranks(runs, grid))
    assert worst > 10 * FWD_ATOL, worst


@pytest.mark.parametrize("grid", GRIDS)
def test_height_that_does_not_divide_raises(runs, grid):
    n_space = _shape(grid)[1]
    for r in _grid_ranks(runs, grid):
        with pytest.raises(ValueError) as e:
            jspatial.check_divisibility(1, 15 * n_space, 1, n_space)
        assert r["bad_height"] == str(e.value)


# -- the train step ---------------------------------------------------------

def _state(runs, grid):
    return next(r["state"] for r in _grid_ranks(runs, grid) if "state" in r)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("key", ["loss", "loss_pose", "loss_par"])
def test_dp_sp_losses_match_jax_at_the_global_batch(runs, grid, key):
    """The mean of the ranks' losses is npp_tpu's one-device loss."""
    got = np.mean([r["metrics"][key] for r in _grid_ranks(runs, grid)])
    np.testing.assert_allclose(got, float(runs["jax"]["metrics"][key]),
                               rtol=1e-5)


@pytest.mark.parametrize("grid", GRIDS)
def test_dp_sp_train_outputs_match_jax(runs, grid):
    """Every rank's rows of the train-mode outputs, 1e-4 x max|ref|."""
    n_data, n_space = _shape(grid)
    for r in _grid_ranks(runs, grid):
        for got, ref in zip(r["train_outs"], runs["jax"]["outs"]):
            ref = _rows(np.asarray(ref), r["d"], r["s"], n_data, n_space)
            got = got.permute(0, 2, 3, 1).numpy()
            assert got.shape == ref.shape
            scale = max(float(np.abs(ref).max()), 1e-12)
            assert float(np.abs(got - ref).max()) <= OUT_REL * scale


@pytest.mark.parametrize("grid", GRIDS)
def test_dp_sp_state_is_the_same_on_every_rank(runs, grid):
    """Gradients, weights, running stats and lambda gradients agree
    across the grid's ranks after the step (DDP over the grid)."""
    for r in _grid_ranks(runs, grid):
        assert r["rank_spread"] == 0.0


@pytest.mark.parametrize("grid", GRIDS)
def test_dp_sp_gradients_match_jax(runs, grid):
    """DDP's averaged gradients against npp_tpu's at the global batch
    (``tests/test_torch_train.py``'s rule)."""
    grads = {k[5:]: v.numpy() for k, v in _state(runs, grid).items()
             if k.startswith("grad/")}
    worst, key, norm = _grad_errors(
        grads, _jax_model(runs["jax"]["grads"]["model"], "params"))
    assert worst <= 1.0 and norm <= GRAD_TOL_NORM, (worst, key, norm)


@pytest.mark.parametrize("grid", GRIDS)
def test_dp_sp_running_stats_match_jax(runs, grid):
    """Every BN's running mean and var, the levels held whole at 1x4
    included (their unbiased factor counts each value once)."""
    ref = _jax_model(runs["jax"]["stats"], "batch_stats")
    state = _state(runs, grid)
    for k, want in ref.items():
        got = state[f"buffer/{k}"].numpy()
        scale = max(float(np.abs(want).max()), 1e-12)
        assert float(np.abs(got - want).max()) <= OUT_REL * scale, k
    assert len(ref) > 100


@pytest.mark.parametrize("grid", GRIDS)
def test_dp_sp_lamdas_and_adam_step_match_jax(runs, grid):
    state = _state(runs, grid)
    jgrads, jparams = runs["jax"]["grads"], runs["jax"]["params"]
    for k in LAMDAS:
        np.testing.assert_allclose(state[f"lamda_grad/{k}"].numpy(),
                                   np.asarray(jgrads["criterion"][k]),
                                   rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(state[f"lamda/{k}"].numpy(),
                                   np.asarray(jparams["criterion"][k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    ref = jparams["model"]
    gref = _jax_model(jgrads["model"], "params")
    for k in ref:
        _adam_close(state[f"param/{k}"].numpy(), ref[k],
                    state[f"grad/{k}"].numpy(), gref[k], k)


# -- serving ----------------------------------------------------------------

@pytest.mark.parametrize("grid", GRIDS)
def test_mesh_predictor_matches_jax(runs, grid):
    """``Predictor(mesh=)`` with pose scales over 5 images (padded to 8)
    on npp_tpu's canvases: every rank returns npp_tpu's whole list, with
    ``tests/test_torch_serve.py``'s keypoint and label rules."""
    margin = runs["ranks"][0]["margin"]
    for r in _grid_ranks(runs, grid):
        assert len(r["serve"]) == len(runs["serve"]) == len(SERVE_SIZES)
        for i, (o, ref) in enumerate(zip(r["serve"], runs["serve"])):
            scale = runs["preprocess"](runs["ims"][i])[2]
            np.testing.assert_allclose(o["keypoints"][:, :2] * scale,
                                       ref["keypoints"][:, :2] * scale,
                                       atol=KP_ATOL, rtol=0)
            np.testing.assert_allclose(o["keypoints"][:, 2],
                                       ref["keypoints"][:, 2], rtol=1e-5,
                                       atol=1e-6)
            diff = o["parsing_crop"] != ref["parsing_crop"]
            assert (margin[i][diff] < MARGIN).all()
            assert o["parsing"].shape == runs["ims"][i].shape[:2]


@pytest.mark.parametrize("grid", GRIDS)
def test_mesh_multi_scale_matches_unsharded(runs, grid):
    for r in _grid_ranks(runs, grid):
        err, scale = r["ms_err"]
        assert err <= MS_REL * scale, (err, scale)


def test_test_lip_mesh_under_torchrun_matches_one_process(runs):
    """``test_lip --mesh`` on two ranks prints the one-process metrics."""
    m = runs["one_cli"]
    want = (f"pixel_acc {m['pixel_acc']:.4f} mean_acc {m['mean_acc']:.4f} "
            f"mIoU {m['mean_iou']:.4f} fwIoU {m['fw_iou']:.4f}")
    assert want in runs["cli_log"], runs["cli_log"][-2000:]
    assert runs["cli_log"].count("pixel_acc") == 1  # rank 0 prints


@pytest.mark.parametrize("d,s", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_loader_hands_each_rank_its_shard_rows(d, s):
    """``DataLoader(grid=)``: data shard d of the epoch (the strided shard
    of ``process_index=d``), rendered at full height, and rows block s of
    its images, labels, edges and heatmaps; per-sample entries whole."""
    ds = SyntheticDataset(length=8, crop_size=(SIZE, SIZE), seed=2,
                          device_normalize=True)
    render = tloader.make_target_renderer(normalize_images=True)
    grid = tmesh.Grid(2, 2, d, s, None, None, None)
    mine = tloader.DataLoader(ds, 2, device="cpu", num_workers=1,
                              renderer=render, grid=grid)
    whole = tloader.DataLoader(ds, 2, device="cpu", num_workers=1,
                               renderer=render, process_index=d,
                               process_count=2)
    assert len(mine) == len(whole) == 2
    for got, want in zip(mine, whole):
        assert got["names"] == want["names"]
        for k, v in want.items():
            if k in tspatial.ROW_DIMS:
                h = v.shape[tspatial.ROW_DIMS[k]] // 2
                v = v.narrow(tspatial.ROW_DIMS[k], s * h, h)
            if torch.is_tensor(v):
                assert torch.equal(got[k], v), k


# -- messages ---------------------------------------------------------------

@pytest.mark.parametrize("args", [(8, 64, 4, 2), (7, 64, 4, 2),
                                  (8, 60, 4, 8), (8, 64, 1, 32),
                                  (2, 384, 1, 8)])
def test_check_divisibility_matches_jax(args):
    def msg(fn):
        try:
            fn(*args)
        except ValueError as e:
            return str(e)
        return ""
    assert msg(tspatial.check_divisibility) == msg(
        jspatial.check_divisibility)


def test_grid_messages_match_jax(runs):
    """A grid that is not the world's size raises npp_tpu's mesh message;
    a crop height the space axis does not divide raises npp_tpu's
    Predictor message; without a process group there is no grid."""
    with pytest.raises(ValueError) as e:
        jspatial.make_mesh_2d(3, 1, devices=list(range(WORLD)))
    assert runs["ranks"][0]["grid_message"] == str(e.value)
    assert runs["ranks"][0]["crop_message"] == (
        "crop height 72 (and 72//4) must divide space=4 for spatial serving")
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_grid(1, 1)
