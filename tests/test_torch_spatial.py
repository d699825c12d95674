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
- ``check_divisibility``'s and the grid's messages against npp_tpu's;
- npp_tpu's serving layouts on the 1x2 and 2x2 grids (``run_layouts``):
  ``Predictor(mesh=, quantize="int8")`` with dynamic scales and after
  ``calibrate_int8``, the fused necks and sibling cells, and both (the
  ``predict`` CLI's default with ``--int8``), against npp_tpu's unsharded
  Predictor of the same layout (its dynamic scale is the max over its
  one program's global activation, which the grid's MAX all-reduce
  gives), on ``tests/test_torch_int8.py``'s images and serving settings:
  the int8 layouts at that file's bounds, the fused one at the fp bounds
  above. Those bounds are defined on that file's data: an fp32 rounding
  difference that crosses a midpoint of the int8 grid moves a value one
  quantum, and on the serve images here, with pose scales, the flips
  spread far enough that the port's unsharded int8 Predictor itself
  agrees with npp_tpu's on 0.974 of the labels only. The grid's dynamic
  scale at the int8 conv calls of the stems (which the grid computes bit
  for bit as one device does) equals the unsharded forward's bit for
  bit, where each rank's own max (the control) does not; the grid
  quantize of one activation bit for bit against the one-device dynamic
  quantize of the gathered tensor, with the elements that the per-rank
  quantize puts one quantum or more apart counted; the calibrated
  scales equal on every rank and to npp_tpu's; one MAX all-reduce per
  dynamic int8 conv call and none once calibrated;
- the dynamic int8 Predictor on a 2x1 data grid (``run_data_grid``)
  against the port's unsharded one: every call's scale and the
  predictions to the fp bounds, where each rank's own max (the control)
  misses both.

The four ranks (``WORKER``) import torch only; they start first and run
beside the module's JAX programs (npp_tpu's value-and-gradient and its
pose-scales Predictor; in two processes of their own, ``LAYOUT_REFS``,
its int8 and calibrated int8, and its fused and fused int8 Predictors),
which are compiled with most XLA optimisations off to keep the file
short.
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
from npp_tpu_torch.models.augment import build_nppnet  # noqa: E402
from npp_tpu_torch.ops import quantize as tq  # noqa: E402
from npp_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from npp_tpu_torch.parallel import spatial as tspatial  # noqa: E402
from npp_tpu_torch.tools import test_lip  # noqa: E402
from npp_tpu_torch.utils import convert  # noqa: E402

from test_torch_int8 import _images  # noqa: E402
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
# The serving layouts: tests/test_torch_int8.py's bounds for int8.
LAYOUT_GRIDS = ("1x2", "2x2")
LAYOUTS = {"int8_dynamic": dict(quantize="int8"),
           "int8_calibrated": dict(quantize="int8"),
           "fused": dict(fuse_necks=True, fuse_cells=True),
           "fused_int8": dict(fuse_necks=True, fuse_cells=True,
                              quantize="int8")}
CAL_BATCH = 4        # calibrate_int8's batch: one of the 4 images
SCALE_RTOL = 1e-6    # a scale against npp_tpu's
MODEL_SCALE_RTOL = 2e-2  # calibrated scales past the stems (int8 flips)
INT8_MAP_RTOL = 0.05     # the top-2 gap of a unique peak, x its value
INT8_LABEL_SHARE = 0.98
INT8_KP_ATOL = 1.0       # crop px

WORKER = r'''
import os, sys
import numpy as np
import torch
import torch.distributed as dist

from npp_tpu_torch.core import train as T
from npp_tpu_torch.core.criterion import LIP_CLASS_WEIGHTS
from npp_tpu_torch.core.inference import gaussian_blur
from npp_tpu_torch.core.multiscale import multi_scale_inference
from npp_tpu_torch.core.predictor import Predictor
from npp_tpu_torch.core.test_seg import make_parsing_apply_fn
from npp_tpu_torch.data import loader as L
from npp_tpu_torch.models.augment import _Stem, build_nppnet, init_weights
from npp_tpu_torch.models.cells import InterOp
from npp_tpu_torch.ops import quantize as tq
from npp_tpu_torch.ops.primitives import make_op
from npp_tpu_torch.parallel import mesh, spatial
from npp_tpu_torch.utils import convert

torch.set_num_threads(1)
OUT = sys.argv[1]
CFG = dict(np.load(os.path.join(OUT, "config.npz"), allow_pickle=True))
SMALL, OPT = CFG["small"].item(), CFG["opt"].item()
LOSS = dict(class_weights=LIP_CLASS_WEIGHTS, ohem_keep=int(CFG["ohem_keep"]))
POSE_SCALES = tuple(CFG["pose_scales"])
LAYOUTS, CAL_BATCH = CFG["layouts"].item(), int(CFG["cal_batch"])
INT8_MAP_RTOL = float(CFG["int8_map_rtol"])
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


# The layouts' images (tests/test_torch_int8.py's) and npp_tpu's canvases.
lay = np.load(os.path.join(OUT, "layout.npz"))
lay_images = [lay[f"im{i}"] for i in range(int(lay["n"]))]
lay_table = {im.shape: (lay[f"canvas{i}"], lay[f"cp{i}"],
                        float(lay[f"scale{i}"]))
             for i, im in enumerate(lay_images)}
assert len(lay_table) == len(lay_images)


def eval_model():
    m = build_nppnet(device="cpu", generator=torch.Generator().manual_seed(0),
                     dtype=torch.float32, **SMALL)
    return convert.load_jax_variables(m, variables)


def predictor(**kw):
    p = Predictor(eval_model(), crop_size=(64, 64), pose_scales=POSE_SCALES,
                  flip_test=False, **kw)
    p.preprocess = jax_preprocess
    return p


def layout_predictor(**kw):
    """A layout's Predictor with tests/test_torch_int8.py's serving
    settings (the flip on, the base scale) on npp_tpu's canvases."""
    p = Predictor(eval_model(), crop_size=(64, 64), **kw)
    p.preprocess = lambda im, scale_mult=1.0: lay_table[im.shape]
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


# -- npp_tpu's serving layouts ----------------------------------------------

def counted(pred, ims=None, **kw):
    """One predict batch of ``ims`` (the layout images; ``kw`` to
    ``predict_batch``): (the scale of every int8 conv call, in call
    order; the MAX all-reduces; the calls that fold the ReLU into their
    quantize; the predictions)."""
    seen, folded, orig = [], [0], tq.quantize_act

    def quantize(x, act_scale=None, relu=False):
        q, scale = orig(x, act_scale, relu=relu)
        seen.append(scale.item())
        folded[0] += int(relu)
        return q, scale

    tq.quantize_act, before = quantize, mesh.all_max.calls
    try:
        res = serve_rows(pred.predict_batch(
            lay_images if ims is None else ims, **kw))
    finally:
        tq.quantize_act = orig
    return seen, mesh.all_max.calls - before, folded[0], res


def serve_rows(res):
    return [{k: r[k] for k in ("keypoints", "parsing", "parsing_crop")}
            for r in res]


def unique_peaks(pred):
    """(B, J): the blurred fused heatmap's peak is unique by
    INT8_MAP_RTOL of its value (tests/test_torch_int8.py's rule), for the
    unsharded ``pred`` on npp_tpu's canvases."""
    pre = [lay_table[im.shape] for im in lay_images]
    _, hm = pred.fuse(torch.from_numpy(np.stack([p[0] for p in pre])),
                      torch.from_numpy(np.stack([p[1] for p in pre]))[None])
    top = gaussian_blur(hm, pred.blur_sigma).flatten(2).topk(2, dim=2).values
    return ((top[..., 0] - top[..., 1]) > INT8_MAP_RTOL
            * top[..., 0].abs()).numpy()


def grid_quantize_case(grid):
    """``grid_quantize`` of this rank's shard of one activation against
    the one-device dynamic quantize of the whole (bit for bit), and the
    per-rank quantize's int8 values one quantum and more apart from it,
    with and without the ReLU, in float32 and bfloat16. The sample
    brightness and a spike put the max on one rank of the grid."""
    g = torch.Generator().manual_seed(17)
    whole = torch.randn(4, 8, 16, 12, generator=g) * torch.tensor(
        [0.5, 1.0, 2.0, 3.0]).reshape(4, 1, 1, 1)
    whole[3, 2, 13, 5] = 11.0
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for relu in (False, True):
            x = rows(whole.to(dtype), grid, 4)
            q, scale = tq.grid_quantize(x, grid.world, relu=relu)
            q_all, scale_all = tq.quantize_act(whole.to(dtype), relu=relu)
            want = rows(q_all, grid, 4)
            q_own, _ = tq.quantize_act(x, relu=relu)
            apart = (q_own.int() - want.int()).abs()
            out[(str(dtype), relu)] = dict(
                equal=torch.equal(q, want) and torch.equal(scale,
                                                           scale_all),
                one=int((apart == 1).sum()), more=int((apart > 1).sum()),
                n=apart.numel())
    return out


def per_rank_scales(pred):
    """Each rank quantizes with its own max from now on (the control)."""
    for m in pred.model.modules():
        if isinstance(m, tq.Int8Conv2d):
            m.scale_group = None


def data_images():
    """Four 64x64 images of four brightnesses, served as a batch of 4 (no
    pad rows): each data shard holds two and the first shard the grid's
    max. (The layout images pad to 8 with copies of the last, so there
    the second shard holds no image of its own.)"""
    rng = np.random.default_rng(12)
    return [(rng.integers(0, 256, (64, 64, 3)) * f).astype(np.uint8)
            for f in (1.0, 0.8, 0.5, 0.3)]


def run_data_grid(grid):
    """The dynamic int8 Predictor on a data-only grid: ``counted`` of the
    data images with the grid's scales, then with each rank's own (the
    control); and on its last rank the unsharded one's."""
    ims, kw = data_images(), dict(crop_size=(64, 64), quantize="int8")
    pred = Predictor(eval_model(), mesh=grid, **kw)
    out = {"grid": counted(pred, ims, pad_to_multiple=4)}
    per_rank_scales(pred)
    out["own"] = counted(pred, ims, pad_to_multiple=4)
    if grid.d == grid.n_data - 1:
        out["one"] = counted(Predictor(eval_model(), **kw), ims,
                             pad_to_multiple=4)
    return out


def run_layouts(grid, names=tuple(LAYOUTS)):
    """The layouts ``names`` on ``grid``: each one's predictions; for the
    int8 ones, the scale of every int8 conv call and the MAX all-reduces
    of a predict batch once the plan is traced (the flip on: two
    forwards); the calibrated scales; with the dynamic one, the grid
    quantize case and its call scales again with each rank's own max
    (the control)."""
    out = {}
    if "int8_dynamic" in names:
        out["quantize"] = grid_quantize_case(grid)
    for name in names:
        kw = LAYOUTS[name]
        pred = layout_predictor(mesh=grid, **kw)
        if name == "int8_calibrated":  # its calibration traces the plan
            pred.calibrate_int8(lay_images, batch_size=CAL_BATCH)
            out["scales"] = {n: m.act_scale.item()
                             for n, m in pred.model.named_modules()
                             if isinstance(m, tq.Int8Conv2d)}
        else:  # the first batch traces the plan
            out[name] = serve_rows(pred.predict_batch(lay_images))
        if "quantize" in kw:
            out[name + "_counts"] = counted(pred)
            out.setdefault(name, out[name + "_counts"][3])
        if name == "int8_dynamic":
            per_rank_scales(pred)
            out["own_call_scales"] = counted(pred)[0]
    return out


pairs = [mesh.make_grid(1, 2, ranks=[0, 1]), mesh.make_grid(1, 2,
                                                             ranks=[2, 3])]
data_pair = mesh.make_grid(2, 1, ranks=[2, 3])
grids = {"1x2": pairs[0] or pairs[1], "1x4": mesh.make_grid(1, 4),
         "2x2": mesh.make_grid(2, 2)}
ms_ref = multi_scale_inference(make_parsing_apply_fn(eval_model()), ms_image,
                               num_classes=SMALL["num_classes"],
                               crop_size=(64, 64), scales=(0.5, 1.0))
result = {name: run_grid(g, ms_ref) for name, g in grids.items()}
# The 1x2 layouts on both pairs side by side; ranks 2 and 3 then serve the
# 2x1 data grid.
if pairs[0] is not None:
    result["1x2"]["layouts"] = run_layouts(
        pairs[0], ("int8_dynamic", "int8_calibrated"))
else:
    result["1x2"]["layouts"] = run_layouts(pairs[1], ("fused", "fused_int8"))
    result["2x1"] = run_data_grid(data_pair)
result["2x2"]["layouts"] = run_layouts(grids["2x2"])
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
    # The unsharded int8 layouts: their unique peaks, the dynamic one's
    # call scales, and how many int8 convs the stems hold.
    result["unique"], one = {}, {}
    for name, kw in LAYOUTS.items():
        if "quantize" in kw:
            one[name] = layout_predictor(**kw)
            if name == "int8_calibrated":
                one[name].calibrate_int8(lay_images, batch_size=CAL_BATCH)
            result["unique"][name] = unique_peaks(one[name])
    (result["one_call_scales"], _, result["one_folded"],
     result["one_rows"]) = counted(one["int8_dynamic"])
    result["stem_convs"] = sum(
        1 for n, m in one["int8_dynamic"].model.named_modules()
        if n.startswith("stem") and isinstance(m, tq.Int8Conv2d))
torch.save(result, os.path.join(OUT, f"rank{rank}.pt"))
dist.destroy_process_group()
print(f"WORKER_OK rank={rank}")
'''


def jax_layouts(jm, v, names) -> dict:
    """npp_tpu's Predictor in each of the serving layouts ``names`` on the
    layout images; the calibrated layout continues the dynamic one's
    Predictor (and adds its scale tree, ``scales``)."""
    ims, out = _images(11), {}
    for name in names:
        if name == "int8_calibrated":
            p.calibrate_int8(ims, batch_size=CAL_BATCH)
            out["scales"] = jax.tree.map(np.asarray,
                                         p.variables["act_scales"])
        else:
            p = JPredictor(jm, v, crop_size=(SIZE, SIZE), **LAYOUTS[name])
        out[name] = p.predict_batch(ims)
    return out


# npp_tpu switches its convs to int8 by a global flag at trace time, so no
# other program may be traced beside an int8 one: its Predictors run in
# two processes of their own (the unfused and the fused layouts, argv[2])
# beside the ranks and the module's JAX programs.
LAYOUT_REFS = r'''
import sys
sys.path.insert(0, "tests")
import jax, jax.numpy as jnp, torch
from npp_tpu.models.augment import NPPNet
from test_torch_ops import random_variables
from test_torch_spatial import SIZE, SMALL, jax_layouts

jax.config.update("jax_disable_most_optimizations", True)
jm = NPPNet(dtype=jnp.float32, **SMALL)
v = random_variables(jax.eval_shape(lambda: jm.init(
    jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False)),
    seed=0)
names = sys.argv[2].split(",")
torch.save(jax_layouts(jm, v, names), f"{sys.argv[1]}/layouts_{names[0]}.pt")
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
    lims = _images(11)  # tests/test_torch_int8.py's, and its settings
    lay = {"n": len(lims)}
    for i, im in enumerate(lims):
        canvas, cp, scale = jp.preprocess(im)
        lay.update({f"im{i}": im, f"canvas{i}": canvas, f"cp{i}": cp,
                    f"scale{i}": scale})
    np.savez(out / "layout.npz", **lay)
    np.savez(out / "config.npz", small=SMALL, ohem_keep=OHEM_KEEP,
             opt=dict(base_lr=LR, lr_step=(2,), lr_factor=0.2,
                      steps_per_epoch=1),
             pose_scales=np.asarray(POSE_SCALES), layouts=LAYOUTS,
             cal_batch=CAL_BATCH, int8_map_rtol=INT8_MAP_RTOL)
    procs = _launch(out)
    refs = [subprocess.Popen(
        [sys.executable, "-c", LAYOUT_REFS, str(out), names], cwd=ROOT,
        env=_env(JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for names in ("int8_dynamic,int8_calibrated", "fused,fused_int8")]
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
        results = _wait(procs, timeout=600)
        ref_results = _wait(refs, timeout=600)
    for rc, log in results + ref_results:
        assert rc == 0, log[-4000:]
    layouts = {}
    for name in ("int8_dynamic", "fused"):
        layouts.update(torch.load(out / f"layouts_{name}.pt",
                                  weights_only=False))
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    jax_ref["params"] = _adam_step(v, jax_ref["grads"])
    assert len(layouts) == len(LAYOUTS) + 1, sorted(layouts)
    return dict(jax=jax_ref, serve=jax_serve, ranks=ranks, ims=ims,
                preprocess=jp.preprocess, one_cli=one_cli,
                cli_log=results[-1][1], layouts=layouts, layout_ims=lims,
                variables=v)


def _port_model(runs):
    """The port's unsharded model with the module's weights."""
    m = build_nppnet(device="cpu", generator=torch.Generator().manual_seed(0),
                     dtype=torch.float32, **SMALL)
    return convert.load_jax_variables(m, runs["variables"])


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


# -- npp_tpu's serving layouts on the grid ----------------------------------

def _layouts(runs, grid):
    """Each rank's layouts on ``grid`` (on 1x2, ranks 0 and 1 serve the
    unfused int8 layouts and ranks 2 and 3, rows alike, the fused ones)."""
    if grid == "1x2":
        return [{**a["1x2"]["layouts"], **b["1x2"]["layouts"]}
                for a, b in zip(runs["ranks"][:2], runs["ranks"][2:])]
    return [r["layouts"] for r in _grid_ranks(runs, grid)]


LAYOUT_CASES = [(g, name) for g in LAYOUT_GRIDS for name in LAYOUTS]


@pytest.mark.parametrize("grid,layout", LAYOUT_CASES,
                         ids=[f"{g}-{n}" for g, n in LAYOUT_CASES])
def test_mesh_serving_layout_matches_jax(runs, grid, layout):
    """``Predictor(mesh=)`` in each layout against npp_tpu's unsharded
    Predictor of that layout on npp_tpu's canvases of
    ``tests/test_torch_int8.py``'s images, every rank returning the whole
    list: the fused fp layout's keypoints to KP_ATOL crop px and scores to
    1e-5; the int8 ones at ``tests/test_torch_int8.py``'s bounds (labels
    on INT8_LABEL_SHARE of the pixels, keypoints to INT8_KP_ATOL crop px
    where the peak is unique), since an fp32 rounding difference that
    crosses a rounding midpoint of the int8 grid moves a value one
    quantum and propagates."""
    ref = runs["layouts"][layout]
    ims = runs["layout_ims"]
    int8 = "quantize" in LAYOUTS[layout]
    for r in _layouts(runs, grid):
        got = r[layout]
        assert len(got) == len(ref) == len(ims)
        scale = np.array([runs["preprocess"](im)[2] for im in ims])
        kp = np.stack([np.abs(o["keypoints"][:, :2] - w["keypoints"][:, :2])
                       .max(axis=1) for o, w in zip(got, ref)]) \
            * scale[:, None]
        for o, im in zip(got, ims):
            assert o["parsing"].shape == im.shape[:2]
        if not int8:
            share = np.mean([np.mean(o["parsing_crop"] == w["parsing_crop"])
                             for o, w in zip(got, ref)])
            print(f"{grid} {layout}: labels agree on {share:.6f}; "
                  f"keypoints max|diff| {kp.max():.3g} crop px")
            assert kp.max() <= KP_ATOL, kp.max()
            assert share >= 0.999
            for o, w in zip(got, ref):
                np.testing.assert_allclose(o["keypoints"][:, 2],
                                           w["keypoints"][:, 2], rtol=1e-5,
                                           atol=1e-6)
            continue
        unique = runs["ranks"][0]["unique"][layout]
        share = np.mean([np.mean(o["parsing_crop"] == w["parsing_crop"])
                         for o, w in zip(got, ref)])
        print(f"{grid} {layout}: labels agree on {share:.6f}; keypoints "
              f"max|diff| {kp[unique].max():.4g} crop px over the "
              f"{int(unique.sum())} of {unique.size} unique peaks")
        assert share >= INT8_LABEL_SHARE
        assert unique.any() and kp[unique].max() <= INT8_KP_ATOL


def _fp_agreement(got, ref):
    """(crop label share, keypoint max|diff| px, score max|diff|) of
    predictions on 64x64 images (crop px are image px)."""
    share = np.mean([np.mean(o["parsing_crop"] == w["parsing_crop"])
                     for o, w in zip(got, ref)])
    kp = max(np.abs(o["keypoints"][:, :2] - w["keypoints"][:, :2]).max()
             for o, w in zip(got, ref))
    score = max(np.abs(o["keypoints"][:, 2] - w["keypoints"][:, 2]).max()
                for o, w in zip(got, ref))
    return share, kp, score


def test_data_grid_int8_is_one_process_and_the_control_is_not(runs):
    """On the 2x1 data grid (ranks 2 and 3) each rank runs whole images,
    and the grid's max is the whole batch's, so the dynamic int8
    Predictor on the data images takes the unsharded port's scale at
    every int8 conv call (one MAX all-reduce each, the ReLU folded at the
    same calls) up to the last bits that a batch of 2 rounds otherwise
    than one of 4 (SCALE_RTOL), and meets the fp bounds against the
    unsharded port's int8 Predictor: labels on 0.999 of the pixels,
    keypoints to KP_ATOL px, scores to 1e-5. The control, the same shards
    with each rank's own max, misses the scales by more than 1% at some
    call and misses those bounds."""
    ranks = [r["2x1"] for r in runs["ranks"][2:]]
    want_scales, _, want_fold, want = ranks[-1]["one"]
    want_scales = np.array(want_scales)
    own_drifts = []
    for r in ranks:
        scales, maxes, fold, rows = r["grid"]
        own_scales, own_maxes, _, own_rows = r["own"]
        drift = np.abs(np.array(scales) / want_scales - 1).max()
        own_drift = np.abs(np.array(own_scales) / want_scales - 1).max()
        share, kp, score = _fp_agreement(rows, want)
        o_share, o_kp, o_score = _fp_agreement(own_rows, want)
        print(f"2x1 int8_dynamic vs one process: scales apart by at most "
              f"{drift:.3g} relative over {len(scales)} calls, labels "
              f"{share:.6f}, keypoints {kp:.3g} px, scores {score:.3g}; "
              f"per-rank scales: apart by {own_drift:.3g}, labels "
              f"{o_share:.6f}, keypoints {o_kp:.3g} px, scores "
              f"{o_score:.3g}")
        assert len(scales) > 100 and maxes == len(scales) and own_maxes == 0
        assert fold == want_fold
        assert drift <= SCALE_RTOL
        assert share >= 0.999 and kp <= KP_ATOL and score <= 1e-5
        own_drifts.append(own_drift)
        assert not (o_share >= 0.999 and o_kp <= KP_ATOL and o_score <= 1e-5)
    assert max(own_drifts) > 1e-2


@pytest.mark.parametrize("grid", LAYOUT_GRIDS)
def test_grid_quantize_is_the_gathered_dynamic_quantize(runs, grid):
    """``quantize.grid_quantize`` of each rank's shard equals the
    one-device dynamic quantize of the whole activation, int8 values and
    scale bit for bit (plain versions), float32 and bfloat16, with and
    without the ReLU. The control, each rank quantizing with its own max,
    puts int8 values one quantum and more apart on the ranks that do not
    hold the max."""
    cases = [r["quantize"] for r in _layouts(runs, grid)]
    for key in cases[0]:
        for c in cases:
            assert c[key]["equal"], key
        one = sum(c[key]["one"] for c in cases)
        more = sum(c[key]["more"] for c in cases)
        n = sum(c[key]["n"] for c in cases)
        print(f"{grid} {key}: per-rank scales put {one} of {n} int8 values "
              f"one quantum apart and {more} more")
        assert one + more > n // 8


@pytest.mark.parametrize("grid", LAYOUT_GRIDS)
def test_grid_dynamic_scales_are_the_unsharded_ones(runs, grid):
    """The int8 conv calls of the stems quantize with the unsharded
    forward's scales bit for bit on every rank: their inputs (the image,
    then the stems' own exact int8 convs, BN and ReLU) come out of the
    grid bit for bit, so their max over the grid is the whole
    activation's. The control, the same shards with each rank's own max,
    misses that on a rank at the first call. Past the stems the sharded
    fp ops round otherwise, an int8 value flips now and then, and the
    scales drift by the flips (printed, not bound)."""
    one = np.array(runs["ranks"][0]["one_call_scales"])
    stems = runs["ranks"][0]["stem_convs"]
    own_first = []
    for r in _layouts(runs, grid):
        got = np.array(r["int8_dynamic_counts"][0])
        own = np.array(r["own_call_scales"])
        assert got.shape == own.shape == one.shape and len(one) > 100
        rel = np.abs(got / one - 1)
        lead = int(np.argmax(rel > 0)) if (rel > 0).any() else len(one)
        own_first.append(own[0] != one[0])
        print(f"{grid}: the first {lead} call scales bit for bit ({stems} "
              f"stem convs), {int((rel == 0).sum())} of {len(one)} in all, "
              f"worst {rel.max():.3g}; per-rank scales: "
              f"{int((own != one).sum())} apart, worst "
              f"{np.abs(own / one - 1).max():.3g}")
        assert stems >= 4 and lead >= stems
    assert any(own_first)


@pytest.mark.parametrize("grid", LAYOUT_GRIDS)
def test_grid_calibration_gives_npp_tpus_one_scale_tree(runs, grid):
    """``calibrate_int8`` on the grid: every rank holds the same scales,
    and they are npp_tpu's ``calibrate_acts`` scales through the bridge
    (the stems within SCALE_RTOL, deeper convs within MODEL_SCALE_RTOL,
    as in ``tests/test_torch_int8.py``)."""
    ranks = [r["scales"] for r in _layouts(runs, grid)]
    assert all(r == ranks[0] for r in ranks)
    ref = tq.prepare_int8(_port_model(runs))
    convert.load_jax_variables(ref, {"act_scales": runs["layouts"]["scales"]})
    want = {n: m.act_scale.item() for n, m in ref.named_modules()
            if isinstance(m, tq.Int8Conv2d)}
    assert set(want) == set(ranks[0]) and len(want) > 100
    for name, got in ranks[0].items():
        rtol = SCALE_RTOL if name.startswith("stem") else MODEL_SCALE_RTOL
        np.testing.assert_allclose(got, want[name], rtol=rtol, err_msg=name)


@pytest.mark.parametrize("grid", LAYOUT_GRIDS)
def test_grid_int8_all_reduces_per_forward(runs, grid):
    """One MAX all-reduce per int8 conv call of a dynamic forward (the
    unfused and the fused layouts), none once calibrated; the grid's int8
    convs fold the ReLU at as many calls as one device's (a row window
    takes ``relu=True`` through ``ShardedInt8Conv2d.forward``)."""
    folded = runs["ranks"][0]["one_folded"]
    for r in _layouts(runs, grid):
        scales, maxes, fold, _ = r["int8_dynamic_counts"]
        assert len(scales) > 100 and maxes == len(scales)
        assert fold == folded and 0 < fold < len(scales)
        f_scales, f_maxes, _, _ = r["fused_int8_counts"]
        assert 0 < len(f_scales) < len(scales) and f_maxes == len(f_scales)
        c_scales, c_maxes, c_fold, _ = r["int8_calibrated_counts"]
        assert len(c_scales) == len(scales) and c_maxes == 0
        assert c_fold == folded


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
