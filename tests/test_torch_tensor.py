"""The port's tensor parallelism against npp_tpu on the CPU: the ``data x
space x model`` grids 1x1x2 (ranks 0-1; ranks 2-3 run the float64, control
and 20-class cases on theirs meanwhile), 2x1x2 and 1x2x2 of one group of
four gloo ranks.

npp_tpu's own TP tests hold the 2x2x2 loss within 1e-4 of one device
(``tests/test_parallel.py:58-104``) and a 1x1x2 step across two
processes within 1e-5 (``tests/test_multiprocess_sp.py:98-147``); the
port places the gathers itself (``npp_tpu_torch/parallel/tensor.py``),
so here:

- the shard rule against npp_tpu's ``tp_spec`` on the variables of
  ``jax.eval_shape(model.init)``, at the flagship widths (L=16, C=64, 20
  classes, 16 joints) and at a tiny one (5 classes, 4 joints: replicated
  heads), for n_model 2 and 4;
- every place of the module docstring alone (the convs and BNs of the
  ops, ``DilConvS``, ``SepConv``, ``SEBlock``, ``FactorizedReduce`` with
  sharded and with replicated convs, the pools, the cells' sums and
  concatenations, ``InterOp`` with and without its projection, sharded
  and replicated ``_Head`` s, the stem) in train mode, with its input
  and weight gradients, against the unconverted op, on every grid (the
  cells, which take several inputs, on the grids without a space axis:
  a spatially converted module traces its plan from one input);
- NPPNet (L=4, C=8, 64 px, 5 classes and 4 joints: the parsing head's
  last conv is replicated) in eval mode against the unconverted forward
  at 1e-4 x max|ref|;
- the train step (``init_train_state(grid=)``, ``make_train_step``) at
  the global batch of 4 against npp_tpu's one-device value-and-gradient,
  to ``tests/test_torch_parallel.py``'s bounds: losses, train-mode
  outputs, gradients, running stats, lambdas and the Adam step (applied
  to npp_tpu's gradients by the port's optimizer, as in
  ``tests/test_torch_spatial.py``), the gradients by the norm rule (in
  float32 the per-tensor rule is out of reach of the port's one-process
  step itself at these widths) and, in float64 on 1x1x2, per tensor to
  rounding against the port's unconverted model; at 20 classes and 16
  joints on 1x1x2 against the port's one-process step, which
  ``tests/test_torch_train.py`` holds to npp_tpu;
- the flip-TTA eval step on the 1x1x2 and 2x1x2 grids against npp_tpu's
  ``make_eval_step`` on the global batch, to ``tests/test_torch_model.
  py``'s bounds;
- checkpoints on the 2x1x2 grid: a TP run's (whole tensors under the
  unchanged keys) restored in one process, that one's restored in a TP
  run, bit for bit;
- the hybrid ZeRO x TP step equal to the TP step bit for bit, its
  consolidated state equal to the TP step's gathered one and loading
  into a plain Adam; ``n_model`` 1 equal to the ``data x space`` grid
  bit for bit; ``make_grid``'s messages against ``make_mesh_3d``'s;
- two negative controls that must miss: a gather whose backward is a
  reduce-scatter in front of the replicated head conv (the gradient of
  its input comes out ``n_model`` times too large; float64), and the
  criterion over the
  world in place of the replica group. At random weights every gt
  probability is under OHEM's 0.9, so OHEM keeps every pixel and the
  world's doubled counts cancel in N x numerator / denominator; the
  control therefore takes OHEM at threshold 0, where the k-th value of
  the duplicated probabilities decides the kept set (as it does for a
  trained model, whose probabilities pass 0.9).

The four ranks (``WORKER``) import torch only; they start first and run
beside the module's one JAX program (npp_tpu's value-and-gradient and
its eval step, compiled with most XLA optimisations off), the flagship's
``eval_shape`` and the port's one-process references.
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
from flax.traverse_util import flatten_dict

from npp_tpu.core import criterion as jcrit
from npp_tpu.core import evaluate as jeval
from npp_tpu.core import train as jtrain
from npp_tpu.data import loader as jloader
from npp_tpu.models.augment import NPPNet as JNPPNet
from npp_tpu.parallel import tensor as jtensor

from npp_tpu_torch.core import criterion as tcrit
from npp_tpu_torch.core import train as ttrain
from npp_tpu_torch.data import loader as tloader
from npp_tpu_torch.data.synthetic import SyntheticDataset
from npp_tpu_torch.models.augment import NPPNet
from npp_tpu_torch.parallel import tensor as ttensor
from npp_tpu_torch.utils import convert

from test_torch_ops import random_variables
from test_torch_parallel import (_adam_close, _env, _free_port, _jax_model,
                                 _wait, _write_npz)
from test_torch_train import GRAD_TOL_NORM, LAMDAS, _grad_errors

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
TINY = dict(num_classes=5, num_joints=4, layers=4, init_channels=8,
            refine_layers=1)
WIDE = dict(TINY, num_classes=20, num_joints=16)
FLAGSHIP = dict(num_classes=20, num_joints=16, layers=16, init_channels=64,
                refine_layers=1)
SIZE, OHEM_KEEP, LR, BATCH = 64, 256, 1e-3, 4
WORLD = 4
GRIDS = ("1x1x2", "2x1x2", "1x2x2")
CLASS_WEIGHTS = jcrit.LIP_CLASS_WEIGHTS[:5]
OUT_REL = 1e-4       # outputs and running stats: 1e-4 x max|ref|
OP_REL = 1e-5        # one op against itself unconverted: x max|ref|
FP64_REL = 1e-9      # float64 gradients: x (max|ref| + max|ref| of all)
KEYS = ("image", "par", "joints", "visibility")
EVAL_KW = dict(num_classes=5, class_weights=CLASS_WEIGHTS, flip_test=True,
               flip_pairs=(), ohem_keep=OHEM_KEEP, decode_hw=(SIZE, SIZE))

WORKER = r'''
import os, sys, time
import numpy as np
import torch
import torch.distributed as dist

from npp_tpu_torch.core import checkpoint as C, criterion as K
from npp_tpu_torch.core import evaluate as E, train as T
from npp_tpu_torch.data import loader as L
from npp_tpu_torch.genotypes import DECODER, ENCODER, FUSION
from npp_tpu_torch.models.augment import _Head, _Stem, build_nppnet
from npp_tpu_torch.models.augment import init_weights
from npp_tpu_torch.models.cells import Cell, FusionCell, InterOp, UpsampleCell
from npp_tpu_torch.ops.primitives import FactorizedReduce, make_op
from npp_tpu_torch.parallel import mesh, spatial, tensor, zero
from npp_tpu_torch.utils import convert

torch.set_num_threads(1)
OUT = sys.argv[1]
assert mesh.initialize_distributed("cpu")
deadline = time.monotonic() + 120
while not os.path.exists(os.path.join(OUT, "ready")):  # the inputs
    assert time.monotonic() < deadline, "no inputs"
    time.sleep(0.05)
CFG = dict(np.load(os.path.join(OUT, "config.npz"), allow_pickle=True))
TINY, WIDE, OPT = (CFG[k].item() for k in ("tiny", "wide", "opt"))
KW = CFG["eval_kw"].item()
LOSS = dict(class_weights=KW["class_weights"], ohem_keep=KW["ohem_keep"])
rank = mesh.rank()
variables = convert.load_npz(os.path.join(OUT, "weights.npz"))
data = dict(np.load(os.path.join(OUT, "data.npz")))
KEYS = ("image", "par", "joints", "visibility")
render = L.make_target_renderer(num_joints=4, normalize_images=True)
batch = {k: torch.from_numpy(data[k]) for k in KEYS}
batch.update(render(*(batch[k] for k in KEYS)))
eval_batch = dict(batch, scale=torch.from_numpy(data["scale"]),
                  crop_param=torch.from_numpy(data["crop_param"]))
wide_render = L.make_target_renderer(normalize_images=True)
wide = {k: torch.from_numpy(data["wide_" + k]) for k in KEYS}
wide.update(wide_render(*(wide[k] for k in KEYS)))


def model(kw=TINY, grid=None, train=False, tp_first=False):
    m = build_nppnet(device="cpu", generator=torch.Generator().manual_seed(0),
                     dtype=torch.float32, train=train, **kw)
    if tp_first:
        tensor.convert_tensor_parallel(m, grid)
    spatial.convert_spatial(m, grid)
    tensor.convert_tensor_parallel(m, grid)
    return m


def load_weights(m, lamdas=None):
    """npp_tpu's weights into ``m``, converted or not: through the bridge
    into an unconverted NPPNet, then this rank's blocks."""
    whole = model()
    convert.load_jax_variables(whole, variables, lamdas)
    tensor.load_whole_state_dict(m, whole.state_dict())


def flat(outs):
    return [t.detach().clone() for stage in outs for pair in stage
            for t in pair]


def whole_grads(m, grid):
    """Every parameter's gradient, the sharded ones gathered."""
    tp = tensor.sharding_of(m)
    return {k: (mesh.all_concat(p.grad, grid.model_group)
                if tp is not None and k in tp.sharded else p.grad.clone())
            for k, p in m.named_parameters()}


def state_of(st, grid):
    opt = zero.optimizer_state_dict(st.optimizer, st.model)
    return {"grad": whole_grads(st.model, grid),
            "sd": tensor.whole_state_dict(st.model),
            "lamda": {k: p.detach().clone() for k, p in st.lamdas.items()},
            "lamda_grad": {k: p.grad.clone() for k, p in st.lamdas.items()},
            "opt_dict": opt,
            "opt": None if opt is None else {
                i: {k: v.clone() for k, v in s.items()}
                for i, s in opt["state"].items()}}


def spread(blob, grid):
    """max |x - x on the grid's first rank| over the grid."""
    vec = torch.cat([t.float().reshape(-1) for part in ("grad", "sd")
                     for t in blob[part].values()])
    first = vec.clone()
    src = dist.get_process_group_ranks(grid.world)[0]
    dist.broadcast(first, src=src, group=grid.world)
    return mesh.all_sum((vec - first).abs().max().reshape(1),
                        grid.world).item()


def message(fn):
    try:
        fn()
    except (ValueError, RuntimeError, TypeError) as e:
        return str(e)
    return ""


# -- one module alone --------------------------------------------------------

def build(name, seed):
    if name == "stem":
        m, shapes = _Stem(3, 8, 2), [(3, 16, 16)]
    elif name == "factorized_6":  # convs of 3 (replicated at n 2), BN of 6
        m, shapes = FactorizedReduce(8, 6), [(8, 16, 16)]
    elif name.startswith("head_"):
        out = int(name.split("_")[1])
        m, shapes = _Head(8, 6, out, 3, False), [(8, 16, 16)]
    elif name == "cell_normal":
        m = Cell(ENCODER.normal, ENCODER.normal_concat, 16, 16, 4, False,
                 False)
        shapes = [(16, 16, 16), (16, 16, 16)]
    elif name == "cell_reduce":
        m = Cell(ENCODER.reduce, ENCODER.reduce_concat, 16, 16, 8, True,
                 True)
        shapes = [(16, 16, 16), (16, 8, 8)]
    elif name == "upsample":
        m, shapes = (UpsampleCell(DECODER.upsample2, DECODER.upsample_concat2,
                                  16, 16), [(16, 8, 8), (16, 16, 16)])
    elif name == "fusion":
        m = FusionCell(FUSION.par, FUSION.par_concat, (12, 16, 16), 4)
        shapes = [(12, 16, 16), (16, 16, 16), (16, 16, 16)]
    elif name == "inter_adapt":
        m, shapes = InterOp("se_connect", 8, 16, 0.5, True), [(8, 16, 16)]
    elif name == "inter_same":
        m, shapes = InterOp("dil_conv_3x3_2", 8, 8, 1.0, False), [(8, 16, 16)]
    else:
        op, stride = name.rsplit("_s", 1)
        m, shapes = make_op(op, 8, int(stride)), [(8, 16, 16)]
    init_weights(m, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():  # BN statistics that are not the identity
        for mod in m.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.normal_(0.0, 0.5, generator=g)
                mod.running_var.uniform_(0.5, 1.5, generator=g)
    return m, shapes


def rows(t, grid):
    b = t.shape[0] // grid.n_data
    return spatial.own_rows(t[grid.d * b:(grid.d + 1) * b], grid)


def outputs(y):
    return list(y) if isinstance(y, tuple) else [y]


def op_case(grid, name, seed):
    """Max errors of the converted module against itself unconverted:
    eval outputs, train outputs, input gradients, weight gradients
    (gathered over the model group, summed over the replica group)."""
    ref, shapes = build(name, seed)
    op, _ = build(name, seed)
    spatial.convert_spatial(op, grid)
    tensor.convert_tensor_parallel(op, grid)
    tp = tensor.sharding_of(op)
    gen = torch.Generator().manual_seed(seed)
    xs = [torch.randn(2, *shape, generator=gen) for shape in shapes]
    err = {}
    ref.eval(), op.eval()
    with torch.no_grad():
        want = outputs(ref(*xs))
        got = outputs(op(*[rows(x, grid) for x in xs]))
        err["eval"] = (max((tp.whole(g, w.shape[1]) - rows(w, grid))
                           .abs().max().item() for g, w in zip(got, want)),
                       max(w.abs().max().item() for w in want))
    ref.train(), op.train()
    xr = [x.clone().requires_grad_() for x in xs]
    want = outputs(ref(*xr))
    ws = [torch.randn(w.shape, generator=gen) for w in want]
    sum((w * c).sum() for w, c in zip(want, ws)).backward()
    xl = [rows(x, grid).clone().requires_grad_() for x in xs]
    got = [tp.whole(g, w.shape[1]) for g, w in zip(outputs(op(*xl)), want)]
    share = [1.0 if g.shape[-2] != w.shape[-2] or grid.n_space == 1
             else 1.0 / grid.n_space for g, w in zip(got, want)]
    sum((g * rows(c, grid)).sum() * f
        for g, c, f in zip(got, ws, share)).backward()
    err["train"] = (max((g - rows(w.detach(), grid)).abs().max().item()
                        for g, w in zip(got, want)),
                    max(w.abs().max().item() for w in want))
    err["grad_in"] = (max((a.grad - rows(b.grad, grid)).abs().max().item()
                          for a, b in zip(xl, xr)),
                      max(b.grad.abs().max().item() for b in xr))
    grads = whole_grads(op, grid)
    gw, gr = 0.0, 0.0
    for k, q in ref.named_parameters():
        total = mesh.all_sum(grads[k], grid.replica_group) \
            if grid.n_data * grid.n_space > 1 else grads[k]
        gw = max(gw, (total - q.grad).abs().max().item())
        gr = max(gr, q.grad.abs().max().item())
    err["grad_w"] = (gw, gr)
    return err


OPS = ("stem", "factorized_6", "head_4", "head_5", "cell_normal",
       "cell_reduce", "upsample", "fusion", "inter_adapt", "inter_same",
       "dil_conv_3x3_2_s1", "dil_conv_3x3_4_s2", "sep_conv_3x3_s1",
       "sep_conv_5x5_s2", "se_connect_s1", "se_connect_s2",
       "skip_connect_s2", "skip_connect_s1", "std_conv_3x3_s1",
       "max_pool_3x3_s1", "avg_pool_3x3_s2", "conv_7x1_1x7_s1",
       "poled_conv_x1_s1", "none_s2")
# A spatially converted module takes one input (its plan's trace), so the
# cells run alone on the grids without a space axis; NPPNet runs them on
# 1x2x2.
MULTI_INPUT = ("cell_normal", "cell_reduce", "upsample", "fusion")


# -- NPPNet ------------------------------------------------------------------

def train_state(grid, kw=TINY, load=True, seed=0, zero_=False):
    st = T.init_train_state(generator=torch.Generator().manual_seed(seed),
                            device="cpu", dtype=torch.float32, grid=grid,
                            zero=zero_, **OPT, **kw)
    if load:
        load_weights(st.model, st.lamdas)
    return st


def train_run(grid, kw=TINY, b=batch, **state_kw):
    st = train_state(grid, kw, **state_kw)
    outs = {}
    st.model.register_forward_hook(
        lambda m, a, o: outs.__setitem__("train", flat(o)))
    step = T.make_train_step(**dict(LOSS, class_weights=(
        LOSS["class_weights"] if kw is TINY else K.LIP_CLASS_WEIGHTS)),
        grid=grid)
    local = b if grid is None else spatial.shard_batch_spatial(b, grid)
    metrics = step(st, local)
    return st, {k: v.item() for k, v in metrics.items()}, outs["train"], local


def parsing_loss(outs, local, group, grid):
    """The parsing loss of a step's outputs at OHEM threshold 0 (the
    negative control of the module docstring)."""
    pars = [(outs[4 + 2 * i], outs[5 + 2 * i]) for i in range(2)]
    return K.parsing_loss(pars, local["par"], local["edge"],
                          torch.tensor([2.3, 2.0]), thres=0.0,
                          group=group, grid=grid,
                          class_weights=LOSS["class_weights"],
                          min_kept=LOSS["ohem_keep"]).item()


def run_grid(name, grid):
    out = {"d": grid.d, "s": grid.s, "m": grid.m}
    # The eval forward against the unconverted one.
    ref, tp = model(), model(grid=grid)
    convert.load_jax_variables(ref, variables)
    load_weights(tp)
    image = eval_batch["image"]
    local = spatial.shard_batch_spatial({"image": image}, grid)["image"]
    with torch.no_grad():
        out["fwd"] = flat(tp(local))
        out["fwd_ref"] = [rows(t, grid) for t in flat(ref(image))]
        if name == "1x2x2":  # the conversions in the other order
            other = model(grid=grid, tp_first=True)
            load_weights(other)
            out["fwd_tp_first"] = flat(other(local))
    # The train step.
    st, out["metrics"], out["train_outs"], local = train_run(grid)
    blob = state_of(st, grid)
    blob.pop("opt_dict")
    out["rank_spread"] = spread(blob, grid)
    out["state"] = blob
    out["control_world"] = parsing_loss(out["train_outs"], local,
                                        grid.world, grid)
    out["control_replica"] = parsing_loss(out["train_outs"], local,
                                          st.group, grid)
    # Checkpoints: TP -> one process -> TP.
    if name == "2x1x2":
        a, b = (os.path.join(OUT, f"ckpt_{name}_{x}") for x in "ab")
        C.CheckpointManager(a).save(0, st)
        one = train_state(None, load=False, seed=7)
        C.CheckpointManager(a).restore(one)
        out["ckpt_one"] = {"sd": one.model.state_dict(),
                           "opt": one.optimizer.state_dict()["state"],
                           "step": one.step}
        C.CheckpointManager(b).save(0, one)
        back = train_state(grid, load=False, seed=9)
        C.CheckpointManager(b).restore(back)
        out["ckpt_back"] = (
            all(torch.equal(x, y) for x, y in zip(
                st.model.state_dict().values(),
                back.model.state_dict().values()))
            and all(torch.equal(st.optimizer.state[p][k],
                                back.optimizer.state[q][k])
                    for p, q in zip(st.model.parameters(),
                                    back.model.parameters())
                    for k in ("exp_avg", "exp_avg_sq"))
            and back.step == st.step)
        del one, back
    if name == "2x1x2":  # the hybrid ZeRO x TP layout
        zst, zm, _, _ = train_run(grid, zero_=True)
        zb = state_of(zst, grid)
        out["zero_equal"] = zm == out["metrics"] and all(
            torch.equal(zb[p][k], blob[p][k]) for p in ("grad", "sd")
            for k in blob[p])
        out["zero_opt_equal"] = None if zb["opt"] is None else all(
            torch.equal(zb["opt"][i][k], blob["opt"][i][k])
            for i in blob["opt"] for k in blob["opt"][i])
        if zb["opt"] is not None:  # it loads into a plain one-process Adam
            one = train_state(None, load=False)
            one.optimizer.load_state_dict(zb["opt_dict"])
            params = [p for g in one.optimizer.param_groups
                      for p in g["params"]]
            out["zero_loads"] = all(
                torch.equal(one.optimizer.state[p][k], blob["opt"][i][k])
                for i, p in enumerate(params)
                for k in ("exp_avg", "exp_avg_sq"))
        zb.pop("opt_dict")
        del zst
    # The leaves the model axis keeps whole, offset by m on each model
    # rank, come back to rank m = 0's values.
    sharded = tensor.sharding_of(st.model).sharded
    leaves = ([p.grad for k, p in st.model.named_parameters()
               if k not in sharded]
              + [p.grad for p in st.lamdas.values()]
              + [b for k, b in st.model.named_buffers()
                 if k not in sharded and b.is_floating_point()])
    before = [t.clone() for t in leaves]
    with torch.no_grad():
        for t in leaves:
            t.add_(grid.m)
    tensor.share_replicated(st.model, st.lamdas.values())
    out["shared"] = (len(leaves), all(torch.equal(t, b)
                                      for t, b in zip(leaves, before)))
    del st
    if name != "1x2x2":  # the eval step against npp_tpu's
        ev = E.make_eval_step(model(grid=grid), **KW)
        load_weights(ev.model)
        b = len(image) // grid.n_data
        mine = {k: v[grid.d * b:(grid.d + 1) * b]
                for k, v in eval_batch.items()}
        res = ev(K.init_criterion_params(2), mine)
        out["eval"] = {k: v.clone() for k, v in res.items()}
        out["validate_message"] = message(
            lambda: E.validate(ev, K.init_criterion_params(2), [],
                               num_classes=5))
    # Each module alone.
    out["ops"] = {op: op_case(grid, op, 100 + i) for i, op in enumerate(OPS)
                  if grid.n_space == 1 or op not in MULTI_INPUT}
    return out


def fp64_grads(grid, reduce_scatter=False):
    """The gradients of one float64 forward and backward of the loss on the
    grid (gathered), with npp_tpu's weights; with ``reduce_scatter`` a
    gather whose backward is a reduce-scatter in front of every replicated
    conv (the parsing heads' last conv): the negative control."""
    m = model(grid=grid, train=True)
    lamdas = {k: torch.nn.Parameter(torch.zeros(2)) for k in
              ("lamda_pose", "lamda_par")}
    load_weights(m, lamdas)
    m.double()
    lamdas = {k: p.double() for k, p in lamdas.items()}
    b = dict(batch, image=batch["image"].double())
    real = tensor.ChannelSharding.conv_input

    def gather_then_copy(self, conv, x):
        if conv.tp_kind is None and x.shape[1] != conv.in_channels:
            return tensor.copy_to_model(self.whole(x, conv.in_channels),
                                        self)
        return real(self, conv, x)

    if reduce_scatter:
        tensor.ChannelSharding.conv_input = gather_then_copy
    try:
        loss, _, _ = T.compute_losses(m, lamdas, b, **LOSS)
        loss.backward()
    finally:
        tensor.ChannelSharding.conv_input = real
    return whole_grads(m, grid)


def supernet():
    from npp_tpu_torch.models.search import SearchNet
    with torch.device("meta"):
        return SearchNet(layers=4, init_channels=8)


pairs = [mesh.make_grid(1, 1, 2, ranks=[0, 1]),
         mesh.make_grid(1, 1, 2, ranks=[2, 3])]
grids = {"1x1x2": pairs[0] or pairs[1], "2x1x2": mesh.make_grid(2, 1, 2),
         "1x2x2": mesh.make_grid(1, 2, 2)}
result = {}
if rank < 2:
    result["1x1x2"] = run_grid("1x1x2", grids["1x1x2"])
else:  # the other pair meanwhile: float64, the control, 20 classes
    result["fp64"] = fp64_grads(grids["1x1x2"])
    result["control_rs"] = fp64_grads(grids["1x1x2"], reduce_scatter=True)
    with torch.no_grad():
        fwd = flat(model(WIDE, grids["1x1x2"])(wide["image"]))
    st, m, outs, _ = train_run(grids["1x1x2"], WIDE, wide, load=False)
    result["wide"] = {"metrics": m, "outs": outs, "fwd": fwd,
                      "grad": whole_grads(st.model, grids["1x1x2"]),
                      "sd": tensor.whole_state_dict(st.model)}
    del st
for name in ("2x1x2", "1x2x2"):
    result[name] = run_grid(name, grids[name])
# n_model 1 against the data x space grid, bit for bit.
for name, g in (("2x2", mesh.make_grid(2, 2)),
                ("2x2x1", mesh.make_grid(2, 2, 1))):
    st, m, outs, _ = train_run(g)
    result[name] = {"metrics": m, "outs": outs,
                    "sd": {k: v.clone() for k, v in
                           st.model.state_dict().items()},
                    "grad": whole_grads(st.model, g)}
    del st
result["messages"] = [message(lambda: mesh.make_grid(3, 1, 2)),
                      message(lambda: mesh.make_grid(1, 1, 3)),
                      message(lambda: mesh.make_grid(3, 1))]
result["refusals"] = [
    message(lambda: __import__("npp_tpu_torch.core.predictor", fromlist=[
        "Predictor"]).Predictor(model(), mesh=grids["2x1x2"])),
    message(lambda: tensor.convert_tensor_parallel(supernet(),
                                                   grids["2x1x2"]))]
torch.save(result, os.path.join(OUT, f"rank{rank}.pt"))
dist.destroy_process_group()
print(f"WORKER_OK rank={rank}")
'''


def _host_batch(seed, num_classes, num_joints):
    ds = SyntheticDataset(length=BATCH, crop_size=(SIZE, SIZE),
                          num_joints=num_joints, num_classes=num_classes,
                          seed=seed, device_normalize=True)
    host = tloader.collate([ds[i] for i in range(BATCH)])
    host["par"][1, :8, :20] = 255  # ignored pixels
    gain = np.linspace(0.25, 1.0, BATCH, dtype=np.float32)
    host["image"] = (host["image"] * gain[:, None, None, None]).astype(
        np.uint8)
    return host


_SHAPES = {}


def _flax_shapes(kw) -> dict:
    """npp_tpu's NPPNet variables at the widths ``kw`` as shapes
    (``jax.eval_shape``: nothing is compiled), one trace per width."""
    key = tuple(sorted(kw.items()))
    if key not in _SHAPES:
        jm = JNPPNet(dtype=jnp.float32, **kw)
        _SHAPES[key] = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)),
            train=False))
    return _SHAPES[key]


def _torch_batch(host, num_joints):
    b = {k: torch.from_numpy(host[k]) for k in KEYS}
    b.update(tloader.make_target_renderer(
        num_joints=num_joints, normalize_images=True)(*(b[k] for k in KEYS)))
    return b


def _one_process(kw, host, variables=None) -> dict:
    """The port's one-process train step at the widths ``kw`` (npp_tpu's
    ``variables``, or the seeded weights), and its eval forward before
    the step: the reference of the TP gradients (module docstring)."""
    st = ttrain.init_train_state(
        generator=torch.Generator().manual_seed(0), device="cpu",
        base_lr=LR, lr_step=(2,), lr_factor=0.2, steps_per_epoch=1,
        dtype=torch.float32, **kw)
    if variables is not None:
        convert.load_jax_variables(
            st.model, {"params": {"model": variables["params"],
                                  "criterion": LAMDAS},
                       "batch_stats": variables["batch_stats"]}, st.lamdas)
    batch = _torch_batch(host, kw["num_joints"])
    with torch.no_grad():
        st.model.eval()
        fwd = [t.clone() for stage in st.model(batch["image"])
               for pair in stage for t in pair]
    outs = {}
    st.model.register_forward_hook(lambda m, a, o: outs.__setitem__(
        "train", [t.detach().clone() for stage in o for pair in stage
                  for t in pair]))
    cw = CLASS_WEIGHTS if kw is TINY else jcrit.LIP_CLASS_WEIGHTS
    metrics = ttrain.make_train_step(class_weights=cw, ohem_keep=OHEM_KEEP)(
        st, batch)
    return {"metrics": {k: v.item() for k, v in metrics.items()},
            "fwd": fwd, "outs": outs["train"],
            "grad": {k: p.grad.clone()
                     for k, p in st.model.named_parameters()},
            "sd": st.model.state_dict()}


def _one_process_fp64(host, variables) -> dict:
    """The gradients of one float64 forward and backward of the port's
    unconverted model at the tiny widths (``WORKER``'s ``fp64_grads``)."""
    m = ttrain.build_nppnet(device="cpu", train=True, dtype=torch.float32,
                            generator=torch.Generator().manual_seed(0),
                            **TINY)
    lamdas = {k: torch.nn.Parameter(torch.zeros(2)) for k in LAMDAS}
    convert.load_jax_variables(
        m, {"params": {"model": variables["params"], "criterion": LAMDAS},
            "batch_stats": variables["batch_stats"]}, lamdas)
    m.double()
    batch = _torch_batch(host, TINY["num_joints"])
    batch["image"] = batch["image"].double()
    loss, _, _ = ttrain.compute_losses(
        m, {k: p.double() for k, p in lamdas.items()}, batch,
        class_weights=CLASS_WEIGHTS, ohem_keep=OHEM_KEEP)
    loss.backward()
    return {k: p.grad.clone() for k, p in m.named_parameters()}


def _write_inputs(out: Path):
    """The ranks' weights, batches and configuration under ``out``; returns
    npp_tpu's model, its variables and the host batch."""
    jm = JNPPNet(dtype=jnp.float32, **TINY)
    v = random_variables(_flax_shapes(TINY), seed=0)
    _write_npz(out / "weights.npz",
               {"params": {"model": v["params"], "criterion": LAMDAS},
                "batch_stats": v["batch_stats"]})
    host, wide = _host_batch(3, 5, 4), _host_batch(5, 20, 16)
    np.savez(out / "data.npz", **{k: host[k] for k in KEYS},
             **{"wide_" + k: wide[k] for k in KEYS}, scale=host["scale"],
             crop_param=host["crop_param"])
    np.savez(out / "config.npz", tiny=TINY, wide=WIDE,
             eval_kw=dict(EVAL_KW, class_weights=tuple(CLASS_WEIGHTS)),
             opt=dict(base_lr=LR, lr_step=(2,), lr_factor=0.2,
                      steps_per_epoch=1))
    (out / "ready").touch()
    return jm, v, host, wide


def _launch(out: Path) -> list:
    port = str(_free_port())
    return [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(out)], cwd=ROOT,
        env=_env(RANK=str(r), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(r),
                 MASTER_ADDR="localhost", MASTER_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks (started first) and npp_tpu's value-and-gradient and
    eval step beside them."""
    out = tmp_path_factory.mktemp("tensor")
    procs = _launch(out)  # they wait for the inputs
    fast = jax.config.values["jax_disable_most_optimizations"]
    try:
        jm, v, host, wide = _write_inputs(out)
        jax.config.update("jax_disable_most_optimizations", True)
        params = {"model": v["params"],
                  "criterion": {k: jnp.asarray(a) for k, a in LAMDAS.items()}}
        jbatch = {k: jnp.asarray(host[k]) for k in KEYS + ("scale",
                                                           "crop_param")}
        jbatch.update(jloader.make_target_renderer(
            num_joints=4, normalize_images=True)(*(jbatch[k] for k in KEYS)))
        eval_body = jeval.make_eval_step_body(jm, **EVAL_KW)

        def program(p, batch):
            def loss_fn(p):
                return jtrain.compute_losses(
                    jm, p, v["batch_stats"], batch, train=True,
                    class_weights=CLASS_WEIGHTS, ohem_keep=OHEM_KEEP)

            (_, (stats, metrics, outs)), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(p)
            ev = eval_body({"model": p["model"],
                            "criterion": jtrain.init_criterion_params(2)},
                           v["batch_stats"], batch)
            return dict(metrics=metrics, grads=grads, stats=stats, eval=ev,
                        outs=[t for stage in outs for pair in stage
                              for t in pair])

        # XLA compiles without the GIL: the program compiles on a thread
        # while the flagship's shapes (the shard rule) are traced and the
        # port's one-process steps (the gradient references) run.
        lowered = jax.jit(program).lower(params, jbatch)
        compiled = []
        thread = threading.Thread(
            target=lambda: compiled.append(lowered.compile()))
        thread.start()
        _flax_shapes(FLAGSHIP)
        one = _one_process(TINY, host, v)
        one["fp64"] = _one_process_fp64(host, v)
        one_wide = _one_process(WIDE, wide)
        thread.join()
        jax_ref = jax.device_get(compiled[0](params, jbatch))
    finally:
        jax.config.update("jax_disable_most_optimizations", fast)
        results = _wait(procs, timeout=300)
    for rc, log in results:
        assert rc == 0, log[-4000:]
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    jax_ref["params"] = _adam_step(v, jax_ref["grads"], TINY)
    return dict(jax=jax_ref, ranks=ranks, host=host, one=one,
                one_wide=one_wide)


def _adam_step(variables, grads, kw) -> dict:
    """The weights after Adam's first step from npp_tpu's weights and
    gradients by the port's optimizer (``tests/test_torch_spatial.py``'s
    rule at the widths ``kw``): state_dict keys and lambda names to numpy
    arrays."""
    state = ttrain.init_train_state(
        generator=torch.Generator().manual_seed(0), device="cpu",
        base_lr=LR, lr_step=(2,), lr_factor=0.2, steps_per_epoch=1,
        dtype=torch.float32, **kw)
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
    ranks = runs["ranks"][:2] if grid == "1x1x2" else runs["ranks"]
    return [r[grid] for r in ranks]


def _shape(grid):
    return tuple(int(n) for n in grid.split("x"))


def _rows(ref, d, s, n_data, n_space):
    """Data shard d, rows s of a whole (B, H, W, C) map."""
    b = ref.shape[0] // n_data
    ref = ref[d * b:(d + 1) * b]
    h = ref.shape[1] // n_space
    return ref[:, s * h:(s + 1) * h]


# -- the shard rule -----------------------------------------------------------

def _jax_sharded(kw, n_model):
    shapes = _flax_shapes(kw)
    return {convert.torch_key(c, path)
            for c in ("params", "batch_stats")
            for path, x in flatten_dict(shapes[c]).items()
            if jtensor.tp_spec(x, n_model) != jax.sharding.PartitionSpec()}


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("widths", ["flagship", "tiny"])
def test_shard_rule_is_tp_spec(runs, widths, n_model):
    """The leaves the port shards are those npp_tpu's ``tp_spec`` shards
    (every conv kernel, bias and BN vector whose width ``n_model``
    divides), by state_dict key; the lambdas and ``num_batches_tracked``
    are not model variables in npp_tpu and stay whole in the port."""
    kw = FLAGSHIP if widths == "flagship" else TINY
    with torch.device("meta"):
        port = NPPNet(**kw)
    ours = set(ttensor.tp_shards(port, n_model))
    assert ours == _jax_sharded(kw, n_model)
    assert not any(k.endswith("num_batches_tracked") for k in ours)
    replicated = {k for k in port.state_dict() if k not in ours}
    if widths == "tiny":  # 5 classes: the parsing heads' last conv
        assert "par_head.0.Conv_1.weight" in replicated
        assert ("edge_head.0.Conv_1.weight" in replicated) == (n_model == 4)


# -- each place alone ---------------------------------------------------------

OP_NAMES = ("stem", "factorized_6", "head_4", "head_5", "cell_normal",
            "cell_reduce", "upsample", "fusion", "inter_adapt", "inter_same",
            "dil_conv_3x3_2_s1", "dil_conv_3x3_4_s2", "sep_conv_3x3_s1",
            "sep_conv_5x5_s2", "se_connect_s1", "se_connect_s2",
            "skip_connect_s2", "skip_connect_s1", "std_conv_3x3_s1",
            "max_pool_3x3_s1", "avg_pool_3x3_s2", "conv_7x1_1x7_s1",
            "poled_conv_x1_s1", "none_s2")
MULTI_INPUT = ("cell_normal", "cell_reduce", "upsample", "fusion")
OP_CASES = [(g, op) for g in GRIDS for op in OP_NAMES
            if g != "1x2x2" or op not in MULTI_INPUT]


@pytest.mark.parametrize("grid,op", OP_CASES,
                         ids=[f"{g}-{op}" for g, op in OP_CASES])
def test_module_on_its_channel_block_matches_itself_unconverted(runs, grid,
                                                                op):
    """One module on every rank (its rows under sp) against itself
    unconverted, in eval and in train mode, with its input gradients and
    its weight gradients (blocks gathered); OP_REL x max|ref| each."""
    for r in _grid_ranks(runs, grid):
        for what, (err, scale) in r["ops"][op].items():
            assert err <= OP_REL * max(scale, 1.0), (what, err, scale)


# -- NPPNet -------------------------------------------------------------------

@pytest.mark.parametrize("grid", GRIDS)
def test_tp_forward_matches_unconverted(runs, grid):
    for r in _grid_ranks(runs, grid):
        assert len(r["fwd"]) == 8
        for got, want in zip(r["fwd"], r["fwd_ref"]):
            assert got.shape == want.shape  # whole channels on every rank
            scale = max(want.abs().max().item(), 1e-12)
            assert (got - want).abs().max().item() <= OUT_REL * scale


def test_conversions_compose_in_either_order(runs):
    """On 1x2x2, ``convert_tensor_parallel`` before ``convert_spatial``
    gives the forward of the other order, bit for bit."""
    for r in _grid_ranks(runs, "1x2x2"):
        for a, b in zip(r["fwd_tp_first"], r["fwd"]):
            assert torch.equal(a, b)


def _state(runs, grid):
    return _grid_ranks(runs, grid)[0]["state"]


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("key", ["loss", "loss_pose", "loss_par"])
def test_tp_losses_match_jax_at_the_global_batch(runs, grid, key):
    """The mean over the replica ranks of the losses is npp_tpu's; every
    model rank of a (d, s) holds the same loss."""
    n_model = _shape(grid)[2]
    got = [r["metrics"][key] for r in _grid_ranks(runs, grid)]
    for i in range(0, len(got), n_model):
        assert len(set(got[i:i + n_model])) == 1
    np.testing.assert_allclose(np.mean(got),
                               float(runs["jax"]["metrics"][key]), rtol=1e-5)


@pytest.mark.parametrize("grid", GRIDS)
def test_tp_train_outputs_match_jax(runs, grid):
    n_data, n_space, _ = _shape(grid)
    for r in _grid_ranks(runs, grid):
        for got, ref in zip(r["train_outs"], runs["jax"]["outs"]):
            ref = _rows(np.asarray(ref), r["d"], r["s"], n_data, n_space)
            got = got.permute(0, 2, 3, 1).numpy()
            assert got.shape == ref.shape
            scale = max(float(np.abs(ref).max()), 1e-12)
            assert float(np.abs(got - ref).max()) <= OUT_REL * scale


@pytest.mark.parametrize("grid", GRIDS)
def test_tp_state_is_the_same_on_every_rank(runs, grid):
    """Gathered gradients and state agree across the grid's ranks."""
    for r in _grid_ranks(runs, grid):
        assert r["rank_spread"] == 0.0


def _np(d):
    return {k: v.numpy() for k, v in d.items()}


def _fp64_share(got: dict, ref: dict) -> tuple:
    """(worst share of the FP64_REL bound, its tensor): |got - ref| <=
    FP64_REL x (max|ref| of the tensor + max|ref| of the model)."""
    model_max = max(r.abs().max().item() for r in ref.values())
    return max(((got[k] - r).abs().max().item()
                / (FP64_REL * (r.abs().max().item() + model_max)), k)
               for k, r in ref.items())


@pytest.mark.parametrize("grid", GRIDS)
def test_whole_leaves_are_shared_from_model_rank_zero(runs, grid):
    """``share_replicated`` gives every model rank rank m = 0's gradients
    of the whole parameters (the parsing heads' last convs at 5 classes)
    and lambdas and running stats of the whole BNs: an offset of m on
    each rank's copy is undone."""
    for r in _grid_ranks(runs, grid):
        n, equal = r["shared"]
        assert n > 2 and equal  # more than the two lambdas


def test_tp_float64_gradients_match_one_process(runs):
    """In float64 the 1x1x2 gradients (gathered) are the port's
    unconverted ones to rounding (``FP64_REL``): the model axis changes no
    derivative. In float32 they cannot be held per tensor: the fp32
    gradients of NPPNet in train mode keep ~2-3 digits, and at 5 classes
    and 4 joints the port's one-process step misses the per-tensor rule
    against npp_tpu (1.46 of it) and against its own float64 gradients
    (11% on ``pose_net.0.ops.2.Conv_0.weight``, where the TP step is 0.7%
    off); the float32 steps are held by the norm rule below."""
    for r in runs["ranks"][2:]:
        worst, key = _fp64_share(r["fp64"], runs["one"]["fp64"])
        assert worst <= 1.0, (worst, key)


@pytest.mark.parametrize("grid", GRIDS)
def test_tp_gradients_match_one_process_and_jax(runs, grid):
    """The float32 step's gathered gradients against npp_tpu's and against
    the port's one-process step by ``tests/test_torch_train.py``'s norm
    rule (the per-tensor rule: see the float64 test)."""
    got = _np(_state(runs, grid)["grad"])
    for ref in (_np(runs["one"]["grad"]),
                _jax_model(runs["jax"]["grads"]["model"], "params")):
        _, _, norm = _grad_errors(got, ref)
        assert norm <= GRAD_TOL_NORM, norm


@pytest.mark.parametrize("grid", GRIDS)
def test_tp_running_stats_match_jax(runs, grid):
    ref = _jax_model(runs["jax"]["stats"], "batch_stats")
    sd = _state(runs, grid)["sd"]
    for k, want in ref.items():
        got = sd[k].numpy()
        scale = max(float(np.abs(want).max()), 1e-12)
        assert float(np.abs(got - want).max()) <= OUT_REL * scale, k
    assert len(ref) > 100


@pytest.mark.parametrize("grid", GRIDS)
def test_tp_lamdas_and_adam_step_match_jax(runs, grid):
    state = _state(runs, grid)
    jgrads, jparams = runs["jax"]["grads"], runs["jax"]["params"]
    for k in LAMDAS:
        np.testing.assert_allclose(state["lamda_grad"][k].numpy(),
                                   np.asarray(jgrads["criterion"][k]),
                                   rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(state["lamda"][k].numpy(),
                                   np.asarray(jparams["criterion"][k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    gref = _jax_model(jgrads["model"], "params")
    for k, ref in jparams["model"].items():
        _adam_close(state["sd"][k].numpy(), ref,
                    state["grad"][k].numpy(), gref[k], k)


def test_tp_at_20_classes_matches_one_process(runs):
    """1x1x2 at 20 classes and 16 joints (every head sharded) against the
    port's one-process step: forward, losses, train outputs, gradients
    (the gradient rule) and the updated state."""
    one = runs["one_wide"]
    for r in runs["ranks"][2:]:
        tp = r["wide"]
        for a, b in zip(tp["fwd"], one["fwd"]):
            assert (a - b).abs().max() <= OUT_REL * b.abs().max()
        for k, v in one["metrics"].items():
            np.testing.assert_allclose(tp["metrics"][k], v, rtol=1e-5)
        for a, b in zip(tp["outs"], one["outs"]):
            assert (a - b).abs().max() <= OUT_REL * b.abs().max()
        worst, key, norm = _grad_errors(_np(tp["grad"]), _np(one["grad"]))
        assert worst <= 1.0 and norm <= GRAD_TOL_NORM, (worst, key, norm)
        for k, v in one["sd"].items():
            if "running" in k:
                scale = max(v.abs().max().item(), 1e-12)
                assert (tp["sd"][k] - v).abs().max() <= OUT_REL * scale, k


# -- the eval step ------------------------------------------------------------

@pytest.mark.parametrize("grid", ["1x1x2", "2x1x2"])
def test_tp_eval_step_matches_jax(runs, grid):
    """Each data shard's flip-TTA eval step against npp_tpu's on the global
    batch (``tests/test_torch_model.py``'s bounds): parsing and pose
    predictions identical on >= 99.5%, the summed confusion matrix's
    count, the loss of a whole-batch shard at rtol 1e-4; every model rank
    of a shard returns the same whole outputs."""
    ref = runs["jax"]["eval"]
    rs = _grid_ranks(runs, grid)
    n_data = _shape(grid)[0]
    b = BATCH // n_data
    for r in rs:
        ev, d = r["eval"], r["d"]
        par = np.asarray(ref["par_pred"])[d * b:(d + 1) * b]
        assert (ev["par_pred"].numpy() == par).mean() >= 0.995
        pose = np.asarray(ref["pose_pred"])[d * b:(d + 1) * b, :, :2]
        assert np.all(ev["pose_pred"][..., :2].numpy() == pose,
                      axis=-1).mean() >= 0.995
        if n_data == 1:
            np.testing.assert_allclose(ev["loss"].item(), float(ref["loss"]),
                                       rtol=1e-4)
        twin = next(o for o in rs if o["d"] == d and o is not r)["eval"]
        for k, v in ev.items():
            assert torch.equal(v, twin[k]), k
        assert "n_model > 1" in r["validate_message"]
    cm = sum(r["eval"]["cm"] for r in rs if r["m"] == 0)
    assert cm.sum().item() == float(np.asarray(ref["cm"]).sum())


# -- checkpoints, ZeRO, n_model 1 ---------------------------------------------

@pytest.mark.parametrize("grid", ["2x1x2"])
def test_checkpoint_round_trips_tp_one_process_tp(runs, grid):
    """A TP run's checkpoint holds whole tensors under the unchanged keys:
    it restores in one process to the gathered state and moments, and
    that process's checkpoint restores in a TP run bit for bit."""
    for r in _grid_ranks(runs, grid):
        one, st = r["ckpt_one"], r["state"]
        assert one["step"] == 1 and r["ckpt_back"]
        assert one["sd"].keys() == st["sd"].keys()
        for k, v in st["sd"].items():
            assert torch.equal(one["sd"][k], v), k
    rank0 = _grid_ranks(runs, grid)[0]
    for i, s in rank0["state"]["opt"].items():
        for k, v in s.items():
            assert torch.equal(rank0["ckpt_one"]["opt"][i][k], v), (i, k)


def test_hybrid_zero_equals_tp_bit_for_bit(runs):
    """ZeRO-1 over each data group of the 2x1x2 grid: the same losses,
    gradients and updated state as the TP step; the consolidated moments
    (on rank 0) equal the TP step's gathered ones and load into a plain
    one-process Adam."""
    rs = _grid_ranks(runs, "2x1x2")
    assert all(r["zero_equal"] for r in rs)
    assert rs[0]["zero_opt_equal"] and rs[0]["zero_loads"]
    assert all(r["zero_opt_equal"] is None for r in rs[1:])


def test_n_model_one_is_the_data_space_grid_bit_for_bit(runs):
    for r in runs["ranks"]:
        a, b = r["2x2"], r["2x2x1"]
        assert a["metrics"] == b["metrics"]
        for x, y in zip(a["outs"], b["outs"]):
            assert torch.equal(x, y)
        for part in ("sd", "grad"):
            assert a[part].keys() == b[part].keys()
            for k in a[part]:
                assert torch.equal(a[part][k], b[part][k]), (part, k)


# -- the negative controls ----------------------------------------------------

def test_reduce_scatter_before_a_replicated_head_misses(runs):
    """A gather whose backward is a reduce-scatter in front of the
    replicated parsing-head conv multiplies its input's gradient by
    n_model: the float64 gradients miss the bound the right gather meets
    by orders of magnitude."""
    for r in runs["ranks"][2:]:
        worst, key = _fp64_share(r["control_rs"], runs["one"]["fp64"])
        assert worst > 1e3, (worst, key)


@pytest.mark.parametrize("grid", GRIDS)
def test_criterion_over_the_world_misses(runs, grid):
    """The parsing loss of the step's outputs at OHEM threshold 0: over the
    replica group the mean of the ranks' losses is the global batch's,
    over the world (each sample counted n_model times) it is not."""
    jouts = [torch.from_numpy(np.asarray(t)).permute(0, 3, 1, 2)
             for t in runs["jax"]["outs"]]
    host = runs["host"]
    b = {k: torch.from_numpy(host[k]) for k in KEYS}
    b.update(tloader.make_target_renderer(
        num_joints=4, normalize_images=True)(*(b[k] for k in KEYS)))
    pars = [(jouts[4 + 2 * i], jouts[5 + 2 * i]) for i in range(2)]
    want = tcrit.parsing_loss(pars, b["par"], b["edge"],
                              torch.tensor([2.3, 2.0]), thres=0.0,
                              class_weights=CLASS_WEIGHTS,
                              min_kept=OHEM_KEEP).item()
    rs = _grid_ranks(runs, grid)
    right = np.mean([r["control_replica"] for r in rs])
    wrong = np.mean([r["control_world"] for r in rs])
    np.testing.assert_allclose(right, want, rtol=1e-5)
    assert abs(wrong - want) > 100 * 1e-5 * abs(want), (wrong, want)


# -- messages and refusals ----------------------------------------------------

def test_grid_messages_match_make_mesh_3d(runs):
    with pytest.raises(ValueError) as e3:
        jtensor.make_mesh_3d(3, 1, 2, devices=list(range(WORLD)))
    with pytest.raises(ValueError) as e3b:
        jtensor.make_mesh_3d(1, 1, 3, devices=list(range(WORLD)))
    from npp_tpu.parallel.spatial import make_mesh_2d
    with pytest.raises(ValueError) as e2:
        make_mesh_2d(3, 1, devices=list(range(WORLD)))
    assert runs["ranks"][0]["messages"] == [str(e3.value), str(e3b.value),
                                            str(e2.value)]


def test_serving_and_the_supernet_are_refused(runs):
    predictor, supernet = runs["ranks"][0]["refusals"]
    assert "n_model > 1" in predictor
    assert "SearchNet" in supernet or "does not know" in supernet
