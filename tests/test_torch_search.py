"""The port's search slice against npp_tpu on the CPU.

Each module of the slice runs the same seeded numpy inputs through the
JAX function and the port's, with the flax weights (trees from
``jax.eval_shape``, leaves from a numpy RNG, architecture parameters
random too) carried over by the port's weight bridge. Everything in fp32
and in train mode (batch statistics, updated running statistics); NHWC <->
NCHW at compare. The JAX supernet never runs as a jitted train step here:
its whole forward runs eagerly (``jax.disable_jit``) in the unrolled
layout and jitted in the default vmapped layout, and the JAX steps run
eagerly in the one ``slow`` test. Tiny configuration: L=4, C=8, 64x64,
batch 2, 20 classes, 16 joints.

Tolerances, as max|diff| over max|ref| of each tensor unless stated:

- channel shuffle, the nearest resize, the numpy btw weights, genotypes,
  the genotype JSON: exact; the torch btw weights: rtol 1e-6 (two
  softmaxes);
- every op, MixedOp, SearchFusionCell, SearchUpsampleCell (outputs and
  running stats): 1e-4, fp32 convs summed in another order; their
  gradients: 1e-3 x max|g_ref| per tensor + 1e-5 x the module's
  max|g_ref| (``grad_err``);
- the port resizes a cross-scale MixedOp's weighted sum once where the
  unrolled JAX layout resizes each candidate (``models/search.py``): the
  same 1e-4 holds it;
- the whole supernet against the unrolled JAX one: outputs 1e-4, running
  stats 1e-3 (the JAX BN takes one-pass moments, E[x^2] - E[x]^2, which
  lose digits where a channel's mean is large against its spread, as
  after the max pools; the port's are two-pass); against a default
  vmapped tree: atol 5e-3 (the JAX package's own bound for its vmapped
  convs on the CPU, ``tests/test_search.py:194-204``), running stats
  5e-3;
- loss_entropy: rtol 1e-6, its gradient 1e-6;
- the arch Adam and the weight Adam against optax: rtol 1e-6 + atol 1e-7
  (optax rounds its bias corrections to float32);
- the arch gradients of the whole supernet in fp32 against the port's own
  fp64 run: 5e-2 x max|g| per tensor + 1e-5 x the largest max|g|, 1e-2
  in norm (``tests/test_torch_train.py``'s bounds: the train-mode BN
  gradients of this net keep few digits in fp32);
- one weight step + one arch step against the JAX steps (``slow``): the
  weight step's losses rtol 1e-5, the arch step's 1e-3 (it follows one
  Adam update, which moves each weight by about +-lr whatever the size of
  its gradient), the entropy rtol 1e-6; the arch parameters after the
  arch step: Adam's first update moves each by lr * g / (|g| + eps),
  about +-lr, and the arch gradients are taken at weights that the
  weight step's +-lr moves have already set apart, so a gradient near 0
  may change sign (10 of the 70 elements of ``alphas1`` did in one run):
  each within 2 lr + 1e-6, and at least two thirds of all within 1e-6
  (gradients of the wrong sign or scale would agree on about half).
"""
import copy
import dataclasses
import json

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from npp_tpu import genotypes as jgt
from npp_tpu.core import criterion as jcrit
from npp_tpu.core import search as jsearch
from npp_tpu.data import loader as jloader
from npp_tpu.models import genotype_parse as jgp
from npp_tpu.models import search as jms
from npp_tpu.ops import primitives as jprim
from npp_tpu.ops import resize as jresize
from npp_tpu.utils.torch_convert import search_default_to_unrolled

from npp_tpu_torch import engine
from npp_tpu_torch import genotypes as tgt
from npp_tpu_torch.core import checkpoint as tckpt
from npp_tpu_torch.core import search as tsearch
from npp_tpu_torch.core.criterion import LIP_CLASS_WEIGHTS
from npp_tpu_torch.data import loader as tloader
from npp_tpu_torch.data.synthetic import SyntheticDataset
from npp_tpu_torch.models import genotype_parse as tgp
from npp_tpu_torch.models import search as tms
from npp_tpu_torch.ops import primitives as tprim
from npp_tpu_torch.ops import resize as tresize
from npp_tpu_torch.tools import augment_lip, search_lip
from npp_tpu_torch.utils import convert

from test_torch_ops import random_variables

torch.set_num_threads(1)
TINY = dict(num_classes=20, num_joints=16, layers=4, init_channels=8,
            refine_layers=1)
SIZE, BATCH, OHEM_KEEP = 64, 2, 256
LOSS_KW = dict(class_weights=LIP_CLASS_WEIGHTS, ohem_keep=OHEM_KEEP)
LAMDAS = {"lamda_pose": np.array([-2.5, -2.0], np.float32),
          "lamda_par": np.array([2.3, 2.0], np.float32)}
OPT = dict(w_lr=1e-3, alpha_lr=1e-3, lr_step=(2,), lr_factor=0.2,
           steps_per_epoch=1)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def rel_err(got: np.ndarray, ref) -> float:
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-12)


def stats_err(module: torch.nn.Module, stats) -> float:
    """Worst rel_err of the port's running stats against a flax
    batch_stats tree (either layout)."""
    sd = module.state_dict()
    tree = convert.unroll_search_layout(jax.device_get(stats))
    worst = 0.0
    for path, ref in flatten_dict(tree).items():
        got = sd[convert.torch_key("batch_stats", path)].numpy()
        worst = max(worst, rel_err(got, ref))
    return worst


def grad_err(module, jgrads, extra=(), tol=1e-3) -> float:
    """The worst share, over the port's parameter gradients (and the
    (torch, jax) gradient pairs of ``extra``), of the bound ``tol`` x
    max|g_ref| of the tensor + 1e-5 x max|g_ref| of them all; the second
    term holds the conv biases that feed a train-mode BN, whose true
    gradient is 0 and whose computed one is rounding noise."""
    named = dict(module.named_parameters())
    pairs = list(extra)
    for path, g in flatten_dict(jax.device_get(jgrads)).items():
        g = np.asarray(g)
        if path[-1] == "kernel":
            g = g.transpose(3, 2, 0, 1)
        pairs.append((named[convert.torch_key("params", path)].grad, g))
    top = max(float(np.abs(ref).max()) for _, ref in pairs)
    return max(float(np.abs(got.numpy() - ref).max())
               / (tol * float(np.abs(ref).max()) + 1e-5 * top)
               for got, ref in pairs)


def _jax_init(module, *args):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args,
                                                train=False))
    return random_variables(shapes, seed=3)


def _softmax_rows(rng, *shape):
    return jax.nn.softmax(jnp.asarray(rng.normal(0, 1, shape), jnp.float32),
                          axis=-1)


# --------------------------------------------------------------------------
# Ops, mixed ops and cells.

def test_channel_shuffle_matches_jax():
    x = np.random.default_rng(0).normal(0, 1, (2, 5, 3, 12)).astype(
        np.float32)
    for groups in (2, 3, 4):
        ref = np.asarray(jms.channel_shuffle(jnp.asarray(x), groups))
        assert np.array_equal(nhwc(tms.channel_shuffle(nchw(x), groups)), ref)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("name", sorted(jprim.OPS))
def test_op_matches_flax_in_train_mode(name, affine, stride):
    """Every OPS entry, affine or not, at both strides: the output with
    batch statistics and the updated running stats."""
    c = 8
    x = np.random.default_rng(1).normal(0, 1, (2, 12, 10, c)).astype(
        np.float32)
    fmod = jprim.make_op(name, c, stride, affine, jnp.float32)
    v = _jax_init(fmod, jnp.asarray(x))
    ref, new = fmod.apply(v, jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
    tmod = tprim.make_op(name, c, stride, affine).train()
    convert.load_jax_variables(tmod, v)
    got = tmod(nchw(x))
    assert rel_err(nhwc(got), ref) <= 1e-4
    if "batch_stats" in new:
        assert stats_err(tmod, new["batch_stats"]) <= 1e-4


@pytest.mark.parametrize("hw,out_hw", [((96, 96), (48, 48)),
                                       ((96, 96), (24, 24)),
                                       ((48, 48), (12, 12)),
                                       ((12, 12), (96, 96)),
                                       ((24, 24), (96, 96)),
                                       ((3, 3), (24, 24))])
def test_resize_nearest_matches_jax_at_supernet_shapes(hw, out_hw):
    """The passthrough resize at the supernet's cross-scale pairs (1/4 to
    1/32 of a 384 crop, and the tiny one's 3x3): exact."""
    x = np.random.default_rng(2).normal(0, 1, (1, *hw, 3)).astype(np.float32)
    ref = np.asarray(jresize.resize_nearest(jnp.asarray(x), out_hw))
    assert np.array_equal(nhwc(tresize.resize_nearest(nchw(x), out_hw)), ref)


# (source channels, up_scale, proj width): the diagonal, an x2 and an x4
# decoder upscale with proj, a 1/2 encoder downscale with proj. The 2x2
# max pool of the passthrough is unreachable in both packages (every
# candidate keeps its input's size, and the passthrough is resized to
# the output's), so no case exercises it.
MIXED_CASES = {"same": (8, 1.0, None), "up2": (16, 2.0, 8),
               "up4": (16, 4.0, 8), "down2": (8, 0.5, 16)}


@pytest.mark.parametrize("case", sorted(MIXED_CASES))
def test_mixed_op_matches_flax(case):
    """Output, updated running stats, and the gradients of every weight
    and of the alpha weights, in train mode."""
    ch, up, extra = MIXED_CASES[case]
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, 12, 12, ch)).astype(np.float32)
    w = _softmax_rows(rng, 7)
    fmod = jms.MixedOp(ch, up, extra, dtype=jnp.float32)
    v = _jax_init(fmod, jnp.asarray(x), w)
    r = None

    def loss(params, w):
        out, new = fmod.apply({"params": params,
                               "batch_stats": v["batch_stats"]},
                              jnp.asarray(x), w, train=True,
                              mutable=["batch_stats"])
        return jnp.sum(out * r), (out, new)

    ref_shape = jax.eval_shape(lambda: fmod.apply(v, jnp.asarray(x), w,
                                                  train=False)).shape
    r = jnp.asarray(rng.normal(0, 1, ref_shape), jnp.float32)
    (_, (ref, new)), (g_params, g_w) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(v["params"], w)

    tmod = tms.MixedOp(ch, up, extra).train()
    convert.load_jax_variables(tmod, v)
    tw = torch.tensor(np.asarray(w), requires_grad=True)
    out = tmod(nchw(x), tw)
    assert rel_err(nhwc(out), ref) <= 1e-4
    assert stats_err(tmod, new["batch_stats"]) <= 1e-4
    (out * nchw(np.asarray(r))).sum().backward()
    assert grad_err(tmod, g_params, [(tw.grad, g_w)]) <= 1.0


def test_search_fusion_cell_matches_flax():
    """Outputs (both concats), running stats, and the gradients of the
    weights and of the alpha and beta weights."""
    c = 8
    rng = np.random.default_rng(5)
    xs = [rng.normal(0, 1, (2, 8, 8, k)).astype(np.float32)
          for k in (3 * c, 4 * c, 4 * c)]
    aw = _softmax_rows(rng, 18, 7)
    bw = jms.btw_weights(jnp.asarray(rng.normal(0, 1, 18), jnp.float32), 3, 4)
    fmod = jms.SearchFusionCell(c, dtype=jnp.float32)
    v = _jax_init(fmod, *map(jnp.asarray, xs), aw, bw)
    rs = [jnp.asarray(rng.normal(0, 1, (2, 8, 8, k)), jnp.float32)
          for k in (3 * c, 4 * c)]

    def loss(params, aw, bw):
        (f1, f2), new = fmod.apply(
            {"params": params, "batch_stats": v["batch_stats"]},
            *map(jnp.asarray, xs), aw, bw, train=True,
            mutable=["batch_stats"])
        return jnp.sum(f1 * rs[0]) + jnp.sum(f2 * rs[1]), (f1, f2, new)

    (_, (f1, f2, new)), (g_params, g_aw, g_bw) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(v["params"], aw, bw)

    tmod = tms.SearchFusionCell((3 * c, 4 * c, 4 * c), c).train()
    convert.load_jax_variables(tmod, v)
    taw = torch.tensor(np.asarray(aw), requires_grad=True)
    tbw = torch.tensor(np.asarray(bw), requires_grad=True)
    t1, t2 = tmod(*map(nchw, xs), taw, tbw)
    assert rel_err(nhwc(t1), f1) <= 1e-4 and rel_err(nhwc(t2), f2) <= 1e-4
    assert stats_err(tmod, new["batch_stats"]) <= 1e-4
    ((t1 * nchw(np.asarray(rs[0]))).sum()
     + (t2 * nchw(np.asarray(rs[1]))).sum()).backward()
    assert grad_err(tmod, g_params, [(taw.grad, g_aw),
                                     (tbw.grad, g_bw)]) <= 1.0


def test_search_upsample_cell_matches_flax():
    rng = np.random.default_rng(6)
    s0 = rng.normal(0, 1, (2, 4, 4, 32)).astype(np.float32)
    s1 = rng.normal(0, 1, (2, 8, 8, 16)).astype(np.float32)
    aw = _softmax_rows(rng, 14, 7)
    bw = jms.btw_weights(jnp.asarray(rng.normal(0, 1, 14), jnp.float32), 2, 4)
    fmod = jms.SearchUpsampleCell(16, dtype=jnp.float32)
    v = _jax_init(fmod, jnp.asarray(s0), jnp.asarray(s1), aw, bw)
    ref, new = fmod.apply(v, jnp.asarray(s0), jnp.asarray(s1), aw, bw,
                          train=True, mutable=["batch_stats"])
    tmod = tms.SearchUpsampleCell(32, 16).train()
    convert.load_jax_variables(tmod, v)
    got = tmod(nchw(s0), nchw(s1), torch.from_numpy(np.asarray(aw)),
               torch.from_numpy(np.asarray(bw)))
    assert rel_err(nhwc(got), ref) <= 1e-4
    assert stats_err(tmod, new["batch_stats"]) <= 1e-4


# --------------------------------------------------------------------------
# Architecture parameters: weights, entropy, genotypes.

def _random_arch(seed):
    rng = np.random.default_rng(seed)
    shapes = {"alphas1": (10, 7), "alphas2": (10, 7), "alphas3": (18, 7),
              "alphas4": (18, 7), "alphas_pose": (18, 7),
              "alphas_par": (18, 7), "betas1": (10,), "betas2": (10,),
              "betas3": (18,), "betas4": (18,), "betas_pose": (18,),
              "betas_par": (18,)}
    return {k: rng.normal(0, 1, s).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("n_input,steps", [(3, 4), (1, 4), (5, 3), (2, 4)])
def test_btw_weights_match_jax(n_input, steps):
    n = sum(n_input + i for i in range(steps))
    b = np.random.default_rng(n).normal(0, 1, n).astype(np.float32)
    ref = np.asarray(jms.btw_weights(jnp.asarray(b), n_input, steps))
    got = tms.btw_weights(torch.from_numpy(b), n_input, steps).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert np.array_equal(tgp.btw_np(b.astype(np.float64), n_input, steps),
                          jgp.btw_np(b.astype(np.float64), n_input, steps))


def test_loss_entropy_and_its_gradient_match_jax():
    arch = _random_arch(7)
    ref, g_ref = jax.value_and_grad(jgp.loss_entropy)(
        {k: jnp.asarray(a) for k, a in arch.items()})
    ts = {k: torch.tensor(a, requires_grad=True) for k, a in arch.items()}
    got = tgp.loss_entropy(ts)
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    for k, t in ts.items():
        if k.startswith("alphas"):
            assert rel_err(t.grad.numpy(), g_ref[k]) <= 1e-6, k
        else:
            assert t.grad is None or not t.grad.any(), k
    # At the supernet's init (every alpha 1e-3) the entropy is its maximum.
    flat = tgp.loss_entropy({k: torch.full(a.shape, 1e-3)
                             for k, a in arch.items()})
    assert flat.item() == pytest.approx(0.25 * 2 * 6 / 12, rel=1e-6)


@pytest.mark.parametrize("seed", range(6))
def test_extract_genotype_matches_jax(seed):
    arch = _random_arch(seed)
    if seed == 5:  # the search's start: every parameter equal
        arch = {k: np.full_like(a, 1e-3) for k, a in arch.items()}
    ours, ref = tgp.extract_genotype(arch), jgp.extract_genotype(arch)
    assert [dataclasses.astuple(g) for g in ours] == \
        [dataclasses.astuple(g) for g in ref]


def test_save_genotypes_json_is_byte_identical(tmp_path):
    arch = _random_arch(11)
    meta = {"epoch": 3, "miou": 0.125, "pck": 0.0}
    jgt.save_genotypes(str(tmp_path / "jax.json"),
                       *jgp.extract_genotype(arch), meta=meta)
    tgt.save_genotypes(str(tmp_path / "port.json"),
                       *tgp.extract_genotype(arch), meta=meta)
    assert (tmp_path / "jax.json").read_bytes() == \
        (tmp_path / "port.json").read_bytes()
    inter, fuse = tgt.load_genotypes(str(tmp_path / "jax.json"))
    assert (inter, fuse) == tgp.extract_genotype(arch)
    assert tgt.PRIMITIVES_INTER == jgt.PRIMITIVES_INTER
    assert tgt.PRIMITIVES_PC == jgt.PRIMITIVES_PC
    assert json.loads((tmp_path / "port.json").read_text())["meta"] == meta


# --------------------------------------------------------------------------
# The whole supernet.

def _image(seed=1):
    return np.random.default_rng(seed).normal(0, 1, (BATCH, SIZE, SIZE, 3)
                                              ).astype(np.float32)


def _port_net(variables):
    tm = tms.build_search_model(device="cpu", dtype=torch.float32,
                                generator=torch.Generator().manual_seed(1),
                                **TINY)
    convert.load_jax_variables(tm, variables)
    return tm


def _flat_outputs(pose_par):
    return [t for stage in pose_par for pair in stage for t in pair]


@pytest.fixture(scope="module")
def trees():
    """Random weights for the tiny supernet in the default vmapped layout
    (the one the JAX search CLI saves: both vmaps and remat on) and, by
    the JAX package's own converter, in the unrolled layout."""
    jm = jms.SearchNet(dtype=jnp.float32, **TINY)
    assert jm.vmap_fusion and jm.vmap_injections and jm.remat
    v = _jax_init(jm, jnp.zeros((1, SIZE, SIZE, 3)))
    unrolled = jax.tree.map(np.asarray, search_default_to_unrolled(v))
    return {"vmapped": v, "unrolled": unrolled}


@pytest.fixture(scope="module")
def unrolled(trees):
    """The JAX unrolled supernet's train-mode forward (eager) and the
    port's, on the same random weights."""
    jm = jms.SearchNet(dtype=jnp.float32, remat=False, vmap_fusion=False,
                       vmap_injections=False, **TINY)
    v = trees["unrolled"]
    x = _image()
    with jax.disable_jit():
        outs, new = jm.apply(v, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    tm = _port_net(v)
    got = tm(nchw(x))
    return dict(variables=v, ref=_flat_outputs(outs), stats=new,
                got=_flat_outputs(got), model=tm)


@pytest.fixture(scope="module")
def vmapped(trees):
    """The same for the tree in the default vmapped layout, the JAX
    forward jitted."""
    v = trees["vmapped"]
    x = _image()
    run = jms.SearchNet(dtype=jnp.float32, remat=False, **TINY)
    outs, new = jax.jit(lambda v, x: run.apply(
        v, x, train=True, mutable=["batch_stats"]))(v, jnp.asarray(x))
    tm = _port_net(v)
    got = tm(nchw(x))
    return dict(ref=_flat_outputs(outs), stats=new, got=_flat_outputs(got),
                model=tm)


@pytest.mark.parametrize("index", range(8))
def test_supernet_outputs_match_jax_unrolled(unrolled, index):
    """pose/aux/par/edge x 2 stages in train mode."""
    assert len(unrolled["got"]) == len(unrolled["ref"]) == 8
    assert rel_err(nhwc(unrolled["got"][index]),
                   unrolled["ref"][index]) <= 1e-4


def test_supernet_running_stats_match_jax_unrolled(unrolled):
    assert stats_err(unrolled["model"], unrolled["stats"]["batch_stats"]) \
        <= 1e-3


@pytest.mark.parametrize("index", range(8))
def test_supernet_outputs_match_jax_vmapped_tree(vmapped, index):
    got = nhwc(vmapped["got"][index])
    ref = np.asarray(vmapped["ref"][index])
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-3)


def test_supernet_running_stats_match_jax_vmapped_tree(vmapped):
    assert stats_err(vmapped["model"], vmapped["stats"]["batch_stats"]) \
        <= 5e-3


def test_supernet_structure_and_arch_params(unrolled):
    tm = unrolled["model"]
    assert len(tm.inj_ops1) == len(tm.inj_ops2) == 10
    assert len(tm.up_inj_ops1) == len(tm.up_inj_ops2) == 18
    assert len(tm.pose_net) == len(tm.par_net) == 3
    assert all(len(c.ops) == 18 for c in (*tm.pose_net, *tm.par_net))
    arch = tm.arch_parameters()
    assert tuple(arch) == tms.ARCH_PARAM_NAMES == jms.ARCH_PARAM_NAMES
    for k, p in arch.items():
        assert np.array_equal(p.detach().numpy(),
                              unrolled["variables"]["params"][k]), k
    fresh = tms.build_search_model(device="cpu", dtype=torch.float32,
                                   generator=torch.Generator().manual_seed(0),
                                   **TINY)
    assert all(torch.all(p == 1e-3) for p in fresh.arch_parameters().values())
    n_weights = len(fresh.weight_parameters())
    assert n_weights + 12 == len(list(fresh.parameters()))
    # A pool candidate's BN and its extra BN are affine-free.
    op = fresh.inj_ops1[0]
    assert op.ops[3].BatchNorm_0.weight is None
    assert op.extra_bns[0].weight is None
    assert op.extra_bns[0].running_mean is not None


def test_bridge_refuses_merged_stream_supernet_trees(unrolled):
    v = unrolled["variables"]
    merged = {"Conv_0": {"Conv_0": {"kernel": np.zeros((3, 3, 3, 8))}}}
    tree = {"params": dict(v["params"], vstem_a=merged),
            "batch_stats": v["batch_stats"]}
    with pytest.raises(ValueError, match="merged-stream"):
        convert.load_jax_variables(unrolled["model"], tree)


# --------------------------------------------------------------------------
# Optimizers, steps, epochs, checkpoints, the CLI.

def _search_params(v):
    return {"model": jax.tree.map(jnp.asarray, v["params"]),
            "criterion": {k: jnp.asarray(a) for k, a in LAMDAS.items()}}


def _port_state(v=None, seed=0):
    state = tsearch.init_search_state(
        generator=torch.Generator().manual_seed(seed), device="cpu",
        dtype=torch.float32, **OPT, **TINY)
    if v is not None:
        convert.load_jax_variables(
            state.model, {"params": {"model": v["params"],
                                     "criterion": LAMDAS},
                          "batch_stats": v["batch_stats"]}, state.lamdas)
    return state


def _oihw(path, arr):
    arr = np.asarray(arr)
    return arr.transpose(3, 2, 0, 1) if path[-1] == "kernel" else arr


@pytest.mark.parametrize("which", ["weight", "arch"])
def test_optimizers_match_optax(trees, which):
    """Three updates of one optimizer from the same random gradients of
    every parameter (the schedule's boundary before the third): the
    weight Adam moves the weights and lambdas and leaves the architecture
    parameters, the arch Adam (betas (0.5, 0.999), weight decay 1e-3)
    moves them alone. Compared on the lambdas, the 12 architecture
    parameters and every 50th weight (optax over all 2,684 leaves costs a
    minute; the port's optimizer steps them all)."""
    v = trees["unrolled"]
    flat = flatten_dict(v["params"])
    keep = {p for i, p in enumerate(flat)
            if i % 50 == 0 or p[-1] in tms.ARCH_PARAM_NAMES}
    params = _search_params({"params": unflatten_dict(
        {p: a for p, a in flat.items() if p in keep})})
    w_tx, a_tx = jsearch.make_search_optimizers(**OPT)
    tx = w_tx if which == "weight" else a_tx
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    state = _port_state(v)
    opt = state.w_optimizer if which == "weight" else state.a_optimizer
    named = dict(state.model.named_parameters())
    rng = np.random.default_rng(12)
    flat = flatten_dict(params)
    for _ in range(3):
        grads = {p: rng.normal(0, 1, np.shape(a)).astype(np.float32)
                 for p, a in flat.items()}
        updates, opt_state = update(
            unflatten_dict({p: jnp.asarray(g) for p, g in grads.items()}),
            opt_state, params)
        params = optax.apply_updates(params, updates)
        state.zero_grad()
        for t in named.values():
            t.grad = torch.ones_like(t)
        for p, g in grads.items():
            t = (state.lamdas[p[1]] if p[0] == "criterion"
                 else named[convert.torch_key("params", p[1:])])
            t.grad = torch.from_numpy(np.ascontiguousarray(_oihw(p, g)))
        opt.step()
        if which == "weight":
            state.w_scheduler.step()
    assert state.w_scheduler.last_epoch == (3 if which == "weight" else 0)
    for p, ref in flatten_dict(jax.device_get(params)).items():
        t = (state.lamdas[p[1]] if p[0] == "criterion"
             else named[convert.torch_key("params", p[1:])])
        np.testing.assert_allclose(t.detach().numpy(), _oihw(p, ref),
                                   rtol=1e-6, atol=1e-7, err_msg=str(p))


def _host_batch(seed):
    ds = SyntheticDataset(length=BATCH, crop_size=(SIZE, SIZE),
                          num_joints=16, num_classes=20, seed=seed,
                          device_normalize=True)
    host = tloader.collate([ds[i] for i in range(BATCH)])
    host["par"][1, :8, :20] = 255  # ignored pixels
    # A brightness per image: noise images alone average out to nearly
    # equal deep features, and a train-mode BN over such a batch amplifies
    # rounding.
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


def _snapshot(tensors):
    return {k: t.detach().clone() for k, t in tensors.items()}


def test_step_invariants_and_every_parameter_gets_a_gradient():
    """The weight step leaves the architecture parameters bit for bit and
    advances the schedule; the arch step leaves the weights and lambdas bit
    for bit and advances nothing; both backwards reach every parameter
    (torch's Adam would skip one without a gradient, where optax moves
    every leaf)."""
    state = _port_state()
    weight_step, arch_step = tsearch.make_search_steps(**LOSS_KW)
    arch = state.model.arch_parameters()
    weights = {n: p for n, p in state.model.named_parameters()
               if n not in arch}
    everything = {**{"m." + n: p for n, p in state.model.named_parameters()},
                  **state.lamdas}

    before = _snapshot({**arch})
    w_before = _snapshot({**weights, **state.lamdas})
    m = weight_step(state, _torch_batch(_host_batch(3)))
    assert set(m) == {"loss", "loss_pose", "loss_par", "entropy"}
    assert all(p.grad is not None for p in everything.values())
    assert all(torch.equal(arch[k], before[k]) for k in arch)
    moved = sum(not torch.equal(weights[k], w_before[k]) for k in weights)
    assert moved > 0.9 * len(weights)
    assert state.step == 1 and state.w_scheduler.last_epoch == 1

    w_before = _snapshot({**weights, **state.lamdas})
    a_before = _snapshot(arch)
    arch_step(state, _torch_batch(_host_batch(4)), 1.0)
    assert all(p.grad is not None for p in everything.values())
    assert all(torch.equal(t, w_before[k]) for k, t in
               {**weights, **state.lamdas}.items())
    assert all(not torch.equal(arch[k], a_before[k]) for k in arch)
    assert state.step == 1 and state.w_scheduler.last_epoch == 1


def test_arch_gradients_against_fp64(unrolled):
    """The arch step's gradients of all 12 architecture parameters in fp32
    against the port's own fp64 run on the same weights and batch: the
    fp32 floor that the slow JAX comparison sits on."""
    v = unrolled["variables"]
    batch = _torch_batch(_host_batch(3))
    grads = {}
    for dtype in (torch.float32, torch.float64):
        state = _port_state(v)
        state.model.to(dtype)
        state.lamdas = {k: torch.nn.Parameter(p.detach().to(dtype))
                        for k, p in state.lamdas.items()}
        _, arch_step = tsearch.make_search_steps(**LOSS_KW)
        b = {k: t.to(dtype) if t.is_floating_point() else t
             for k, t in batch.items()}
        arch_step(state, b, 1.0)
        grads[dtype] = {k: p.grad.double()
                        for k, p in state.model.arch_parameters().items()}
    top = max(float(g.abs().max()) for g in grads[torch.float64].values())
    sq_d = sq_r = worst = 0.0
    for k, ref in grads[torch.float64].items():
        d = grads[torch.float32][k] - ref
        worst = max(worst, float(d.abs().max())
                    / (5e-2 * float(ref.abs().max()) + 1e-5 * top))
        sq_d += float((d * d).sum())
        sq_r += float((ref * ref).sum())
    norm = (sq_d / sq_r) ** 0.5
    print(f"arch gradients, port fp32 vs port fp64: worst tensor {worst:.3g} "
          f"of the bound, norm {norm:.3g}")
    assert worst <= 1.0 and norm <= 1e-2


def test_search_epoch_reads_the_loss_at_print_freq():
    calls = []

    def weight_step(state, batch):
        calls.append(("w", batch))
        return {"loss": torch.tensor(float(len(calls)))}

    def arch_step(state, batch, coef):
        calls.append(("a", batch, coef))
        return {"loss": torch.tensor(0.0), "entropy": torch.tensor(0.0)}

    avg, gstep = engine.search_epoch(weight_step, arch_step, None,
                                     [0, 1, 2], [10, 11, 12, 13], epoch=71,
                                     entropy_epoch=70, print_freq=2)
    assert [c[0] for c in calls] == ["w", "a"] * 3
    assert [c[1] for c in calls] == [0, 10, 1, 11, 2, 12]
    assert all(c[2] == 1.0 for c in calls if c[0] == "a")
    assert avg == pytest.approx((1 + 3 + 5) / 3) and gstep == 0
    calls.clear()
    engine.search_epoch(weight_step, arch_step, None, [0], [1], epoch=70,
                        entropy_epoch=70)
    assert calls[1][2] == 0.0


def test_search_epoch_and_checkpoint_round_trip_are_exact(tmp_path):
    """A bi-level pair through the engine on loaders that render on the
    CPU; the saved state restores into a state built from another seed
    exactly (model, architecture parameters, lambdas, both optimizers,
    the schedule, the count) and takes the same next pair."""
    hp = dict(search_lip.TINY_SEARCH, crop=(SIZE, SIZE), workers=2)
    train, mini, _ = search_lip.build_loaders(hp, "cpu")
    train = augment_lip.LimitedLoader(train, 1)
    mini = augment_lip.LimitedLoader(mini, 1)
    weight_step, arch_step = search_lip.make_search_steps(
        dict(hp, ohem_keep=OHEM_KEEP))
    state = _port_state()
    avg, _ = engine.search_epoch(weight_step, arch_step, state, train, mini,
                                 epoch=0, print_freq=1)
    assert np.isfinite(avg) and state.step == 1
    mgr = tckpt.CheckpointManager(str(tmp_path), max_to_keep=2)
    mgr.save(0, state, metrics={"best_iou": 0.5}, is_best=True,
             tag="warmed")
    resumed = _port_state(seed=9)
    _, meta = mgr.restore(resumed)
    assert meta == {"epoch": 0, "best_iou": 0.5}
    blob_a = copy.deepcopy(tckpt.state_dict(state))
    _equal(blob_a, tckpt.state_dict(resumed))
    b1, b2 = _torch_batch(_host_batch(5)), _torch_batch(_host_batch(6))
    losses = [(weight_step(s, b1)["loss"].item(),
               arch_step(s, b2, 0.0)["loss"].item())
              for s in (state, resumed)]
    assert losses[0] == losses[1]
    _equal(tckpt.state_dict(state), tckpt.state_dict(resumed))
    for name in ("best", "warmed"):
        other = _port_state(seed=8)
        _, meta = mgr.restore_named(other, name)
        assert meta["epoch"] == 0
        _equal(blob_a, tckpt.state_dict(other))


def _equal(a, b, where=""):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}/{i}")
    else:
        assert a == b, where


def test_search_cli_runs_tiny_on_cpu(tmp_path):
    out = search_lip.main(["--synthetic", "--tiny", "--device", "cpu",
                           "--dtype", "float32", "--steps", "2", "--epochs",
                           "2", "--warmup-epochs", "1", "--out",
                           str(tmp_path)])
    assert np.isfinite(out["train_loss"])
    assert np.isfinite(out["result"]["loss"])
    assert out["state"].step == 4  # 2 warmup steps + 2 weight steps
    run = tmp_path / "lip" / "search" / "tiny"
    inter, fuse = tgt.load_genotypes(str(run / "best_genotype.json"))
    assert (inter, fuse) == out["best_genotype"]
    for name in ("0", "1", "best", "warmed", "final"):
        assert (run / "checkpoints" / name / "state.pt").is_file()


def test_search_cli_refuses_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="cuda"):
        search_lip.main(["--synthetic", "--tiny", "--out", "/nonexistent"])


@pytest.mark.slow
def test_weight_and_arch_steps_match_jax(trees):
    """One weight step then one arch step (entropy on) from the same
    weights, JAX un-jitted (``share_program=False``) against the port:
    losses, entropy, and the architecture parameters after the arch step
    (tolerances: module docstring)."""
    v = trees["unrolled"]
    jm = jms.SearchNet(dtype=jnp.float32, remat=False, vmap_fusion=False,
                       vmap_injections=False, **TINY)
    w_tx, a_tx = jsearch.make_search_optimizers(**OPT)
    params = _search_params(v)
    jstate = jsearch.SearchState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]),
        w_opt_state=w_tx.init(params), a_opt_state=a_tx.init(params))
    w_step, a_step = jsearch.make_search_steps(
        jm, w_tx, a_tx, class_weights=jcrit.LIP_CLASS_WEIGHTS,
        ohem_keep=OHEM_KEEP, share_program=False)
    h1, h2 = _host_batch(3), _host_batch(4)
    with jax.disable_jit():
        jstate, jm1 = w_step(jstate, _jax_batch(h1))
        jstate, jm2 = a_step(jstate, _jax_batch(h2), 1.0)

    state = _port_state(v)
    weight_step, arch_step = tsearch.make_search_steps(**LOSS_KW)
    m1 = weight_step(state, _torch_batch(h1))
    m2 = arch_step(state, _torch_batch(h2), 1.0)
    for k in ("loss", "loss_pose", "loss_par"):
        np.testing.assert_allclose(m1[k].item(), float(jm1[k]), rtol=1e-5)
        np.testing.assert_allclose(m2[k].item(), float(jm2[k]), rtol=1e-3)
    np.testing.assert_allclose(m2["entropy"].item(), float(jm2["entropy"]),
                               rtol=1e-6)
    ref = jsearch.get_arch_params(jstate)
    got = tsearch.get_arch_params(state)
    apart = n = 0
    for k in tms.ARCH_PARAM_NAMES:
        d = np.abs(got[k].astype(np.float64) - ref[k])
        assert d.max() <= 2 * OPT["alpha_lr"] + 1e-6, k
        apart += int((d > 1e-6).sum())
        n += d.size
    print(f"arch parameters after the pair: {apart} of {n} apart")
    assert apart <= n / 3
