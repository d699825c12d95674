"""The port's context heads (``ops/heads.py``) and model summary
(``utils/summary.py``) against npp_tpu on the CPU.

Each head is built at npp_tpu's defaults (pool sizes, rates, scales) at
tiny widths: 16 input channels on 24x24, batch 2. Its flax variables come
from ``jax.eval_shape`` (no init trace) filled from a numpy RNG and load
into the port's head through the weight bridge
(``utils/convert.load_jax_variables``). One JAX program a head runs the
eval forward and the train forward (with its new ``batch_stats``), jitted
at the highest matmul precision; the port runs both in fp32. Outputs and
the running statistics after the train step agree within 1e-5 x
max|ref| (measured: at most 3.9e-6, SPHead's train forward); ASPP's
shared BN takes its five updates in turn in both.

``model_flops``: on a 64^3 matrix product both packages count exactly
2 * 64^3. On a head they count different things. The port counts the
convolutions and matrix products only (``FlopCounterMode``), each conv at
its full window, padding included; XLA's cost analysis (npp_tpu's
``model_flops``) counts the taps a padded conv really reads, plus the
BN, ReLU, pool and resize ops. On ``PSPModule`` (16 -> 16 channels,
24x24, eval and train forward in one call) the port counts 53,186,560
against XLA's 51,886,832, a ratio of 1.0250: the 3x3 fusion conv's
padded window adds 5.8% at 24x24 and XLA's elementwise, pool and resize
ops take back part of it. The test holds the ratio within 3%. Other
heads differ more at these widths (ASPP 3.53: its dilation-36 taps fall
almost all in the padding of a 24x24 map; SPHead 0.54: at 2-channel
strips XLA's elementwise ops outweigh the convs), so none of them is
the yardstick.
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from npp_tpu.models.augment import NPPNet as JNPPNet
from npp_tpu.ops import heads as jheads
from npp_tpu.ops import pooling as jpool
from npp_tpu.utils import summary as jsummary

from npp_tpu_torch.models.augment import build_nppnet
from npp_tpu_torch.ops import heads as theads
from npp_tpu_torch.utils import convert
from npp_tpu_torch.utils import summary as tsummary

from test_torch_ops import random_variables

torch.set_num_threads(1)
C, SIZE, BATCH = 16, 24, 2
RTOL = 1e-5
PSP_FLOP_RATIO = 0.03

HEADS = {
    "psp": (lambda: jheads.PSPModule(out_features=16, dtype=jnp.float32),
            lambda: theads.PSPModule(C, 16)),
    "aspp": (lambda: jheads.ASPP(depth=16, dtype=jnp.float32),
             lambda: theads.ASPP(C, 16)),
    "sphead": (lambda: jheads.SPHead(out_features=8, dtype=jnp.float32),
               lambda: theads.SPHead(C, 8)),
    "sphead_nobias": (lambda: jheads.SPHead(out_features=8, bias=False,
                                            dtype=jnp.float32),
                      lambda: theads.SPHead(C, 8, bias=False)),
    "pmsf": (lambda: jheads.PMSF(out_features=16, dtype=jnp.float32),
             lambda: theads.PMSF(C, 16)),
}


def _image() -> np.ndarray:
    return np.random.default_rng(1).normal(0, 1, (BATCH, SIZE, SIZE, C)
                                           ).astype(np.float32)


@pytest.fixture(scope="module")
def refs():
    """name -> (variables, x, JAX eval out, train out, new batch_stats,
    XLA's FLOP count of the program)."""
    out = {}
    x = _image()
    for name, (make_jax, _) in HEADS.items():
        jm = make_jax()
        shapes = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, C)),
            train=False))
        variables = random_variables(shapes, seed=0)

        def both(v, x, jm=jm):
            ev = jm.apply(v, x, train=False)
            tr, new = jm.apply(v, x, train=True, mutable=["batch_stats"])
            return ev, tr, new

        with jax.default_matmul_precision("highest"):
            compiled = jax.jit(both).lower(variables, jnp.asarray(x)
                                           ).compile()
        ev, tr, new = compiled(variables, jnp.asarray(x))
        cost = compiled.cost_analysis()
        cost = cost[0] if isinstance(cost, list) else cost
        out[name] = (variables, x, np.asarray(ev), np.asarray(tr),
                     jax.tree.map(np.asarray, new["batch_stats"]),
                     float(cost["flops"]))
    return out


def _port(name, variables, train: bool):
    head = HEADS[name][1]()
    convert.load_jax_variables(head, variables)
    return head.train(train)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _close(got: torch.Tensor, ref: np.ndarray) -> float:
    got = got.detach().permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("name", sorted(HEADS))
def test_head_eval_matches_jax(refs, name):
    variables, x, ev, _, _, _ = refs[name]
    with torch.no_grad():
        got = _port(name, variables, train=False)(_nchw(x))
    assert _close(got, ev) <= RTOL


@pytest.mark.parametrize("name", sorted(HEADS))
def test_head_train_step_and_running_stats_match_jax(refs, name):
    """Train mode: the output and every BN's running mean and variance
    after the step (ASPP's shared BN after its five updates)."""
    variables, x, _, tr, stats, _ = refs[name]
    head = _port(name, variables, train=True)
    before = copy.deepcopy(head.state_dict())
    with torch.no_grad():
        got = head(_nchw(x))
    assert _close(got, tr) <= RTOL
    state = head.state_dict()
    leaves = flatten_dict(stats)
    assert leaves
    for path, ref in leaves.items():
        key = convert.torch_key("batch_stats", path)
        assert not torch.equal(state[key], before[key]), key
        err = np.abs(state[key].numpy() - ref).max() / np.abs(ref).max()
        assert err <= RTOL, (key, err)
    if name == "aspp":  # five updates of one BN: one counter, five steps
        assert int(state["BatchNorm_0.num_batches_tracked"]) == 5


def test_bridge_names_map_every_head_leaf(refs):
    """Every flax leaf of every head has its port key, and the port's
    state holds no key the tree does not fill."""
    for name in HEADS:
        variables = refs[name][0]
        keys = {convert.torch_key(col, path)
                for col in variables
                for path in flatten_dict(variables[col])}
        state = HEADS[name][1]().state_dict()
        assert keys == {k for k in state
                        if not k.endswith("num_batches_tracked")}, name


@pytest.mark.parametrize("hw,out", [
    ((24, 24), (20, 20)), ((24, 24), (12, 12)), ((24, 24), (1, 24)),
    ((24, 24), (24, 1)), ((13, 17), (5, 3)), ((7, 5), (20, 12)),
    ((10, 10), (6, 6)), ((9, 11), (2, 3))])
def test_adaptive_avg_pool_matches_jax(hw, out):
    """``F.adaptive_avg_pool2d`` against npp_tpu's matrix-product
    ``adaptive_avg_pool``, most sizes not dividing evenly."""
    x = np.random.default_rng(2).normal(0, 1, (2,) + hw + (3,)).astype(
        np.float32)
    ref = np.asarray(jpool.adaptive_avg_pool(jnp.asarray(x), out))
    got = torch.nn.functional.adaptive_avg_pool2d(_nchw(x), out)
    assert _close(got, ref) <= 1e-6


def test_global_mean_matches_jax_global_avg_pool():
    x = _image()
    ref = np.asarray(jpool.global_avg_pool(jnp.asarray(x)))
    assert _close(_nchw(x).mean(dim=(2, 3), keepdim=True), ref) <= 1e-6


def test_count_parameters_matches_jax_exactly(refs):
    """The tiny NPPNet (L=8, C=8, 20 classes, 16 joints, one refine
    layer): npp_tpu counts its ``params`` tree (shapes by
    ``jax.eval_shape``), the port its parameters; and the heads."""
    tiny = dict(num_classes=20, num_joints=16, layers=8, init_channels=8,
                refine_layers=1)
    jm = JNPPNet(dtype=jnp.float32, **tiny)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    tm = build_nppnet(device="cpu", generator=torch.Generator().manual_seed(0),
                      dtype=torch.float32, **tiny)
    assert (tsummary.count_parameters(tm)
            == jsummary.count_parameters(shapes["params"]) == 1_107_146)
    assert (tsummary.count_parameters_in_mb(tm)
            == jsummary.count_parameters_in_mb(shapes["params"]))
    for name, (_, make_port) in HEADS.items():
        assert (tsummary.count_parameters(make_port())
                == jsummary.count_parameters(refs[name][0]["params"])), name


def test_model_flops_exact_on_a_matrix_product():
    a = np.random.default_rng(3).normal(0, 1, (64, 64)).astype(np.float32)
    want = 2 * 64 ** 3
    assert jsummary.model_flops(lambda p, q: p @ q, jnp.asarray(a),
                                jnp.asarray(a)) == want
    t = torch.from_numpy(a)
    assert tsummary.model_flops(torch.matmul, t, t) == want


def test_model_flops_on_a_head_within_the_stated_bound(refs):
    """PSPModule's eval and train forward in one call, as the JAX program
    runs them: the ratio the module docstring explains, within 3%."""
    variables, x, _, _, _, xla = refs["psp"]
    head = _port("psp", variables, train=False)

    def both(inp):
        head.eval()
        a = head(inp)
        head.train()
        return a, head(inp)

    with torch.no_grad():
        ours = tsummary.model_flops(both, _nchw(x))
    assert ours == 53_186_560
    assert abs(ours / xla - 1) <= PSP_FLOP_RATIO, ours / xla


def test_get_model_summary_keys_and_mode():
    head = theads.PMSF(C, 16).train()
    got = tsummary.get_model_summary(head, _nchw(_image()))
    assert set(got) == {"params", "params_mb", "flops", "gflops",
                        "input_shape"}
    assert got["params"] == tsummary.count_parameters(head)
    assert got["gflops"] == got["flops"] / 1e9 > 0
    assert got["input_shape"] == (BATCH, C, SIZE, SIZE)
    assert head.training  # the caller's mode is restored
