"""The port's primitive ops and resizes against npp_tpu's on the CPU.

Each released primitive, at each stride the genotypes use it with, runs
the same seeded numpy input through the flax module and the port's
module with the same weights (carried over by the port's weight bridge),
in fp32, NHWC <-> NCHW at compare. Tolerance: max abs diff <= 1e-4 x
max|ref| (fp32 convs summed in another order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from npp_tpu.ops import primitives as jprim
from npp_tpu.ops import resize as jresize

from npp_tpu_torch.ops import primitives as tprim
from npp_tpu_torch.ops import resize as tresize
from npp_tpu_torch.utils.convert import load_jax_variables

torch.set_num_threads(1)
RTOL_MAX = 1e-4
C = 8


def random_variables(shapes, seed):
    """Fill a flax variable tree of ShapeDtypeStructs from a numpy RNG:
    kernels ~ N(0, 1/fan_in), BN scale and running var in [0.5, 1.5],
    biases and running means ~ N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1]
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return rng.normal(0.0, 0.1, s.shape).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.normal(0.0, 1.0, s.shape) / np.sqrt(fan_in)).astype(
            np.float32)

    return {col: unflatten_dict({k: leaf(k, v) for k, v in
                                 flatten_dict(shapes[col]).items()})
            for col in shapes}


def assert_close(ours: torch.Tensor, ref, rel=RTOL_MAX):
    ref = np.asarray(ref)
    got = ours.detach().permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-12)
    assert float(np.abs(got - ref).max()) <= rel * scale


# (op name, stride) as the released genotypes use them, plus the ops the
# cells build directly.
CASES = [
    ("std_conv_3x3", 1), ("std_conv_3x3", 2), ("std_conv_1x1", 1),
    ("dil_conv_3x3_2", 1), ("dil_conv_3x3_2", 2), ("dil_conv_3x3_4", 1),
    ("se_connect", 1), ("se_connect", 2), ("max_pool_3x3", 1),
    ("max_pool_3x3", 2), ("poled_conv_x1", 1), ("skip_connect", 1),
    ("skip_connect", 2), ("none", 1), ("none", 2),
]


@pytest.mark.parametrize("name,stride", CASES)
def test_primitive_matches_flax(name, stride):
    x = np.random.default_rng(1).normal(0, 1, (2, 12, 10, C)).astype(
        np.float32)
    fmod = jprim.make_op(name, C, stride, True, jnp.float32)
    shapes = jax.eval_shape(lambda: fmod.init(jax.random.PRNGKey(0),
                                              jnp.asarray(x), train=False))
    variables = random_variables(shapes, seed=len(name) + stride)
    ref = fmod.apply(variables, jnp.asarray(x), train=False)
    tmod = tprim.make_op(name, C, stride).eval()
    load_jax_variables(tmod, variables)
    with torch.no_grad():
        ours = tmod(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert_close(ours, ref)


def test_factorized_reduce_train_mode_matches_flax():
    """Batch statistics and the running-stat update (unbiased var) too."""
    x = np.random.default_rng(2).normal(0, 1, (2, 12, 10, 16)).astype(
        np.float32)
    fmod = jprim.FactorizedReduce(C, True, jnp.float32)
    shapes = jax.eval_shape(lambda: fmod.init(jax.random.PRNGKey(0),
                                              jnp.asarray(x), train=False))
    variables = random_variables(shapes, seed=3)
    ref, upd = fmod.apply(variables, jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
    tmod = tprim.FactorizedReduce(16, C).train()
    load_jax_variables(tmod, variables)
    with torch.no_grad():
        ours = tmod(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert_close(ours, ref)
    stats = upd["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(tmod.BatchNorm_0.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tmod.BatchNorm_0.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-5)


def test_unported_op_raises():
    """Every op of the reference table is ported; a name outside it
    raises."""
    assert set(tprim.OPS) == set(jprim.OPS)
    with pytest.raises(KeyError, match="unknown op"):
        tprim.make_op("sep_conv_9x9", C, 1)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("in_hw,out_hw", [((7, 9), (14, 18)),
                                          ((5, 6), (11, 13)),
                                          ((16, 12), (8, 6))])
def test_resize_bilinear_matches_jax(align_corners, in_hw, out_hw):
    x = np.random.default_rng(4).normal(0, 1, (2,) + in_hw + (3,)).astype(
        np.float32)
    ref = jresize.resize_bilinear(jnp.asarray(x), out_hw,
                                  align_corners=align_corners)
    ours = tresize.resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2),
                                   out_hw, align_corners=align_corners)
    assert_close(ours, ref, rel=1e-5)


@pytest.mark.parametrize("scale", [0.5, 0.25, 2.0, 4.0])
def test_resize_scale_matches_jax(scale):
    """Explicit floor(in * scale) sizes, including odd inputs at 0.5x."""
    x = np.random.default_rng(5).normal(0, 1, (1, 13, 10, 4)).astype(
        np.float32)
    ref = jresize.resize_scale(jnp.asarray(x), scale, align_corners=True)
    ours = tresize.resize_scale(torch.from_numpy(x).permute(0, 3, 1, 2),
                                scale, align_corners=True)
    assert_close(ours, ref, rel=1e-5)


def test_resize_nearest_matches_jax():
    x = np.random.default_rng(6).normal(0, 1, (1, 7, 5, 2)).astype(np.float32)
    ref = jresize.resize_nearest(jnp.asarray(x), (16, 11))
    ours = tresize.resize_nearest(torch.from_numpy(x).permute(0, 3, 1, 2),
                                  (16, 11))
    np.testing.assert_array_equal(ours.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(ref))
