"""The port's fused serving layouts against npp_tpu on the CPU: the
sibling groups, the neck and sibling-cell state transforms, and the
fused NPPNet forward.

The model is a tiny NPPNet (L=4, C=8, 20 classes, 16 joints) at 64x64,
its flax tree filled from a numpy RNG and carried into the port through
the weight bridge (as tests/test_torch_model.py). Two JAX programs are
compiled, once each, in a module-scoped fixture: npp_tpu's fused eval
forward with the default sibling families and with all of them.
Tolerances:

- the groups, the state transforms and their round trips: exact;
- the fused eval forward against npp_tpu's fused eval forward: atol 2e-4,
  npp_tpu's own bound for its fused forward against its unfused one
  (tests/test_model.py: a K-wide fp32 CPU conv sums in another order
  than K narrow ones; a wrong group or slot errs at O(0.1));
- the fused forward against the port's own unfused model, in float64,
  in eval and in train mode (outputs, and the running statistics after
  the step mapped through the transform): 1e-10. Train mode is not
  compared with npp_tpu: npp_tpu's own fused-against-unfused check in
  train mode (``test_fused_cells_exact``) misses its 5e-4 in fp32 on the
  CPU (9 of 3,584 elements, up to 8.64e-4): train-mode BN divides by
  the batch's deviation and magnifies the fp32 CPU conv noise, which is
  not a fault of the layout. float64 holds the layout itself.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from npp_tpu import genotypes as jgt
from npp_tpu.models import cells as jcells
from npp_tpu.models.augment import NPPNet as JNPPNet
from npp_tpu.models.augment import (fuse_neck_variables,
                                    fuse_sibling_variables)

from npp_tpu_torch import genotypes as tgt
from npp_tpu_torch.core import predictor as tpred
from npp_tpu_torch.models import cells as tcells
from npp_tpu_torch.models.augment import (build_nppnet, cell_specs,
                                          fuse_neck_state,
                                          fuse_sibling_state, fused_twin,
                                          unfuse_neck_state,
                                          unfuse_sibling_state)
from npp_tpu_torch.ops.primitives import OPS
from npp_tpu_torch.parallel import tensor
from npp_tpu_torch.utils import convert

from test_torch_ops import random_variables

torch.set_num_threads(1)
TINY = dict(num_classes=20, num_joints=16, layers=4, init_channels=8,
            refine_layers=1)
SIZE, BATCH = 64, 2
FAMILIES = {"default": tcells.DEFAULT_SIBLING_FAMILIES,
            "all": tcells.ALL_SIBLING_FAMILIES}
JAX_ATOL = 2e-4
F64_ATOL = 1e-10


def _flat(out):
    return [t for stage in out for pair in stage for t in pair]


@pytest.fixture(scope="module")
def bundle():
    """(flax model, numpy variables, port model with the same weights in
    float32, the input batch)."""
    jm = JNPPNet(dtype=jnp.float32, **TINY)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    variables = random_variables(shapes, seed=0)
    tm = build_nppnet(device="cpu", generator=torch.Generator().manual_seed(0),
                      dtype=torch.float32, **TINY)
    convert.load_jax_variables(tm, variables)
    x = np.random.default_rng(1).normal(0, 1, (BATCH, SIZE, SIZE, 3)).astype(
        np.float32)
    return jm, variables, tm, x


@pytest.fixture(scope="module")
def jax_fused(bundle):
    """Per family set: (npp_tpu's fused variable tree, its fused eval
    forward's outputs)."""
    jm, variables, _, x = bundle
    out = {}
    for name, fams in FAMILIES.items():
        std = jm.clone(sibling_families=fams)
        fused = std.clone(fused_necks=True, fused_cells=True)
        tree = fuse_sibling_variables(fuse_neck_variables(variables), std)
        ref = jax.jit(lambda v, x, m=fused: m.apply(v, x, train=False))(
            tree, jnp.asarray(x))
        out[name] = (tree, [np.asarray(r) for r in _flat(ref)])
    return out


def _port(tm, families, dtype=torch.float32):
    """The port's unfused model with ``families``, in ``dtype``."""
    std = build_nppnet(device="cpu", generator=torch.Generator(),
                       dtype=torch.float32, sibling_families=families,
                       **TINY)
    std.load_state_dict(tm.state_dict())
    return std.to(dtype)


# -- the groups ----------------------------------------------------------------

_CELLS = {"encoder_normal": ("ENCODER", "normal", False),
          "encoder_reduce": ("ENCODER", "reduce", True),
          "upsample1": ("DECODER", "upsample1", False),
          "upsample2": ("DECODER", "upsample2", False),
          "fusion_pose": ("FUSION", "pose", False),
          "fusion_par": ("FUSION", "par", False)}


@pytest.mark.parametrize("families", FAMILIES)
@pytest.mark.parametrize("cell", _CELLS)
def test_sibling_groups_match_jax_on_released_cells(cell, families):
    geno, field, red = _CELLS[cell]
    edges = getattr(getattr(tgt, geno), field)
    assert edges == getattr(getattr(jgt, geno), field)
    ours = tcells.sibling_groups(edges, red, FAMILIES[families])
    assert ours == jcells.sibling_groups(edges, red, FAMILIES[families])
    if cell in ("encoder_normal", "upsample1"):
        assert ours  # the released genotypes do group


@pytest.mark.parametrize("families", FAMILIES)
def test_sibling_groups_match_jax_on_random_genotypes(families):
    """Ops drawn from the mergeable families and two others, inputs from
    the first states, so that groups are common."""
    rng = np.random.default_rng(7)
    names = list(tcells.ALL_SIBLING_FAMILIES) + ["skip_connect",
                                                 "max_pool_3x3"]
    assert set(names) <= set(OPS)
    n_groups = 0
    for _ in range(200):
        steps, n_in = int(rng.integers(2, 6)), int(rng.integers(2, 4))
        edges = tuple((names[rng.integers(len(names))],
                       int(rng.integers(0, min(n_in + k, 3))))
                      for k in range(steps) for _ in range(2))
        red = bool(rng.integers(2))
        ours = tcells.sibling_groups(edges, red, FAMILIES[families])
        assert ours == jcells.sibling_groups(edges, red, FAMILIES[families])
        n_groups += len(ours)
    assert n_groups > 30


# -- the state transforms ------------------------------------------------------

def _stats_state(tm, seed):
    """``tm``'s state with random running statistics and batch counters."""
    rng = np.random.default_rng(seed)
    state = {k: v.clone() for k, v in tm.state_dict().items()}
    for k, v in state.items():
        if k.endswith("running_mean"):
            v.copy_(torch.from_numpy(rng.normal(0, 0.1, v.shape)))
        elif k.endswith("running_var"):
            v.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, v.shape)))
        elif k.endswith("num_batches_tracked"):
            v.fill_(3)
    return state


@pytest.mark.parametrize("families", FAMILIES)
def test_state_round_trips_are_exact(bundle, families):
    std = _port(bundle[2], FAMILIES[families])
    state = _stats_state(std, 2)
    fused = fuse_sibling_state(fuse_neck_state(state), std)
    assert any(".sib." in k for k in fused)
    assert {"neck1.Conv_0.weight", "neck2.BatchNorm_0.running_var"} <= set(
        fused)
    back = unfuse_neck_state(unfuse_sibling_state(fused, std))
    assert set(back) == set(state)
    for k, v in state.items():
        assert torch.equal(back[k], v), k
    # The twin holds the transformed state, and back again.
    std.load_state_dict(state)
    twin = fused_twin(std, fused_necks=True, fused_cells=True)
    assert set(twin.state_dict()) == set(fused)
    again = fused_twin(twin, fused_necks=False, fused_cells=False)
    for k, v in again.state_dict().items():
        assert torch.equal(v, state[k]), k


@pytest.mark.parametrize("families", FAMILIES)
def test_fused_state_equals_jax_fused_tree(bundle, jax_fused, families):
    """npp_tpu's fused tree through the bridge = the port's transform of
    the unfused state, leaf by leaf."""
    std = _port(bundle[2], FAMILIES[families])
    twin = fused_twin(std, fused_necks=True, fused_cells=True)
    fresh = build_nppnet(device="cpu", generator=torch.Generator(),
                         dtype=torch.float32, fused_necks=True,
                         fused_cells=True, sibling_families=FAMILIES[families],
                         **TINY)
    tree = jax_fused[families][0]
    convert.load_jax_variables(fresh, tree)
    n_sib = sum(1 for k in flatten_dict(tree["params"]) if "sib_0" in k)
    assert n_sib > 0
    got, want = fresh.state_dict(), twin.state_dict()
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], v), k


# -- the fused forward ---------------------------------------------------------

@pytest.mark.parametrize("families", FAMILIES)
def test_fused_eval_forward_matches_jax(bundle, jax_fused, families):
    _, _, tm, x = bundle
    twin = fused_twin(_port(tm, FAMILIES[families]), fused_necks=True,
                      fused_cells=True).eval()
    with torch.no_grad():
        ours = _flat(twin(torch.from_numpy(x).permute(0, 3, 1, 2)))
    ref = jax_fused[families][1]
    assert len(ours) == len(ref) == 8
    for o, r in zip(ours, ref):
        got = o.permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, r, rtol=0, atol=JAX_ATOL)


def _to_layout(state, std, fused):
    """``std``'s ``state`` in ``fused``'s layout."""
    if fused.fused_necks:
        state = fuse_neck_state(state)
    return fuse_sibling_state(state, std) if fused.fused_cells else state


def _train_gap(std, fused, x, state):
    """Max |diff| of the train-mode outputs of ``std`` and ``fused`` from
    ``state``, and of their running statistics after the step (the
    unfused ones mapped through the transform)."""
    std.load_state_dict(state)
    fused.load_state_dict(_to_layout(state, std, fused))
    with torch.no_grad():
        a, b = _flat(std.train()(x)), _flat(fused.train()(x))
    gap = max((p - q).abs().max().item() for p, q in zip(a, b))
    mapped, got = _to_layout(std.state_dict(), std, fused), fused.state_dict()
    stats = max((mapped[k] - got[k]).abs().max().item() for k in got
                if "running" in k)
    return gap, stats


@pytest.mark.parametrize("layout", ("necks", "cells", "both_default",
                                    "both_all"))
def test_fused_forward_matches_unfused_in_float64(bundle, layout):
    _, _, tm, x = bundle
    fams = FAMILIES["all" if layout == "both_all" else "default"]
    std = _port(tm, fams, torch.float64)
    std.load_state_dict(_stats_state(std, 3))
    twin = fused_twin(std, fused_necks=layout != "cells",
                      fused_cells=layout != "necks")
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).double()
    with torch.no_grad():
        a, b = _flat(std.eval()(xt)), _flat(twin.eval()(xt))
    assert max((p - q).abs().max().item() for p, q in zip(a, b)) <= F64_ATOL
    gap, stats = _train_gap(std, twin, xt, _stats_state(std, 3))
    assert gap <= F64_ATOL and stats <= F64_ATOL, (gap, stats)


def test_swapped_slots_fail_the_comparison(bundle):
    """Negative control: a fused cell whose group hands two of its edges
    each other's slices must miss the float64 comparison."""
    _, _, tm, x = bundle
    std = _port(tm, FAMILIES["default"], torch.float64)
    twin = fused_twin(std, fused_necks=True, fused_cells=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).double()
    cell = twin.cells1[0]
    first, second = [e for e in sorted(cell._slot) if cell._slot[e][0] == 0][:2]
    cell._slot = {**cell._slot, first: cell._slot[second],
                  second: cell._slot[first]}
    gap, _ = _train_gap(std, twin, xt, _stats_state(std, 4))
    assert gap > 1e-3


def test_cell_specs_name_every_genotype_cell(bundle):
    std = _port(bundle[2], FAMILIES["default"])
    specs = cell_specs(std)
    assert len(specs) == 2 * TINY["layers"] + 6 + 6
    state = std.state_dict()
    assert all(any(k.startswith(name + ".ops.") for k in state)
               for name in specs)


# -- refusals ------------------------------------------------------------------

class _Grid:
    """The attributes a grid's refusals read, without a process group."""

    def __init__(self, n_data=1, n_space=1, n_model=1):
        self.n_data, self.n_space, self.n_model = n_data, n_space, n_model


def test_mesh_refuses_fused_cells_on_a_space_axis(bundle):
    """The fused cells serve on a space axis of a data x space grid
    (``tests/test_torch_spatial.py``); a grid with a model axis, space
    axis or not, is refused before any layout is built: npp_tpu has no
    such serving path."""
    tm = bundle[2]
    with pytest.raises(ValueError, match="n_model > 1"):
        tpred.Predictor(tm, crop_size=(SIZE, SIZE),
                        mesh=_Grid(n_space=2, n_model=2), fuse_cells=True)


def test_grid_conversions_refuse_fused_layouts(bundle):
    """Tensor parallelism refuses both fused layouts; the space axis takes
    them (``tests/test_torch_spatial.py``)."""
    twin = fused_twin(bundle[2], fused_necks=True, fused_cells=True)
    with pytest.raises(ValueError, match="fused serving layout"):
        tensor.convert_tensor_parallel(twin, _Grid(n_model=2))
    necks = fused_twin(bundle[2], fused_necks=True, fused_cells=False)
    with pytest.raises(ValueError, match="fused serving layout"):
        tensor.convert_tensor_parallel(necks, _Grid(n_model=2))
