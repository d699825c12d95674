"""The activation quantize's launch plan and the ReLU folded into it, on
the CPU.

- ``quantize._quant_plan`` at every dense-conv input of the flagship's
  int8 forwards (bs1 and bs8) and over a seeded grid: the blocks' slices
  partition the input, every element is kept on chip or read again
  exactly once, the shared memory fits a block, the grid fits the card
  (a cooperative grid must be co-resident), tiny inputs take one block;
  a static scale takes the plain grid-stride loop.
- ``relu_conv``: on a plain conv it is ``conv(F.relu(x))``, bit for bit;
  the fp forward of the tiny NPPNet (unfused and fused layouts) runs the
  same operations in the same order as the forward before the fold (each
  changed module's forward as it was, kept below) and gives the same
  bits.
- The int8 forward with the ReLU folded into the quantize equals the
  route before it (``conv(F.relu(x))`` through the plain int8 conv) bit
  for bit, with dynamic and with calibrated scales, and ``calibrate_acts``
  gives the same scales; no int8 conv reads an ``F.relu`` output it could
  fold.
- The folded int8 forward against npp_tpu's int8 forward (one module
  JAX program, dynamic scales) within ``tests/test_torch_int8.py``'s
  tolerance: a 1e-7 fp32 difference that crosses a rounding midpoint of
  the int8 grid moves a value one step, and that propagates, so each map
  agrees to INT8_MAP_RTOL of its largest value.

The kernel itself runs on the card only: ``chip_smoke.py`` phase 20a
holds it bit for bit against ``quantize_act_reference`` there.
"""
import copy

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from npp_tpu.models.augment import NPPNet as JNPPNet
from npp_tpu.ops import quantize as jq

from npp_tpu_torch.models import augment as taug
from npp_tpu_torch.models import cells as tcells
from npp_tpu_torch.models.augment import build_nppnet, fused_twin
from npp_tpu_torch.ops.heatmaps import SMEM_PER_SM, SMEM_RESERVED
from npp_tpu_torch.ops import primitives as tprim
from npp_tpu_torch.ops import quantize as tq
from npp_tpu_torch.utils import convert

from test_torch_int8_plan import BATCH, FLAGSHIP_CLASSES, SMS
from test_torch_ops import random_variables

torch.set_num_threads(1)
TINY = dict(num_classes=20, num_joints=16, layers=4, init_channels=8,
            refine_layers=1)
CROP, N_IMAGES = 64, 2
INT8_MAP_RTOL = 0.05  # tests/test_torch_int8.py's
# The convs that read a ReLU's output with other readers (stem1's and
# stem4's, cell states too): the ReLU cannot fold into their quantize.
SHARED_RELU_CONVS = {"stem2.Conv_0", "stem5.Conv_0"}
SM_THREADS = 2048  # resident threads of a Hopper SM, at most


# -- the launch plan ----------------------------------------------------------

def _input_shapes():
    """The distinct (C, H, W, element bytes) of the flagship classes'
    inputs: bf16, or float32 where the conv's output is (the heads' last
    convs run with autocast off on a float32 cast)."""
    return sorted({(cin, h, w, 2 if dt == "bfloat16" else 4)
                   for cin, h, w, *_, dt in FLAGSHIP_CLASSES})


def _resident_blocks(threads: int, smem_bytes: int) -> int:
    """Blocks of ``threads`` threads and ``smem_bytes`` of dynamic shared
    memory that one SM holds at once (registers permitting: the kernels'
    launch bounds keep them within)."""
    return min(SM_THREADS // threads,
               SMEM_PER_SM // (smem_bytes + SMEM_RESERVED))


def _check_quant_plan(plan, numel, elem, layout, dynamic, sms=SMS):
    assert plan.numel == numel and plan.elem_size == elem
    assert plan.grid >= 1
    resident = _resident_blocks(plan.threads, plan.smem_bytes)
    assert resident >= 1
    assert plan.grid <= sms * resident or not plan.cooperative
    assert plan.cooperative == (dynamic and plan.grid > 1)
    if layout == "nchw":
        assert plan.variant == ("nchw" if dynamic else "nchw_static")
        assert plan.smem_bytes == plan.stash_chunks == plan.ring == 0
        assert plan.reread == (numel if dynamic else 0)
        if dynamic:
            assert plan.grid <= sms and plan.threads == tq.QUANT_THREADS
        return
    nbytes = numel * elem
    if not dynamic:  # the grid-stride loop: every vector, read once
        assert plan.variant == "flat" and plan.threads == tq.LOOP_THREADS
        assert plan.smem_bytes == plan.stash_chunks == plan.ring == 0
        assert plan.reread == 0 and plan.grid <= tq.QUANT_BLOCKS
        per_sweep = plan.grid * tq.LOOP_THREADS * tq.QUANT_PAIR * 16
        assert plan.grid == tq.QUANT_BLOCKS or per_sweep >= nbytes
        assert plan.grid == 1 or per_sweep < nbytes + (
            tq.LOOP_THREADS * tq.QUANT_PAIR * 16)
        return
    # the slices partition the whole units in order; the tail (< 16
    # elements) is the last block's
    bounds = [plan.block_slice(b) for b in range(plan.grid)]
    assert bounds[0][0] == 0
    assert bounds[-1][1] == numel // tq.QUANT_UNIT * tq.QUANT_UNIT
    assert numel - bounds[-1][1] < tq.QUANT_UNIT
    for (_, end), (begin, _) in zip(bounds, bounds[1:]):
        assert end == begin
    for begin, end in bounds:
        assert begin % tq.QUANT_UNIT == 0 and end >= begin
        # at least one 16-byte piece of x and of q: the bulk copies' rule
        assert (end - begin) * elem % 16 == 0 and (end - begin) % 16 == 0
    if nbytes > tq.QUANT_UNIT * elem * plan.grid:
        assert all(end > begin for begin, end in bounds)
    # shared memory within what a block may use, as the kernel lays it out
    assert plan.smem_bytes == tq._quant_smem(plan.stash_chunks, plan.ring)
    assert plan.smem_bytes <= tq.SMEM_BLOCK_LIMIT
    assert 0 <= plan.stash_chunks <= tq.QUANT_MAX_STASH
    assert plan.threads == tq.QUANT_THREADS
    tiny = nbytes <= tq.TINY_QUANT_BYTES
    body = numel // tq.QUANT_UNIT * tq.QUANT_UNIT * elem
    assert plan.grid == (1 if tiny else
                         min(sms, -(-body // tq.QUANT_MIN_SLICE)))
    widest = max(end - begin for begin, end in bounds) * elem
    if plan.ring == 0:  # every slice whole on chip
        assert all(plan.stashed(b) == end - begin
                   for b, (begin, end) in enumerate(bounds))
    else:  # the stash as large as fits beside the ring
        assert plan.ring == tq.QUANT_RING
        assert (plan.stash_chunks + plan.ring) * tq.QUANT_CHUNK <= (
            tq.QUANT_MAX_STASH * tq.QUANT_CHUNK)
        assert plan.stash_chunks + plan.ring == tq.QUANT_MAX_STASH
        assert widest > tq.QUANT_MAX_STASH * tq.QUANT_CHUNK
    assert plan.variant == ("tiny" if plan.grid == 1 else "cooperative")
    # every element kept on chip or read again, exactly once
    stashed = sum(plan.stashed(b) for b in range(plan.grid))
    assert stashed + plan.reread == numel
    assert (plan.reread == numel % tq.QUANT_UNIT) == (plan.ring == 0)


@pytest.mark.parametrize("n", (1, BATCH))
@pytest.mark.parametrize("shape", _input_shapes(),
                         ids=lambda s: "x".join(map(str, s)))
def test_quant_plan_at_the_flagship_inputs(shape, n):
    c, h, w, elem = shape
    numel = n * c * h * w
    for layout in ("channels_last", "nchw"):
        for dynamic in (True, False):
            plan = tq._quant_plan(numel, elem, layout, dynamic, sms=SMS)
            _check_quant_plan(plan, numel, elem, layout, dynamic)


def test_quant_plan_keeps_the_128_channel_level_on_chip():
    """bs8, bf16: the 3x3 128->128 input at 96x96 (18.9 MB) is held whole
    on chip and read once; the neck's 1,024 channels (151 MB) stream the
    rest of each slice through the ring; the SE inputs take one block."""
    plan = tq._quant_plan(BATCH * 128 * 96 * 96, 2, "channels_last", True)
    assert (plan.variant, plan.grid, plan.ring, plan.reread) == (
        "cooperative", SMS, 0, 0)
    neck = tq._quant_plan(BATCH * 1024 * 96 * 96, 2, "channels_last", True)
    assert neck.ring == tq.QUANT_RING and neck.stash_chunks == 10
    assert neck.reread == neck.numel - SMS * 10 * tq.QUANT_CHUNK // 2
    for c in (16, 32, 64, 128, 256, 512, 1024):
        se = tq._quant_plan(BATCH * c, 2, "channels_last", True)
        assert (se.variant, se.grid) == ("tiny", 1)
    static = tq._quant_plan(BATCH * 128 * 96 * 96, 2, "channels_last",
                            False)
    assert (static.variant, static.grid, static.smem_bytes) == (
        "flat", 2304, 0)


@pytest.mark.parametrize("seed", range(8))
def test_quant_plan_over_a_seeded_grid(seed):
    rng = np.random.default_rng(seed)
    for _ in range(60):
        numel = int(rng.choice([1, 7, 15, 16, 17, 255, 4096, 8193]) *
                    rng.integers(1, 5000))
        elem = int(rng.choice([2, 4]))
        sms = int(rng.choice([132, 114, 78, 1]))
        for layout in ("channels_last", "nchw"):
            for dynamic in (True, False):
                plan = tq._quant_plan(numel, elem, layout, dynamic, sms=sms)
                _check_quant_plan(plan, numel, elem, layout, dynamic,
                                  sms=sms)


# -- the modules' forwards before the fold --------------------------------------

def _relu_conv_bn(self, x):
    return self.BatchNorm_0(self.Conv_0(F.relu(x)))


def _se(self, x):
    w = x.mean(dim=(2, 3), keepdim=True)
    w = torch.sigmoid(self.Conv_1(F.relu(self.Conv_0(w))))
    out = x * w
    if self.stride == 1:
        return out
    return self.BatchNorm_0(F.avg_pool2d(out, 2, 2))


def _factorized_reduce(self, x):
    x = F.relu(x)
    c0, c1 = self.Conv_0, self.Conv_1
    y0 = c0._conv_forward(x, c0.weight, c0.bias)
    y1 = c1._conv_forward(x[:, :, 1:, 1:], c1.weight, c1.bias)
    return self.BatchNorm_0(torch.cat([y0, y1], dim=1))


def _fac_conv(self, x):
    return self.BatchNorm_0(self.Conv_1(self.Conv_0(F.relu(x))))


def _pooled_conv(self, x):
    x = F.avg_pool2d(x, 2, 2)
    for i in range(self.conv_nums):
        x = getattr(self, f"Conv_{i}")(F.relu(x))
        x = getattr(self, f"BatchNorm_{i}")(x)
    x = tprim.resize_scale(x, 2.0, align_corners=True)
    if self.conv_nums == 2 and self.stride == 2:
        x = tprim.resize_scale(x, 2.0, align_corners=True)
    return x


def _sibling_se(self, x):
    c = x.shape[1]
    w = x.mean(dim=(2, 3), keepdim=True)
    w = torch.sigmoid(self.Conv_1(F.relu(self.Conv_0(w))))
    out = torch.cat([x * w[:, i * c:(i + 1) * c] for i in range(self.k)],
                    dim=1)
    if self.stride == 1:
        return out
    return self.BatchNorm_0(F.avg_pool2d(out, 2, 2))


def _stem(self, x):
    x = self.BatchNorm_0(self.Conv_0(x))
    return F.relu(x) if self.final_relu else x


def _head(self, x):
    x = F.relu(self.BatchNorm_0(self.Conv_0(F.relu(x))))
    with torch.autocast(device_type=x.device.type, enabled=False):
        y = self.Conv_1(x.to(self.Conv_1.weight.dtype))
    return y


_BEFORE = {tprim.ReLUConvBN: _relu_conv_bn, tprim.SEBlock: _se,
           tprim.FactorizedReduce: _factorized_reduce,
           tprim.FacConv: _fac_conv, tprim.PooledConv: _pooled_conv,
           tcells.SiblingConvGroup: _relu_conv_bn,
           tcells.SiblingSEGroup: _sibling_se, taug._Neck: _relu_conv_bn,
           taug._Stem: _stem, taug._Head: _head}


def _as_before(model):
    """``model`` (a copy) with each changed module's forward as it was
    before the fold: the ReLU where it stood, stem0 and stem3 ending in
    theirs."""
    model = copy.deepcopy(model)
    for m in model.modules():
        if type(m) in _BEFORE:
            m.forward = _BEFORE[type(m)].__get__(m)
    for first, second in (("stem0", "stem1"), ("stem3", "stem4")):
        getattr(model, first).final_relu = True
        getattr(model, second).relu_input = False
    return model


class _OpLog(torch.overrides.TorchFunctionMode):
    """The torch functions a forward calls, in order."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.names.append(getattr(func, "__name__", str(func)))
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def models():
    """(unfused, fused) tiny NPPNets with weights from a numpy RNG, and a
    batch of images."""
    jm = JNPPNet(dtype=jnp.float32, **TINY)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, CROP, CROP, 3)), train=False))
    variables = random_variables(shapes, seed=7)
    tm = build_nppnet(device="cpu", generator=torch.Generator().manual_seed(0),
                      dtype=torch.float32, **TINY)
    convert.load_jax_variables(tm, variables)
    fused = fused_twin(tm, fused_necks=True, fused_cells=True)
    x = np.random.default_rng(8).normal(0, 1, (N_IMAGES, CROP, CROP, 3))
    return dict(unfused=tm, fused=fused, jax=(jm, variables),
                x=x.astype(np.float32))


def _flat(out):
    return [t for stage in out for pair in stage for t in pair]


def _forward(model, x):
    with torch.no_grad():
        return _flat(model(torch.from_numpy(x).permute(0, 3, 1, 2)))


def test_relu_conv_on_a_plain_conv_is_conv_of_relu():
    rng = np.random.default_rng(3)
    conv = nn.Conv2d(8, 12, 3, 1, 1)
    x = torch.from_numpy(rng.normal(0, 1, (2, 8, 9, 7)).astype(np.float32))
    x[0, 0, 0, 0] = -0.0
    with torch.no_grad():
        assert torch.equal(tq.relu_conv(conv, x), conv(F.relu(x)))


@pytest.mark.parametrize("layout", ("unfused", "fused"))
def test_fp_forward_runs_what_it_ran_before_the_fold(models, layout):
    model = models[layout]
    before = _as_before(model)
    log, log_before = _OpLog(), _OpLog()
    with log:
        ours = _forward(model, models["x"])
    with log_before:
        ref = _forward(before, models["x"])
    assert log.names == log_before.names
    assert log.names.count("relu") > 50
    assert len(ours) == len(ref) == 8
    for a, b in zip(ours, ref):
        assert torch.equal(a, b)


def _int8_run(model, x, calibrate: bool):
    """The int8 forward of ``model`` (prepared here, on a copy), with
    dynamic scales or calibrated on ``x``; (outputs, scales)."""
    q = tq.prepare_int8(copy.deepcopy(model))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    scales = None
    if calibrate:
        tq.calibrate_acts(q, [xt])
        scales = [m.act_scale for m in q.modules()
                  if isinstance(m, tq.Int8Conv2d)]
    return _forward(q, x), scales


@pytest.mark.parametrize("scale", ("dynamic", "calibrated"))
@pytest.mark.parametrize("layout", ("unfused", "fused"))
def test_folded_int8_forward_equals_the_route_before(models, layout, scale):
    """With the ReLU folded into the quantize, against ReLU -> int8 conv
    (the forwards as before the fold, on a model prepared the same way):
    the outputs and the calibrated scales bit for bit."""
    calibrate = scale == "calibrated"
    ours, scales = _int8_run(models[layout], models["x"], calibrate)
    ref, ref_scales = _int8_run(_as_before(models[layout]), models["x"],
                                calibrate)
    assert len(ours) == len(ref) == 8
    for a, b in zip(ours, ref):
        assert torch.equal(a, b)
    if calibrate:
        assert len(scales) == len(ref_scales) > 100
        for a, b in zip(scales, ref_scales):
            assert torch.equal(a, b)


@pytest.mark.parametrize("layout", ("unfused", "fused"))
def test_int8_convs_fold_every_relu_they_own(models, layout):
    """In the int8 forward each dense conv that follows a ReLU of its own
    takes it folded (``relu=True``), and no int8 conv reads an F.relu
    output unless that output has other readers (SHARED_RELU_CONVS); the
    forward runs fewer F.relu calls than the fp one."""
    q = tq.prepare_int8(copy.deepcopy(models[layout]))
    names = {id(m): n for n, m in q.named_modules()}
    relu_outs, unfolded, folded, relus = {}, [], [0], [0]
    orig_relu, orig_conv = F.relu, tq.int8_conv
    inside = [False]  # the plain quantize's own F.relu: not the model's

    def relu(x, inplace=False):
        y = orig_relu(x, inplace)
        if not inside[0]:
            relu_outs[id(y)] = y
            relus[0] += 1
        return y

    def conv(x, module, *, act_scale=None, relu=False):
        folded[0] += int(relu)
        if relu_outs.get(id(x)) is x and not relu:
            unfolded.append(names[id(module)])
        inside[0] = True
        try:
            return orig_conv(x, module, act_scale=act_scale, relu=relu)
        finally:
            inside[0] = False

    F.relu, tq.int8_conv = relu, conv
    try:
        _forward(q, models["x"])
    finally:
        F.relu, tq.int8_conv = orig_relu, orig_conv
    log = _OpLog()
    with log:
        _forward(models[layout], models["x"])
    assert set(unfolded) <= SHARED_RELU_CONVS and unfolded
    assert folded[0] > 100
    assert relus[0] < log.names.count("relu") - 50


def test_factorized_reduce_folds_the_relu_into_both_branches():
    """Each branch quantizes relu(x) (its shifted view for the second):
    the ReLU commutes with the shift."""
    rng = np.random.default_rng(4)
    fr = tprim.FactorizedReduce(8, 12).eval()
    x = torch.from_numpy(rng.normal(0, 1, (2, 8, 10, 10)).astype(np.float32))
    with torch.no_grad():
        ref = _factorized_reduce(tq.prepare_int8(copy.deepcopy(fr)), x)
        ours = tq.prepare_int8(fr)(x)
    assert torch.equal(ours, ref)


@pytest.fixture(scope="module")
def jax_int8_forward(models):
    """npp_tpu's int8 forward (dynamic scales, weights quantized in the
    graph) of the unfused tiny NPPNet: the module's one JAX program."""
    jm, variables = models["jax"]

    @jax.jit
    def forward(v, x):
        with jq.quantized_convs("int8"):
            return jm.apply(v, x, train=False)

    out = forward(variables, jnp.asarray(models["x"]))
    return [np.asarray(t) for t in _flat(out)]


@pytest.fixture(scope="module")
def int8_forward(models):
    return _int8_run(models["unfused"], models["x"], False)[0]


@pytest.mark.parametrize("index", range(8))
def test_folded_int8_forward_matches_jax(int8_forward, jax_int8_forward,
                                         index):
    got = int8_forward[index].permute(0, 2, 3, 1).numpy()
    ref = jax_int8_forward[index]
    assert got.shape == ref.shape
    bound = INT8_MAP_RTOL * np.abs(ref).max()
    assert np.abs(got - ref).max() <= bound
