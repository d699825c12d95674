"""The int8 serving layer's launch plan and activation quantize on the
CPU: ``quantize._conv_plan`` over the dense-conv shape classes of the
flagship's int8 forwards and a seeded grid of shapes, an emulation of the
plan's K split that must sum to the plain conv bit for bit, the
``quantize_act`` wrapper against its plain version and npp_tpu's, and the
wrappers' refusal to fall back on a tensor that lies on the card.

The kernels themselves (``csrc/int8_conv.cu``, ``csrc/int8_quantize.cu``)
build and run on the card only; ``chip_smoke.py`` (phase 20a) holds them
bit for bit against the plain versions there. Everything here is exact:
int32 and int64 sums, and the quantize's op-for-op rounding.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from npp_tpu.ops import quantize as jq

from npp_tpu_torch.ops import heatmaps
from npp_tpu_torch.ops import quantize as tq

torch.set_num_threads(1)
BATCH = 8
SMS = 132  # the H100 SXM's SMs

# The dense-conv shape classes of the unfused and fused int8 flagship
# forwards at bs8 (L=16, C=64, 384x384): (Cin, H, W, Cout, kernel, stride,
# padding, bias, output dtype); square kernels, dilation 1.
FLAGSHIP_CLASSES = (
    (3, 384, 384, 64, 3, 2, 1, False, "bfloat16"),
    (64, 192, 192, 128, 3, 2, 1, False, "bfloat16"),
    (128, 96, 96, 128, 3, 1, 1, False, "bfloat16"),
    (128, 96, 96, 32, 1, 1, 0, False, "bfloat16"),
    (32, 96, 96, 96, 3, 1, 1, False, "bfloat16"),
    (32, 1, 1, 32, 1, 1, 0, True, "bfloat16"),
    (32, 96, 96, 32, 3, 1, 1, False, "bfloat16"),
    (128, 96, 96, 128, 1, 1, 0, False, "bfloat16"),
    (128, 96, 96, 64, 1, 1, 0, False, "bfloat16"),
    (64, 96, 96, 64, 3, 2, 1, False, "bfloat16"),
    (64, 1, 1, 64, 1, 1, 0, True, "bfloat16"),
    (64, 48, 48, 64, 3, 1, 1, False, "bfloat16"),
    (64, 48, 48, 64, 1, 1, 0, False, "bfloat16"),
    (128, 96, 96, 32, 1, 2, 0, False, "bfloat16"),
    (128, 95, 95, 32, 1, 2, 0, False, "bfloat16"),
    (256, 48, 48, 64, 1, 1, 0, False, "bfloat16"),
    (64, 48, 48, 192, 3, 1, 1, False, "bfloat16"),
    (256, 48, 48, 256, 3, 1, 1, False, "bfloat16"),
    (256, 24, 24, 256, 3, 1, 1, True, "bfloat16"),
    (256, 48, 48, 128, 1, 1, 0, False, "bfloat16"),
    (128, 48, 48, 128, 3, 2, 1, False, "bfloat16"),
    (128, 1, 1, 128, 1, 1, 0, True, "bfloat16"),
    (128, 24, 24, 128, 3, 1, 1, False, "bfloat16"),
    (128, 24, 24, 128, 1, 1, 0, False, "bfloat16"),
    (256, 48, 48, 64, 1, 2, 0, False, "bfloat16"),
    (256, 47, 47, 64, 1, 2, 0, False, "bfloat16"),
    (512, 24, 24, 128, 1, 1, 0, False, "bfloat16"),
    (128, 24, 24, 384, 3, 1, 1, False, "bfloat16"),
    (256, 48, 48, 256, 1, 1, 0, False, "bfloat16"),
    (256, 24, 24, 512, 1, 1, 0, True, "bfloat16"),
    (512, 24, 24, 512, 3, 1, 1, False, "bfloat16"),
    (512, 24, 24, 512, 1, 1, 0, False, "bfloat16"),
    (512, 24, 24, 256, 1, 1, 0, False, "bfloat16"),
    (256, 24, 24, 256, 3, 2, 1, False, "bfloat16"),
    (256, 1, 1, 256, 1, 1, 0, True, "bfloat16"),
    (256, 12, 12, 256, 3, 1, 1, False, "bfloat16"),
    (256, 12, 12, 256, 1, 1, 0, False, "bfloat16"),
    (512, 24, 24, 128, 1, 2, 0, False, "bfloat16"),
    (512, 23, 23, 128, 1, 2, 0, False, "bfloat16"),
    (1024, 12, 12, 256, 1, 1, 0, False, "bfloat16"),
    (256, 12, 12, 768, 3, 1, 1, False, "bfloat16"),
    (512, 12, 12, 1024, 1, 1, 0, True, "bfloat16"),
    (1024, 12, 12, 1024, 3, 1, 1, False, "bfloat16"),
    (256, 12, 12, 1024, 1, 1, 0, True, "bfloat16"),
    (1024, 12, 12, 128, 1, 1, 0, False, "bfloat16"),
    (128, 24, 24, 384, 1, 1, 0, False, "bfloat16"),
    (128, 12, 12, 256, 1, 1, 0, False, "bfloat16"),
    (128, 12, 12, 128, 3, 1, 1, False, "bfloat16"),
    (128, 24, 24, 256, 3, 1, 1, False, "bfloat16"),
    (128, 1, 1, 64, 1, 1, 0, True, "bfloat16"),
    (64, 1, 1, 128, 1, 1, 0, True, "bfloat16"),
    (128, 12, 12, 128, 3, 1, 1, True, "bfloat16"),
    (128, 24, 24, 256, 1, 1, 0, False, "bfloat16"),
    (512, 24, 24, 512, 1, 1, 0, True, "bfloat16"),
    (128, 24, 24, 512, 1, 1, 0, True, "bfloat16"),
    (512, 24, 24, 64, 1, 1, 0, False, "bfloat16"),
    (64, 48, 48, 192, 1, 1, 0, False, "bfloat16"),
    (64, 24, 24, 128, 1, 1, 0, False, "bfloat16"),
    (64, 24, 24, 64, 3, 1, 1, False, "bfloat16"),
    (64, 48, 48, 128, 3, 1, 1, False, "bfloat16"),
    (64, 1, 1, 32, 1, 1, 0, True, "bfloat16"),
    (32, 1, 1, 64, 1, 1, 0, True, "bfloat16"),
    (64, 24, 24, 64, 3, 1, 1, True, "bfloat16"),
    (64, 48, 48, 128, 1, 1, 0, False, "bfloat16"),
    (256, 48, 48, 256, 1, 1, 0, True, "bfloat16"),
    (512, 48, 48, 256, 1, 1, 0, True, "bfloat16"),
    (128, 48, 48, 256, 1, 1, 0, True, "bfloat16"),
    (256, 48, 48, 32, 1, 1, 0, False, "bfloat16"),
    (32, 96, 96, 96, 1, 1, 0, False, "bfloat16"),
    (32, 48, 48, 64, 1, 1, 0, False, "bfloat16"),
    (32, 48, 48, 32, 3, 1, 1, False, "bfloat16"),
    (32, 96, 96, 32, 1, 1, 0, False, "bfloat16"),
    (32, 96, 96, 64, 3, 1, 1, False, "bfloat16"),
    (32, 1, 1, 16, 1, 1, 0, True, "bfloat16"),
    (16, 1, 1, 32, 1, 1, 0, True, "bfloat16"),
    (32, 48, 48, 32, 3, 1, 1, True, "bfloat16"),
    (32, 96, 96, 64, 1, 1, 0, False, "bfloat16"),
    (256, 96, 96, 128, 1, 1, 0, True, "bfloat16"),
    (512, 96, 96, 128, 1, 1, 0, True, "bfloat16"),
    (1024, 12, 12, 1024, 1, 1, 0, False, "bfloat16"),
    (1024, 96, 96, 128, 1, 1, 0, True, "bfloat16"),
    (1024, 96, 96, 896, 1, 1, 0, True, "bfloat16"),
    (512, 96, 96, 256, 1, 1, 0, True, "bfloat16"),
    (256, 96, 96, 16, 1, 1, 0, True, "float32"),
    (384, 96, 96, 128, 3, 1, 1, True, "bfloat16"),
    (128, 96, 96, 16, 1, 1, 0, True, "float32"),
    (256, 96, 96, 20, 1, 1, 0, True, "float32"),
    (384, 96, 96, 6, 3, 1, 1, False, "bfloat16"),
    (6, 96, 96, 2, 1, 1, 0, True, "float32"),
    (384, 96, 96, 128, 1, 1, 0, False, "bfloat16"),
    (512, 96, 96, 128, 1, 1, 0, False, "bfloat16"),
    (128, 96, 96, 256, 3, 1, 1, False, "bfloat16"),
    (256, 1, 1, 128, 1, 1, 0, True, "bfloat16"),
    (128, 1, 1, 256, 1, 1, 0, True, "bfloat16"),
    (128, 12, 12, 128, 1, 1, 0, False, "bfloat16"),
    (64, 24, 24, 64, 1, 1, 0, False, "bfloat16"),
    (32, 48, 48, 32, 1, 1, 0, False, "bfloat16"),
    (1024, 96, 96, 384, 1, 1, 0, True, "bfloat16"),
    (1024, 96, 96, 512, 1, 1, 0, True, "bfloat16"),
)


def _plan(cin, h, w, cout, k, s, p, d=1, n=BATCH, sms=SMS):
    return tq._conv_plan(n, h, w, cin, cout, (k, k), (s, s), (p, p),
                         (d, d), sms=sms)


def _check_plan(plan, n, h, w, cin, cout, k, s, p, d, sms=SMS):
    """The plan's invariants for one conv."""
    ho = (h + 2 * p - d * (k - 1) - 1) // s + 1
    wo = (w + 2 * p - d * (k - 1) - 1) // s + 1
    m, kk = n * ho * wo, k * k * cin
    assert (plan.m, plan.k) == (m, kk)
    assert plan.k_stages == -(-kk // tq.STAGE_K)
    tiny = (m <= tq.TINY_M and k == 1 and s == 1 and p == 0
            and cin % 4 == 0)
    if tiny:
        assert plan.variant == "tiny_m"
        assert plan.grid == (-(-cout // 8), 1, 1) and plan.splits == 1
        return
    assert plan.units == plan.n_tiles * plan.m_tiles * plan.splits
    assert plan.grid == (min(plan.units, sms), 1, 1)  # persistent
    direct = k == 1 and s == 1 and p == 0
    patches = (cin % 128 == 0 and s == 1 and ho % tq.PATCH_H == 0
               and wo % tq.PATCH_W == 0)
    assert plan.variant == ("packed" if cin % 16 else
                            "wgmma_tma" if direct or patches else "wgmma")
    # wgmma's N: a multiple of 8 up to 256 (64, 128 or 256 here)
    assert plan.bn % 8 == 0 and 8 <= plan.bn <= 256
    assert plan.bn in (64, 128, 256)
    if plan.variant == "packed":
        assert plan.bn == 64
    assert plan.n_tiles * plan.bn >= cout > (plan.n_tiles - 1) * plan.bn
    assert plan.m_tiles * tq.TILE_M >= m > (plan.m_tiles - 1) * tq.TILE_M
    # every K stage in exactly one split, each split at least one stage
    covered = []
    for sp in range(plan.splits):
        lo, hi = plan.split_range(sp)
        assert hi > lo
        covered.extend(range(lo, hi))
    assert covered == list(range(plan.k_stages))
    # shared memory: the ring, the epilogue's staging, the barriers and
    # the alignment slack, within what a block may use
    ring = plan.stages * (tq.TILE_M + plan.bn) * tq.STAGE_K
    assert 2 <= plan.stages <= tq.RING_MAX
    assert (ring + tq.STAGING_BYTES + tq.TABLE_BYTES + 16 * plan.stages
            + 1040 == plan.smem_bytes <= tq.SMEM_BLOCK_LIMIT)
    # the width and split are the cost model's least over every candidate
    # (64, 128, 256 where they fit; splits 1..min(K stages, 32) where the
    # width's tiles alone leave SMs idle, else none)
    assert 1 <= plan.splits <= plan.k_stages
    if plan.variant == "packed":
        assert plan.splits == 1
    else:
        widths = [64] + ([128] if cout > 64 else []) + (
            [256] if cout > 64 and cout % 256 == 0 else [])
        costs = [tq._plan_cost(plan.m_tiles * -(-cout // bn) * sp,
                               -(-plan.k_stages // sp), bn, sp, sms)
                 for bn in widths
                 for sp in range(1, min(plan.k_stages, 32) + 1)
                 if sp == 1 or plan.m_tiles * -(-cout // bn) < sms]
        chosen = tq._plan_cost(plan.units, -(-plan.k_stages // plan.splits),
                               plan.bn, plan.splits, sms)
        assert chosen <= min(costs) + 1e-9
    if plan.splits > 1:
        assert plan.m_tiles * plan.n_tiles < sms


@pytest.mark.parametrize("cls", FLAGSHIP_CLASSES,
                         ids=lambda c: "x".join(map(str, c[:7])) + (
                             "b" if c[7] else "") + c[8][:2])
def test_plan_invariants_at_the_flagship_classes(cls):
    cin, h, w, cout, k, s, p, _, _ = cls
    _check_plan(_plan(cin, h, w, cout, k, s, p), BATCH, h, w, cin, cout, k,
                s, p, 1)


def test_flagship_classes_exercise_every_variant():
    """The flagship forwards take each of the plan's variants: the stem
    packs K, the squeeze-excite convs on 1x1 maps take the tiny-M path,
    the other 1x1 stride-1 convs and the stride-1 convs of 128-channel
    multiples on 8 x 16 patches load A by TMA,
    the 12x12 and 24x24 levels split K (their 3x3 convs to at least two
    thirds of the card's SMs), the 96x96 level never does, the rest take
    the plain wgmma tile."""
    kinds = {}
    for cin, h, w, cout, k, s, p, _, _ in FLAGSHIP_CLASSES:
        plan = _plan(cin, h, w, cout, k, s, p)
        side = (h + 2 * p - k) // s + 1  # the output map's side
        kind = plan.variant + ("+splitK" if plan.splits > 1 else "")
        kinds.setdefault(kind, []).append(side)
        if plan.variant != "packed" and side in (12, 24) and k == 3:
            # the small levels' 3x3 convs fill about the card, by split K
            # where their tiles alone do not
            assert plan.units >= 2 * SMS // 3
            assert plan.splits > 1 or plan.m_tiles * plan.n_tiles >= 90
        if side >= 96:
            assert plan.splits == 1 and plan.units >= SMS
        if h == 1:
            assert plan.variant == "tiny_m"
        if cin == 3:
            assert plan.variant == "packed" and plan.k == 27
    assert set(kinds) == {"wgmma", "wgmma_tma", "wgmma+splitK",
                          "wgmma_tma+splitK", "packed", "tiny_m"}
    assert set(kinds["wgmma+splitK"]) | set(kinds["wgmma_tma+splitK"]) == {
        12, 24}


@pytest.mark.parametrize("seed", range(12))
def test_plan_invariants_over_a_seeded_grid(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        n = int(rng.integers(1, 17))
        h, w = (int(v) for v in rng.integers(1, 200, 2))
        k = int(rng.choice([1, 3, 5, 7]))
        d = int(rng.choice([1, 1, 2]))
        s = int(rng.choice([1, 2]))
        p = int(rng.integers(0, k // 2 * d + 1))
        if h + 2 * p < d * (k - 1) + 1 or w + 2 * p < d * (k - 1) + 1:
            continue
        cin = int(rng.choice([3, 4, 6, 16, 32, 48, 64, 96, 128, 256, 512,
                              1024]))
        cout = int(rng.choice([1, 2, 6, 16, 20, 32, 64, 96, 128, 192, 256,
                               384, 512, 896, 1024]))
        sms = int(rng.choice([132, 114, 78]))
        plan = _plan(cin, h, w, cout, k, s, p, d, n=n, sms=sms)
        _check_plan(plan, n, h, w, cin, cout, k, s, p, d, sms=sms)


def _im2col(q_x, k, s, p, d):
    """(M, K) int64 rows of the implicit GEMM, K ordered (r, s, channel) as
    the kernel reads it (and as ``qweight`` lies), zero outside."""
    xp = torch.nn.functional.pad(q_x.to(torch.int64), (p, p, p, p))
    cols = xp.unfold(2, d * (k - 1) + 1, s).unfold(
        3, d * (k - 1) + 1, s)[..., ::d, ::d]  # (N, C, Ho, Wo, k, k)
    n, c, ho, wo = cols.shape[:4]
    return cols.permute(0, 2, 3, 4, 5, 1).reshape(n * ho * wo, k * k * c)


SPLIT_SHAPES = (  # (N, Cin, H, W, Cout, k, stride, padding, dilation)
    (2, 32, 6, 6, 48, 3, 1, 1, 1),
    (2, 64, 5, 7, 16, 3, 1, 2, 2),
    (1, 16, 9, 9, 8, 5, 2, 2, 1),
    (2, 128, 4, 4, 40, 3, 1, 1, 1),
    (1, 3, 11, 11, 8, 3, 2, 1, 1),
    (1, 6, 4, 4, 2, 1, 1, 0, 1),
    (8, 32, 1, 1, 16, 1, 1, 0, 1),
    (1, 256, 3, 3, 24, 3, 1, 1, 1),
)


@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_emulated_split_sums_to_the_plain_conv(shape):
    """The plan's K partition, emulated: each split's int64 partial over
    its stages' bytes of K (the stage ranges of ``split_range``, cut at
    K), summed over the splits, equals ``conv_s8_reference``'s int32
    accumulators bit for bit; for the plan's own split and for every
    split the K stages allow."""
    n, cin, h, w, cout, k, s, p, d = shape
    rng = np.random.default_rng(sum(shape))
    q_x = torch.from_numpy(rng.integers(-127, 128, (n, cin, h, w))
                           .astype(np.int8))
    qw = torch.from_numpy(rng.integers(-127, 128, (cout, k * k * cin))
                          .astype(np.int8))
    plan = _plan(cin, h, w, cout, k, s, p, d, n=n)
    a, b = _im2col(q_x, k, s, p, d), qw.to(torch.int64)
    assert a.shape == (plan.m, plan.k)
    ref = tq.conv_s8_reference(
        q_x, qw, torch.ones(cout), torch.ones(()), None,
        kernel_size=(k, k), stride=(s, s), padding=(p, p), dilation=(d, d),
        out_dtype=torch.int32)
    ho, wo = ref.shape[2:]
    for splits in sorted({plan.splits, *range(1, plan.k_stages + 1)}):
        split_plan = dataclasses.replace(plan, splits=splits)
        total = torch.zeros((plan.m, cout), dtype=torch.int64)
        for sp in range(splits):
            lo, hi = split_plan.split_range(sp)
            assert hi > lo
            ks = slice(lo * tq.STAGE_K, min(hi * tq.STAGE_K, plan.k))
            total += a[:, ks] @ b[:, ks].T
        assert torch.equal(total.to(torch.int32).reshape(n, ho, wo, cout),
                           ref.permute(0, 2, 3, 1))


def test_small_shapes_split_k():
    """Among the emulated shapes, those whose one tile walks a long K take
    the plan's split."""
    splits = {shape: _plan(*shape[1:5], *shape[5:8], shape[8], n=shape[0])
              .splits for shape in SPLIT_SHAPES}
    assert splits[(1, 256, 3, 3, 24, 3, 1, 1, 1)] > 1
    assert splits[(2, 128, 4, 4, 40, 3, 1, 1, 1)] > 1


def _jax_q_times_scale(x_nhwc, act_scale):
    """npp_tpu's int8_conv quantize, read through a 1x1 identity conv with
    unit weight scales: its output is float(q) * a_scale."""
    c = x_nhwc.shape[-1]
    eye = jnp.eye(c, dtype=jnp.int8).reshape(1, 1, c, c)
    return np.asarray(jq.int8_conv(
        jnp.asarray(x_nhwc), None, None, stride=(1, 1),
        padding=(0, 0), dilation=(1, 1), out_dtype=jnp.float32,
        prepared=(eye, jnp.ones((c,), jnp.float32)),
        act_scale=None if act_scale is None else jnp.asarray(act_scale)))


@pytest.mark.parametrize("layout", ("nchw", "channels_last"))
@pytest.mark.parametrize("scale", ("dynamic", "static", "static_clip"))
def test_quantize_act_on_the_cpu(layout, scale):
    """On a CPU tensor ``quantize_act`` is the plain version, returned
    NHWC-contiguous; its q times its scale is npp_tpu's, bit for bit."""
    rng = np.random.default_rng(len(layout) + len(scale))
    x = rng.normal(0, 2, (2, 24, 5, 7)).astype(np.float32)
    act = None
    if scale != "dynamic":
        act = np.float32(np.abs(x).max() / 127.0
                         * (0.5 if scale == "static_clip" else 1.25))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)  # (2, 7, 5, 24) NCHW view
    xt = (xt.contiguous() if layout == "nchw"
          else xt.contiguous(memory_format=torch.channels_last))
    act_t = None if act is None else torch.tensor(act)
    launches = (tq.quantize_act.launches, tq.act_absmax.launches)
    q, a_scale = tq.quantize_act(xt, act_t)
    q_ref, a_ref = tq.quantize_act_reference(xt, act_t)
    assert (tq.quantize_act.launches, tq.act_absmax.launches) == launches
    assert q.dtype == torch.int8 and q.permute(0, 2, 3, 1).is_contiguous()
    assert torch.equal(q, q_ref) and torch.equal(a_scale, a_ref)
    if scale == "static_clip":
        assert int(q.abs().max()) == 127 and (q.abs() == 127).sum() > 10
    ours = (q.permute(0, 2, 3, 1).to(torch.float32) * a_scale).numpy()
    np.testing.assert_array_equal(
        ours, _jax_q_times_scale(xt.permute(0, 2, 3, 1).numpy(), act))
    stats = tq.act_absmax(xt)
    assert torch.equal(stats[1], tq.quantize_act_reference(xt)[1])
    assert float(stats[0]) == float(np.abs(x).max())


def test_quantize_act_bf16_on_the_cpu():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(0, 3, (2, 16, 6, 6)).astype(np.float32))
    x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    q, a_scale = tq.quantize_act(x)
    q_ref, a_ref = tq.quantize_act_reference(x.to(torch.float32))
    assert torch.equal(q, q_ref) and torch.equal(a_scale, a_ref)


class _OnCard:
    """A CPU tensor that says it lies on the card: what a wrapper does
    with a CUDA tensor, on a box without nvcc."""

    device = torch.device("cuda", 0)

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)


def test_a_cuda_tensor_goes_to_the_kernels_and_raises_without_nvcc(
        monkeypatch, tmp_path):
    """No fallback: on a tensor on the card each wrapper builds its kernel
    (here, without nvcc, that raises) and never returns the plain
    version."""
    monkeypatch.setattr(heatmaps.shutil, "which", lambda name: None)
    monkeypatch.setattr(heatmaps.os.path, "exists", lambda path: False)
    monkeypatch.setattr(heatmaps, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tq, "_LIBRARY", {})
    x = _OnCard(torch.zeros((2, 16, 4, 4), dtype=torch.bfloat16))
    for call in (lambda: tq.quantize_act(x),
                 lambda: tq.quantize_act(x, torch.ones(())),
                 lambda: tq.act_absmax(x),
                 lambda: tq.conv_s8(
                     _OnCard(torch.zeros((2, 16, 4, 4), dtype=torch.int8)),
                     torch.zeros((8, 16), dtype=torch.int8), torch.ones(8),
                     torch.ones(()), None, kernel_size=(1, 1))):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call()
    assert not tq._LIBRARY
    with pytest.raises(ValueError, match="quantize_act: input on meta"):
        tq.quantize_act(torch.zeros((1, 8, 2, 2), device="meta"))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tq.quantize_act(_OnCard(torch.zeros((1, 8, 2, 2),
                                            dtype=torch.float16)))
