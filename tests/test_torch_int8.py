"""The port's int8 serving against npp_tpu on the CPU: the weight and
activation quantizers, the plain version of the int8 conv, the
calibration, the int8 Predictor and eval step, the CLIs' flags and the
refusals.

On the CPU ``int8_conv`` runs its plain version (the int8 values through
a float64 conv, exact, then npp_tpu's fp32 epilogue); the hand-written
kernel runs on the card only (``chip_smoke.py`` phase 20 holds it bit for
bit against the plain version). npp_tpu's ``int8_conv`` runs eagerly
here, op by op. The model is a tiny NPPNet (L=4, C=8, 20 classes, 16
joints) at 64x64 with weights from a numpy RNG, through the weight bridge.
The JAX programs: npp_tpu's ``calibrate_acts`` step on one batch and its
int8 Predictor (weight preparation and serving, dynamic, then static) at
module scope, and one small ``calibrate_acts`` step per primitive op
(~60 s for the file in one process).
Tolerances:

- ``quantize_weight``, ``int8_conv_reference`` against npp_tpu's
  ``int8_conv``: bit for bit;
- calibrated scales: rtol 1e-6 per conv of each primitive op and of the
  model's stems; 2e-2 for the deeper convs of the model, whose inputs
  carry the int8 flips described next;
- the int8 Predictor on npp_tpu's canvases: the fp32 forwards of the two
  frameworks differ by CPU rounding (~1e-7 relative), and where such a
  difference moves an activation across a rounding midpoint of the int8
  grid the quantized value differs by one step (1/127 of the scale).
  Each flip changes the next conv's output by one weight times that
  step and propagates, so the fused heatmaps and logits agree to
  INT8_MAP_RTOL of their largest value, not to fp32 rounding; the labels
  agree on INT8_LABEL_SHARE of the pixels, and the keypoints to
  INT8_KP_ATOL crop px where the blurred peak is unique by a margin
  above that bound.
"""
import copy
import types

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from npp_tpu.core.predictor import Predictor as JPredictor
from npp_tpu.models.augment import NPPNet as JNPPNet
from npp_tpu.ops import quantize as jq

from npp_tpu_torch.core import evaluate as teval
from npp_tpu_torch.core import inference as tinf
from npp_tpu_torch.core import predictor as tpred
from npp_tpu_torch.core.criterion import init_criterion_params
from npp_tpu_torch.config import LIP
from npp_tpu_torch.data.loader import DataLoader, make_target_renderer
from npp_tpu_torch.data.synthetic import SyntheticDataset
from npp_tpu_torch.models.augment import build_nppnet
from npp_tpu_torch.ops import heatmaps
from npp_tpu_torch.ops import quantize as tq
from npp_tpu_torch.parallel import spatial, tensor
from npp_tpu_torch.tools import eval_lip, predict
from npp_tpu_torch.utils import convert

from test_torch_ops import random_variables

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
TINY = dict(num_classes=20, num_joints=16, layers=4, init_channels=8,
            refine_layers=1)
CROP, BATCH = 64, 2
SCALE_RTOL = 1e-6
MODEL_SCALE_RTOL = 2e-2
INT8_MAP_RTOL = 0.05
INT8_LABEL_SHARE = 0.98
INT8_KP_ATOL = 1.0


class _Grid:
    """The attributes a grid's refusals read, without a process group."""

    def __init__(self, n_data=1, n_space=1, n_model=1):
        self.n_data, self.n_space, self.n_model = n_data, n_space, n_model


def _images(seed, n=4):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h, w = 50 + 13 * i, 70 - 5 * i
        im = rng.integers(0, 256, (h, w, 3)).astype(np.float32)
        yy, xx = np.mgrid[:h, :w]
        blob = np.exp(-(((yy - h * 0.4) / (0.2 * h)) ** 2
                        + ((xx - w * (0.3 + 0.1 * i)) / (0.2 * w)) ** 2))
        out.append(np.clip(im * 0.5 + 120 * blob[..., None], 0, 255)
                   .astype(np.uint8))
    return out


@pytest.fixture(scope="module")
def bundle():
    """(flax model, numpy variables, port model with the same weights)."""
    jm = JNPPNet(dtype=jnp.float32, **TINY)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, CROP, CROP, 3)), train=False))
    variables = random_variables(shapes, seed=0)
    tm = build_nppnet(device="cpu", generator=torch.Generator().manual_seed(0),
                      dtype=torch.float32, **TINY)
    convert.load_jax_variables(tm, variables)
    return jm, variables, tm


# -- the quantizers and the conv ------------------------------------------------

@pytest.mark.parametrize("shape", [(16, 8, 3, 3), (4, 3, 3, 3), (8, 8, 1, 1),
                                   (6, 4, 7, 1)])
def test_quantize_weight_matches_jax(shape):
    w = np.random.default_rng(sum(shape)).normal(0, 0.3, shape).astype(
        np.float32)
    w[1] = 0.0  # an all-zero channel takes the 1e-8 floor
    q, s = tq.quantize_weight(torch.from_numpy(w))
    jqw, js = jq.quantize_weight(jnp.asarray(w.transpose(2, 3, 1, 0)))
    np.testing.assert_array_equal(q.numpy().transpose(2, 3, 1, 0),
                                  np.asarray(jqw))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q.dtype == torch.int8


_CONVS = {  # name: (Cin, Cout, kernel, stride, padding)
    "1x1": (8, 16, (1, 1), 1, (0, 0)),
    "3x3": (8, 8, (3, 3), 1, (1, 1)),
    "stride2": (8, 12, (3, 3), 2, (1, 1)),
    "cin3": (3, 8, (3, 3), 2, (1, 1)),
    "7x1": (8, 8, (7, 1), 1, (3, 0)),
}


def _prepared(weight, bias):
    """A prepared ``Int8Conv2d`` holding ``weight`` (OIHW) and ``bias``."""
    cout, cin, kh, kw = weight.shape
    conv = nn.Conv2d(cin, cout, (kh, kw), bias=bias is not None)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(weight))
        if bias is not None:
            conv.bias.copy_(torch.from_numpy(bias))
    return tq.prepare_int8(nn.Sequential(conv))[0]


@pytest.mark.parametrize("scale", ("dynamic", "static", "static_clip"))
@pytest.mark.parametrize("bias", (True, False))
@pytest.mark.parametrize("name", _CONVS)
def test_int8_conv_reference_matches_jax_bit_for_bit(name, bias, scale):
    cin, cout, (kh, kw), stride, padding = _CONVS[name]
    rng = np.random.default_rng(len(name) + 2 * bias + len(scale))
    x = rng.normal(0, 1, (2, 11, 9, cin)).astype(np.float32)
    w = rng.normal(0, 0.2, (cout, cin, kh, kw)).astype(np.float32)
    b = rng.normal(0, 0.1, cout).astype(np.float32) if bias else None
    act = None
    if scale != "dynamic":  # a clipping one holds half the range
        act = np.float32(np.abs(x).max() / 127.0
                         * (0.5 if scale == "static_clip" else 1.25))
    conv = _prepared(w, b)
    conv.stride, conv.padding = (stride, stride), padding
    ours = tq.int8_conv_reference(
        torch.from_numpy(x).permute(0, 3, 1, 2), conv,
        act_scale=None if act is None else torch.tensor(act))
    ref = jq.int8_conv(jnp.asarray(x), jnp.asarray(w.transpose(2, 3, 1, 0)),
                       None if b is None else jnp.asarray(b),
                       stride=(stride, stride), padding=padding,
                       dilation=(1, 1), out_dtype=jnp.float32,
                       act_scale=None if act is None else jnp.asarray(act))
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(ref))
    if scale == "static_clip":
        q, _ = tq.quantize_act(torch.from_numpy(x), torch.tensor(act))
        assert int(q.abs().max()) == 127 and (q.abs() == 127).sum() > 10


def test_int8_conv_follows_the_output_dtype_rule():
    """The autocast dtype where autocast is on, else the input's; the bf16
    result is the float32 one rounded; on the CPU the wrapper is the plain
    version and launches nothing."""
    rng = np.random.default_rng(3)
    conv = _prepared(rng.normal(0, 0.2, (8, 8, 3, 3)).astype(np.float32),
                     rng.normal(0, 0.1, 8).astype(np.float32))
    conv.padding = (1, 1)
    x = torch.from_numpy(rng.normal(0, 1, (2, 8, 6, 6)).astype(np.float32))
    launches = tq.conv_s8.launches
    out32 = tq.int8_conv(x, conv)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        out16 = tq.int8_conv(x, conv)
        ref16 = tq.int8_conv_reference(x, conv)
    assert out32.dtype == torch.float32 and out16.dtype == torch.bfloat16
    assert torch.equal(out16, out32.to(torch.bfloat16))
    assert torch.equal(out16, ref16)
    q_x, a_scale = tq.quantize_act(x)
    acc = tq.conv_s8(q_x, conv.qweight, conv.wscale, a_scale, None,
                     kernel_size=(3, 3), padding=(1, 1),
                     out_dtype=torch.int32)
    assert acc.dtype == torch.int32
    assert tq.conv_s8.launches == launches


def test_prepare_int8_keeps_the_state_dict(bundle):
    tm = bundle[2]
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    q = tq.prepare_int8(copy.deepcopy(tm))
    after = q.state_dict()
    assert list(after) == list(before)
    assert all(torch.equal(after[k], v) for k, v in before.items())
    dense = [m for m in tm.modules()
             if isinstance(m, nn.Conv2d) and m.groups == 1]
    grouped = [m for m in q.modules()
               if isinstance(m, nn.Conv2d) and m.groups > 1]
    assert sum(isinstance(m, tq.Int8Conv2d) for m in q.modules()) == len(dense)
    assert grouped and not any(isinstance(m, tq.Int8Conv2d) for m in grouped)
    assert not any(isinstance(m, tq.Int8Conv2d) for m in tm.modules())
    conv = q.stem0.Conv_0
    assert conv.qweight.shape == (conv.out_channels, 3 * 3 * 3)
    assert conv.qweight.dtype == torch.int8 and conv.act_scale is None


def test_factorized_reduce_convs_run_in_int8(bundle):
    tm = tq.prepare_int8(copy.deepcopy(bundle[2]))
    fr = next(m for m in tm.modules()
              if type(m).__name__ == "FactorizedReduce")
    calls = []
    orig = tq.int8_conv

    def count(x, conv, **kw):
        calls.append(conv)
        return orig(x, conv, **kw)

    tq.int8_conv = count
    try:
        with torch.no_grad():
            fr(torch.randn(2, fr.Conv_0.in_channels, 8, 8))
    finally:
        tq.int8_conv = orig
    assert calls == [fr.Conv_0, fr.Conv_1]


# -- calibration and the Predictor ---------------------------------------------

@pytest.fixture(scope="module")
def calibration(bundle):
    """npp_tpu's static scales from one batch, and the batch (NHWC)."""
    jm, variables, _ = bundle
    x = np.random.default_rng(5).normal(0, 1, (BATCH, CROP, CROP, 3)).astype(
        np.float32)
    scales = jq.calibrate_acts(jm, variables, [jnp.asarray(x)], train=False)
    return jax.tree.map(np.asarray, scales), x


def _scale_pairs(ours, ref):
    """(name, our scale, npp_tpu's scale through the bridge) per conv."""
    out = []
    for (name, a), b in zip(ours.named_modules(), ref.modules()):
        if isinstance(a, tq.Int8Conv2d):
            assert a.act_scale is not None and b.act_scale is not None, name
            out.append((name, a.act_scale.item(), b.act_scale.item()))
    return out


# (op, stride): every primitive that holds a dense conv, as the genotypes
# build it.
_CAL_OPS = [("std_conv_3x3", 1), ("std_conv_3x3", 2), ("std_conv_1x1", 1),
            ("se_connect", 1), ("se_connect", 2), ("dil_conv_3x3_2", 1),
            ("sep_conv_3x3", 2), ("conv_7x1_1x7", 1), ("poled_conv_x1", 1),
            ("poled_conv_x2", 2), ("skip_connect", 2)]


@pytest.mark.parametrize("name,stride", _CAL_OPS)
def test_calibrated_scales_match_jax_per_op(name, stride):
    """Two batches (the running max), scales within SCALE_RTOL: within one
    op a conv's input has crossed at most one other int8 conv."""
    from npp_tpu.ops import primitives as jprim

    from npp_tpu_torch.ops import primitives as tprim
    rng = np.random.default_rng(len(name) + stride)
    xs = [rng.normal(0, 1 + i, (2, 12, 10, 8)).astype(np.float32)
          for i in range(2)]
    fmod = jprim.make_op(name, 8, stride, True, jnp.float32)
    shapes = jax.eval_shape(lambda: fmod.init(
        jax.random.PRNGKey(0), jnp.asarray(xs[0]), train=False))
    variables = random_variables(shapes, seed=3)
    scales = jq.calibrate_acts(fmod, variables,
                               [jnp.asarray(x) for x in xs], train=False)
    tmod = tprim.make_op(name, 8, stride).eval()
    convert.load_jax_variables(tmod, variables)
    ref = tq.prepare_int8(copy.deepcopy(tmod))
    convert.load_jax_variables(ref, {"act_scales": jax.tree.map(np.asarray,
                                                                scales)})
    ours = tq.calibrate_acts(tq.prepare_int8(tmod), [
        torch.from_numpy(x).permute(0, 3, 1, 2) for x in xs])
    pairs = _scale_pairs(ours, ref)
    assert len(pairs) == len(flatten_dict(scales)) >= 1
    for conv, a, b in pairs:
        np.testing.assert_allclose(a, b, rtol=SCALE_RTOL, err_msg=conv)


def test_calibrated_scales_match_jax_in_the_model(bundle, calibration):
    """The stems' scales within SCALE_RTOL; deeper ones within
    MODEL_SCALE_RTOL: there a conv's input has crossed many int8 convs,
    and each carries the one-step flips of the module docstring (seen:
    53 of 286 convs beyond 1e-6, the worst 1.01e-2, in the fusion
    cells and the heads)."""
    scales, x = calibration
    ours = tq.calibrate_acts(tq.prepare_int8(copy.deepcopy(bundle[2])),
                             [torch.from_numpy(x).permute(0, 3, 1, 2)])
    ref = tq.prepare_int8(copy.deepcopy(bundle[2]))
    convert.load_jax_variables(ref, {"act_scales": scales})
    pairs = _scale_pairs(ours, ref)
    assert len(pairs) == len(flatten_dict(scales)) > 100
    for conv, a, b in pairs:
        rtol = SCALE_RTOL if conv.startswith("stem") else MODEL_SCALE_RTOL
        np.testing.assert_allclose(a, b, rtol=rtol, err_msg=conv)


@pytest.fixture(scope="module")
def jax_int8_predictions(bundle, calibration):
    """npp_tpu's int8 Predictor (dynamic, then with the calibrated static
    scales) on the same images, and its preprocess."""
    jm, variables, _ = bundle
    ims = _images(11)
    jp = JPredictor(jm, variables, crop_size=(CROP, CROP), quantize="int8")
    dynamic = jp.predict_batch(ims)
    jp.variables = {**jp.variables, "act_scales": calibration[0]}
    return ims, jp.preprocess, {"dynamic": dynamic,
                                "static": jp.predict_batch(ims)}


@pytest.mark.parametrize("mode", ("dynamic", "static"))
def test_int8_predictor_matches_jax(bundle, calibration, jax_int8_predictions,
                                    mode):
    _, _, tm = bundle
    ims, jax_preprocess, ref = jax_int8_predictions
    tp = tpred.Predictor(tm, crop_size=(CROP, CROP), quantize="int8")
    assert not tq.is_int8(tm) and tq.is_int8(tp.model)
    tp.preprocess = jax_preprocess
    if mode == "static":
        convert.load_jax_variables(tp.model, {"act_scales": calibration[0]})
    ours = tp.predict_batch(ims)
    pre = [jax_preprocess(im) for im in ims]
    canv = torch.from_numpy(np.stack([p[0] for p in pre]))
    cps = torch.from_numpy(np.stack([p[1] for p in pre]))[None]
    _, hm = tp.fuse(canv, cps)
    blurred = tinf.gaussian_blur(hm, tp.blur_sigma).flatten(2)
    top = blurred.topk(2, dim=2).values
    unique = ((top[..., 0] - top[..., 1]) > INT8_MAP_RTOL
              * top[..., 0].abs()).numpy()
    share = np.mean([np.mean(o["parsing_crop"] == r["parsing_crop"])
                     for o, r in zip(ours, ref[mode])])
    kp = np.stack([np.abs(o["keypoints"][:, :2] - r["keypoints"][:, :2])
                   .max(axis=1) * p[2] for o, r, p in zip(ours, ref[mode],
                                                          pre)])
    print(f"{mode}: labels agree on {share:.6f}; keypoints max|diff| "
          f"{kp.max():.4g} crop px, {kp[unique].max() if unique.any() else 0:.4g}"
          f" over the {int(unique.sum())} of {unique.size} unique peaks")
    assert share >= INT8_LABEL_SHARE
    assert unique.any() and kp[unique].max() <= INT8_KP_ATOL
    for o, im in zip(ours, ims):
        assert o["parsing"].shape == im.shape[:2]


def test_calibrate_int8_pads_and_installs_static_scales(bundle):
    tp = tpred.Predictor(bundle[2], crop_size=(CROP, CROP), quantize="int8")
    convs = [m for m in tp.model.modules() if isinstance(m, tq.Int8Conv2d)]
    assert all(m.act_scale is None for m in convs)
    tp.calibrate_int8(_images(2, 3), batch_size=2)  # 3 images -> 2 batches
    assert all(m.act_scale is not None and m.act_scale > 0 for m in convs)
    assert not tq.is_int8(bundle[2])
    out = tp.predict_batch(_images(4, 2))
    assert all(np.isfinite(o["keypoints"]).all() for o in out)
    with pytest.raises(ValueError, match="requires quantize"):
        tpred.Predictor(bundle[2], crop_size=(CROP, CROP)).calibrate_int8(
            _images(2, 1))


def test_int8_eval_step_runs_on_a_copy(bundle):
    tm = bundle[2]
    step = teval.make_eval_step(tm, num_classes=20,
                                class_weights=LIP.class_weights,
                                decode_hw=(CROP, CROP), quantize="int8")
    assert step.model is not tm and tq.is_int8(step.model)
    assert not tq.is_int8(tm)
    ds = SyntheticDataset(length=2, crop_size=(CROP, CROP), num_joints=16,
                          num_classes=20, seed=0, device_normalize=True)
    loader = DataLoader(ds, 2, device="cpu", num_workers=1,
                        renderer=make_target_renderer(
                            stride=4, sigma=2.0, num_joints=16, ignore=255,
                            normalize_images=True))
    out = step(init_criterion_params(2, "cpu"), next(iter(loader)))
    assert np.isfinite(float(out["loss"]))
    assert int(out["cm"].sum()) > 0


# -- the CLIs -------------------------------------------------------------------

def test_predict_flags_have_jax_defaults():
    from tools import predict as jpredict
    ours = predict.build_parser().parse_args([])
    theirs = jpredict.build_parser().parse_args(["--cfg", "x.yaml"])
    for flag in ("int8", "fuse_necks", "fuse_cells", "no_fuse"):
        assert getattr(ours, flag) == getattr(theirs, flag), flag
    assert ours.fuse_necks and ours.fuse_cells and not ours.int8
    off = predict.build_parser().parse_args(["--no-fuse-cells"])
    assert off.fuse_necks and not off.fuse_cells


def test_eval_lip_int8_flag_has_jax_default(monkeypatch):
    import argparse

    from tools import eval_lip as jeval_lip

    class Seen(Exception):
        pass

    def capture(self, args=None, namespace=None):
        raise Seen(argparse.ArgumentParser.parse_known_args(
            self, ["--cfg", "x.yaml"])[0])

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(Seen) as seen:
        jeval_lip.main()
    monkeypatch.undo()
    theirs = seen.value.args[0]
    ours = eval_lip.build_parser().parse_args([])
    assert ours.int8 is theirs.int8 is False
    assert eval_lip.build_parser().parse_args(["--int8"]).int8


@pytest.mark.parametrize("flags", (["--int8"], ["--no-fuse"],
                                   ["--int8", "--no-fuse-necks"]))
def test_predict_cli_serves_the_layouts(tmp_path, flags):
    out = predict.main(["--synthetic", "2", "--tiny", "--device", "cpu",
                        "--dtype", "float32", "--out", str(tmp_path),
                        *flags])
    assert len(out["parsings"]) == 2
    assert all(np.isfinite(k).all() for k in out["keypoints"])
    assert (tmp_path / "pose_pred.csv").exists()


def test_eval_lip_cli_int8(tmp_path):
    launches = heatmaps.render_heatmaps.launches
    res = eval_lip.main(["--synthetic", "--tiny", "--device", "cpu",
                         "--dtype", "float32", "--batch", "2", "--int8"])
    assert np.isfinite(res["loss"]) and len(res["names"]) == 4
    assert heatmaps.render_heatmaps.launches == launches


# -- refusals -------------------------------------------------------------------

def test_int8_refusals(bundle):
    """What stays refused: a model axis (npp_tpu serves int8 over a data x
    space mesh only; ``tests/test_torch_spatial.py`` serves that mesh),
    an unknown mode, the eval step of a split model, a row split or a TP
    conversion of a prepared model (int8 is prepared after the split) and
    scales for an unprepared one."""
    tm = bundle[2]
    with pytest.raises(ValueError, match="n_model > 1"):
        tpred.Predictor(tm, crop_size=(CROP, CROP), mesh=_Grid(n_model=2),
                        quantize="int8")
    with pytest.raises(ValueError, match="split over a grid"):
        tq.prepare_int8(copy.deepcopy(tm), _Grid(n_model=2))
    with pytest.raises(ValueError, match="unknown quantize"):
        tpred.Predictor(tm, crop_size=(CROP, CROP), quantize="int4")
    split = copy.deepcopy(tm)
    split._tp = object()
    with pytest.raises(ValueError, match="split over a grid"):
        tq.prepare_int8(split)
    with pytest.raises(ValueError, match="model axis"):
        teval.make_eval_step(split, num_classes=20,
                             class_weights=LIP.class_weights,
                             quantize="int8")
    rows = copy.deepcopy(tm)
    rows._sharding = object()
    with pytest.raises(ValueError, match="spatially converted"):
        teval.make_eval_step(rows, num_classes=20,
                             class_weights=LIP.class_weights,
                             quantize="int8")
    rows._sharding = types.SimpleNamespace(grid=_Grid(n_space=2))
    with pytest.raises(ValueError, match="pass the grid it was converted"):
        tq.prepare_int8(rows)
    q = tq.prepare_int8(copy.deepcopy(tm))
    with pytest.raises(ValueError, match="int8 serving layout"):
        spatial.convert_spatial(q, _Grid(n_space=2))
    with pytest.raises(ValueError, match="int8 serving layout"):
        tensor.convert_tensor_parallel(q, _Grid(n_model=2))
    with pytest.raises(ValueError, match="not prepared"):
        convert.load_jax_variables(copy.deepcopy(tm), {"act_scales": {
            "stem0": {"Conv_0": {"Conv_0": {"scale": np.float32(0.1)}}}}})


def test_missing_nvcc_and_other_devices_raise(monkeypatch):
    x = torch.zeros((1, 8, 4, 4), dtype=torch.int8, device="meta")
    w = torch.zeros((8, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="conv_s8: input on meta"):
        tq.conv_s8(x, w, torch.ones(8), torch.ones(()), None,
                   kernel_size=(1, 1))
    monkeypatch.setattr(heatmaps.shutil, "which", lambda name: None)
    monkeypatch.setattr(heatmaps.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        heatmaps._nvcc(tq._CSRC)
