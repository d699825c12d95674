"""The port's NPPNet, weight bridge, criterion, decode, metrics and the
whole flip-TTA eval step against npp_tpu on the CPU.

One module-scoped JAX program per function (the tiny forward, the tiny
eval step) so each compiles once. Weights: the flax tree's structure from
``jax.eval_shape`` (no init trace), every leaf filled from a numpy RNG,
the same tree fed to JAX and, through ``load_jax_variables``, to the
port. Everything in fp32; NHWC <-> NCHW at compare.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from npp_tpu import genotypes as jgt
from npp_tpu.core import criterion as jcrit
from npp_tpu.core import evaluate as jeval
from npp_tpu.core import inference as jinf
from npp_tpu.core import train as jtrain
from npp_tpu.data import loader as jloader
from npp_tpu.models.augment import NPPNet as JNPPNet
from npp_tpu.utils import metrics as jmetrics

from npp_tpu_torch import genotypes as tgt
from npp_tpu_torch.core import criterion as tcrit
from npp_tpu_torch.core import evaluate as teval
from npp_tpu_torch.core import inference as tinf
from npp_tpu_torch.data import loader as tloader
from npp_tpu_torch.data.synthetic import SyntheticDataset
from npp_tpu_torch.models.augment import NPPNet, build_nppnet
from npp_tpu_torch.ops.heatmaps import render_heatmaps_reference
from npp_tpu_torch.tools import eval_lip
from npp_tpu_torch.utils import convert
from npp_tpu_torch.utils import metrics as tmetrics

from test_torch_ops import assert_close, random_variables

torch.set_num_threads(1)
TINY = dict(num_classes=20, num_joints=16, layers=8, init_channels=8,
            refine_layers=1)
SIZE, BATCH = 64, 2


@pytest.fixture(scope="module")
def bundle():
    """(flax model, numpy variables, port model with the same weights)."""
    jm = JNPPNet(dtype=jnp.float32, **TINY)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    variables = random_variables(shapes, seed=0)
    tm = build_nppnet(device="cpu", generator=torch.Generator().manual_seed(0),
                      dtype=torch.float32, **TINY)
    convert.load_jax_variables(tm, variables)
    return jm, variables, tm


@pytest.fixture(scope="module")
def forwards(bundle):
    jm, variables, tm = bundle
    x = np.random.default_rng(1).normal(0, 1, (BATCH, SIZE, SIZE, 3)).astype(
        np.float32)
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        ours = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    flat = lambda o: [t for stage in o for pair in stage for t in pair]
    return flat(ours), [np.asarray(r) for r in flat(ref)]


def test_genotypes_match_jax():
    for name in ("ENCODER", "DECODER", "INTER", "FUSION"):
        assert (getattr(tgt, name).__dict__ == getattr(jgt, name).__dict__)


@pytest.mark.parametrize("index", range(8))
def test_tiny_nppnet_head_matches_jax(forwards, index):
    """pose/aux/par/edge x 2 stages, eval mode, 1e-4 x max|ref|."""
    ours, ref = forwards
    assert len(ours) == len(ref) == 8
    assert_close(ours[index], ref[index])


def test_flagship_parameter_count_matches_jax():
    jm = JNPPNet(num_classes=20, num_joints=16, layers=16, init_channels=64,
                 refine_layers=1)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    n_jax = sum(int(np.prod(s.shape))
                for s in flatten_dict(shapes["params"]).values())
    with torch.device("meta"):
        tm = NPPNet(**eval_lip.FLAGSHIP)
    n_port = sum(p.numel() for p in tm.parameters())
    assert n_port == n_jax == 76_968_332
    n_stats = sum(b.numel() for k, b in tm.named_buffers() if "running" in k)
    assert n_stats == sum(int(np.prod(s.shape)) for s in
                          flatten_dict(shapes["batch_stats"]).values())


@pytest.mark.parametrize("edit,error", [
    ("missing", KeyError), ("extra", KeyError), ("merged", ValueError)])
def test_bridge_rejects_bad_trees(bundle, edit, error):
    variables = bundle[1]
    params = dict(flatten_dict(variables["params"]))
    if edit == "missing":
        params.pop(("stem0", "Conv_0", "Conv_0", "kernel"))
    elif edit == "extra":
        params[("stem0", "Conv_7", "Conv_0", "kernel")] = np.zeros(
            (1, 1, 3, 8), np.float32)
    else:
        params[("vcells_0", "ops_0", "Conv_0", "Conv_0", "kernel")] = \
            np.zeros((2, 3, 3, 4, 4), np.float32)
    bad = {"params": unflatten_dict(params),
           "batch_stats": variables["batch_stats"]}
    with pytest.raises(error):
        convert.load_jax_variables(
            NPPNet(dtype=torch.float32, **TINY), bad)


def test_npz_checkpoint_round_trip(bundle, tmp_path):
    _, variables, tm = bundle
    path = tmp_path / "tiny.npz"
    np.savez(path, **{f"{col}/{k}": v for col in variables
                      for k, v in flatten_dict(variables[col],
                                               sep="/").items()})
    fresh = build_nppnet(device="cpu",
                         generator=torch.Generator().manual_seed(9),
                         dtype=torch.float32, **TINY)
    convert.load_jax_variables(fresh, convert.load_npz(str(path)))
    for (k, a), b in zip(tm.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), k


def _logits(seed, shape):
    return np.random.default_rng(seed).normal(0, 2, shape).astype(np.float32)


def test_pose_loss_matches_jax():
    rng = np.random.default_rng(3)
    outs = [(_logits(i, (2, 16, 16, 16)), _logits(10 + i, (2, 16, 16, 16)))
            for i in range(2)]
    target = rng.random((2, 16, 16, 16)).astype(np.float32)
    target_aux = rng.random((2, 16, 16, 16)).astype(np.float32)
    lam = np.array([-2.5, -2.0], np.float32)
    ref = jcrit.pose_loss([tuple(map(jnp.asarray, o)) for o in outs],
                          jnp.asarray(target), jnp.asarray(target_aux),
                          jnp.asarray(lam))
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)
    ours = tcrit.pose_loss([tuple(map(nchw, o)) for o in outs], nchw(target),
                           nchw(target_aux), torch.from_numpy(lam))
    np.testing.assert_allclose(ours.item(), float(ref), rtol=1e-5)


@pytest.mark.parametrize("thres", [0.9, 0.0])
def test_parsing_loss_matches_jax(thres):
    """min_kept=256; thres=0 makes the exact k-th value the threshold."""
    rng = np.random.default_rng(4)
    outs = [(_logits(i, (2, 16, 16, 20)), _logits(20 + i, (2, 16, 16, 2)))
            for i in range(2)]
    par = rng.integers(0, 20, (2, 32, 32)).astype(np.uint8)
    par[0, :5] = 255
    edge = rng.integers(0, 2, (2, 32, 32)).astype(np.int32)
    edge[par == 255] = 255
    lam = np.array([2.3, 2.0], np.float32)
    ref = jcrit.parsing_loss([tuple(map(jnp.asarray, o)) for o in outs],
                             jnp.asarray(par), jnp.asarray(edge),
                             jnp.asarray(lam), thres=thres, min_kept=256)
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)
    ours = tcrit.parsing_loss([tuple(map(nchw, o)) for o in outs],
                              torch.from_numpy(par),
                              torch.from_numpy(edge).long(),
                              torch.from_numpy(lam), thres=thres,
                              min_kept=256)
    np.testing.assert_allclose(ours.item(), float(ref), rtol=1e-5)


def test_criterion_lamda_inits_match_jax():
    ours = tcrit.init_criterion_params(3)
    ref = jtrain.init_criterion_params(3)
    for k in ("lamda_pose", "lamda_par"):
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]))
    assert tcrit.LIP_CLASS_WEIGHTS == jcrit.LIP_CLASS_WEIGHTS


def _peaked_heatmaps(seed, b=2, j=16, g=24):
    """Renderer-made heatmaps with distinct peaks (one joint each)."""
    rng = np.random.default_rng(seed)
    joints = rng.uniform(8, 4 * g - 8, (b, j, 2)).astype(np.float32)
    vis = np.ones((b, j), np.float32)
    hm, _ = render_heatmaps_reference(torch.from_numpy(joints),
                                      torch.from_numpy(vis), grid_x=g,
                                      grid_y=g, sigma=2.0)
    hm = hm[..., :j].numpy() * rng.uniform(0.5, 1.0, (b, 1, 1, j)).astype(
        np.float32)
    return hm  # NHWC


def test_decode_pose_validate_matches_jax():
    hm, fl = _peaked_heatmaps(5), _peaked_heatmaps(6)
    cp = np.tile(np.array([[[3, 5, 1, 2, 90, 90, 96, 96]]], np.float32),
                 (2, 1, 1))
    scale = np.array([1.0, 1.25], np.float32)
    ref = jinf.decode_pose_validate(jnp.asarray(hm), jnp.asarray(fl),
                                    jnp.asarray(cp), jnp.asarray(scale),
                                    out_hw=(96, 96))
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)
    ours = tinf.decode_pose_validate(nchw(hm), nchw(fl), torch.from_numpy(cp),
                                     torch.from_numpy(scale), out_hw=(96, 96))
    ref = np.asarray(ref)
    assert ours.shape == ref.shape == (2, 16, 3)
    np.testing.assert_allclose(ours[..., :2].numpy(), ref[..., :2], atol=1e-4)
    np.testing.assert_allclose(ours[..., 2].numpy(), ref[..., 2], rtol=1e-5)


def test_gaussian_blur_matches_jax_symmetric_padding():
    x = np.random.default_rng(7).random((1, 30, 27, 3)).astype(np.float32)
    ref = jinf.gaussian_blur(jnp.asarray(x), 3.0)
    ours = tinf.gaussian_blur(torch.from_numpy(x).permute(0, 3, 1, 2), 3.0)
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), atol=1e-6)


def test_get_max_preds_first_max_tie_break():
    hm = torch.zeros((1, 2, 4, 5))
    hm[0, 0, 1, 3] = hm[0, 0, 2, 1] = 1.0  # tie: row-major first is (3, 1)
    hm[0, 1] = -1.0                         # non-positive max: zeroed
    preds, maxvals = tinf.get_max_preds(hm)
    ref_p, ref_v = jinf.get_max_preds(jnp.asarray(hm.permute(0, 2, 3, 1)
                                                  .numpy()))
    np.testing.assert_array_equal(preds.numpy(), np.asarray(ref_p))
    np.testing.assert_array_equal(maxvals.numpy(), np.asarray(ref_v))
    assert preds[0, 0].tolist() == [3.0, 1.0]


def test_flip_parsing_fuse_and_confusion_matrix_match_jax():
    a, b = _logits(8, (2, 12, 10, 20)), _logits(9, (2, 12, 10, 20))
    nchw = lambda x: torch.from_numpy(x).permute(0, 3, 1, 2)
    ours = tinf.flip_parsing_fuse(nchw(a), nchw(b))
    ref = jinf.flip_parsing_fuse(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(ours.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(ref))
    label = np.random.default_rng(10).integers(0, 22, (2, 12, 10))
    label[0, 0] = 255  # ignored; 20 and 21 are out of range: not counted
    pred = torch.argmax(ours, dim=1)
    cm = tmetrics.confusion_matrix(torch.from_numpy(label), pred, 20)
    ref_cm = jmetrics.confusion_matrix(jnp.asarray(label),
                                       jnp.asarray(pred.numpy()), 20)
    np.testing.assert_array_equal(cm.numpy(), np.asarray(ref_cm))
    seg, ref_seg = tmetrics.seg_metrics(cm.numpy()), jmetrics.seg_metrics(
        np.asarray(ref_cm))
    for k in ("pixel_acc", "mean_iou", "fw_iou"):
        assert seg[k] == ref_seg[k]
    assert tmetrics.per_class_table(seg["per_class_iou"]) == \
        jmetrics.per_class_table(ref_seg["per_class_iou"])


def test_eval_step_matches_jax(bundle):
    """The whole tiny flip-TTA eval step (ohem_keep=256): loss at rtol 1e-4,
    parsing and pose predictions identical on >= 99.5% (a near-tie of an
    argmax may move)."""
    jm, variables, tm = bundle
    ds = SyntheticDataset(length=BATCH, crop_size=(SIZE, SIZE),
                          num_joints=16, num_classes=20, seed=3,
                          device_normalize=True)
    host = tloader.collate([ds[i] for i in range(BATCH)])
    host["par"][1, :8, :20] = 255
    keys = ("image", "par", "joints", "visibility")
    kw = dict(num_classes=20, class_weights=jcrit.LIP_CLASS_WEIGHTS,
              flip_test=True, ohem_keep=256, decode_hw=(SIZE, SIZE))

    jbatch = {k: jnp.asarray(host[k]) for k in keys + ("scale", "crop_param")}
    jbatch.update(jloader.make_target_renderer(normalize_images=True)(
        *(jbatch[k] for k in keys)))
    ref = jeval.make_eval_step(jm, **kw)(
        {"model": variables["params"],
         "criterion": jtrain.init_criterion_params(2)},
        variables["batch_stats"], jbatch)

    tbatch = {k: torch.from_numpy(host[k])
              for k in keys + ("scale", "crop_param")}
    tbatch.update(tloader.make_target_renderer(normalize_images=True)(
        *(tbatch[k] for k in keys)))
    ours = teval.make_eval_step(tm, **kw)(tcrit.init_criterion_params(2),
                                          tbatch)

    np.testing.assert_allclose(ours["loss"].item(), float(ref["loss"]),
                               rtol=1e-4)
    par_same = (ours["par_pred"].numpy() == np.asarray(ref["par_pred"]))
    assert par_same.mean() >= 0.995
    pose_same = np.all(ours["pose_pred"][..., :2].numpy()
                       == np.asarray(ref["pose_pred"])[..., :2], axis=-1)
    assert pose_same.mean() >= 0.995
    np.testing.assert_array_equal(ours["cm"].sum().item(),
                                  float(np.asarray(ref["cm"]).sum()))


def test_eval_cli_runs_tiny_on_cpu(capsys):
    # --synthetic evaluates 2 x --batch images, as npp_tpu's CLI.
    result = eval_lip.main(["--synthetic", "--tiny", "--batch", "2",
                            "--device", "cpu", "--dtype", "float32"])
    assert np.isfinite(result["loss"])
    assert result["pose_preds"].shape == (4, 16, 3)
    assert result["cm"].sum() == 4 * 128 * 128
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("n=4 ")
