"""The port's Pascal-Person-Part (PPP) configuration and the search ->
train -> eval chain against npp_tpu on the CPU.

The same seeded numpy inputs go through the JAX function and the port's.
The model is a tiny 7-class, 14-joint NPPNet (L=4, C=8, 64x64, batch 2):
its flax tree's structure from ``jax.eval_shape`` (no init trace), every
leaf from a numpy RNG, the same tree loaded into the port through the
weight bridge. One JAX program is compiled for the module: the PPP eval
step with flip, the same without, and ``make_eval_step`` with
``dark=True``, no parsing flip pairs and the PPP joint flip index, side
by side on one batch. Targets are rendered by the port's plain renderer
and handed to both packages.

Tolerances:

- the presets, the metrics (float64 on both sides), the PPP PCK table,
  the OKS mAP, the eval_ppp_map CLI's output: exact;
- the eval steps: confusion matrix and parsing argmax exact; loss rtol
  1e-4 and ``pose_hm`` 1e-4 x max|ref| (fp32 convs summed in another
  order); the DARK decode's keypoints 5e-4 px (the DARK step divides by
  the log-map's curvature, which magnifies fp32 rounding; the serving
  tests use the same bound), the peak scores 1e-4 x max;
- ``validate_ppp`` over 2 batches: the PCK vector, mIoU and the table
  string exact, the loss rtol 1e-4;
- ``load_pretrained_params``: the same loaded and shape-skipped
  parameters (JAX paths mapped by the bridge's path rule) and counts, the
  loaded values copied bit for bit; at the reference widths the names and
  counts only (the port's models on the meta device).
"""
import json
import os

import numpy as np
import pytest
import scipy.io as scio
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from npp_tpu import genotypes as jgt
from npp_tpu.config import load_config
from npp_tpu.core import criterion as jcrit
from npp_tpu.core import evaluate as jeval
from npp_tpu.core import train as jtrain
from npp_tpu.core.checkpoint import load_pretrained_params as jmerge
from npp_tpu.core.inference import FLIPPED_POSEIDX_PPP
from npp_tpu.models.augment import NPPNet as JNPPNet
from npp_tpu.models.search import SearchNet as JSearchNet
from npp_tpu.utils import metrics as jmetrics

from npp_tpu_torch import config as tconfig
from npp_tpu_torch import genotypes as tgt
from npp_tpu_torch.core import criterion as tcrit
from npp_tpu_torch.core import evaluate as teval
from npp_tpu_torch.core.checkpoint import load_pretrained_params
from npp_tpu_torch.data import loader as tloader
from npp_tpu_torch.data.synthetic import SyntheticDataset
from npp_tpu_torch.models import genotype_parse as tgp
from npp_tpu_torch.models.augment import NPPNet, build_nppnet
from npp_tpu_torch.models.search import SearchNet
from npp_tpu_torch.ops.heatmaps import render_heatmaps_reference
from npp_tpu_torch.tools import augment_lip, eval_lip, eval_ppp_map, search_lip
from npp_tpu_torch.utils import convert
from npp_tpu_torch.utils import metrics as tmetrics

from test_torch_ops import random_variables

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(num_classes=7, num_joints=14, layers=4, init_channels=8,
            refine_layers=1)
SIZE, BATCH, OHEM_KEEP = 64, 2, 256
STEP_KW = dict(num_classes=7, class_weights=jcrit.PASCAL_CLASS_WEIGHTS,
               ohem_keep=OHEM_KEEP)
CPU = ["--tiny", "--device", "cpu", "--dtype", "float32"]


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def bundle():
    """(flax model, numpy variables, port model with the same weights)."""
    jm = JNPPNet(dtype=jnp.float32, **TINY)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    variables = random_variables(shapes, seed=4)
    tm = build_nppnet(device="cpu", generator=torch.Generator().manual_seed(0),
                      dtype=torch.float32, **TINY)
    convert.load_jax_variables(tm, variables)
    return jm, variables, tm


@pytest.fixture(scope="module")
def batches():
    """Two rendered batches: (port NCHW dicts, JAX NHWC dicts)."""
    ds = SyntheticDataset(length=2 * BATCH, crop_size=(SIZE, SIZE),
                          num_joints=14, num_classes=7, seed=3,
                          device_normalize=True)
    render = tloader.make_target_renderer(num_joints=14,
                                          normalize_images=True)
    keys = ("image", "par", "joints", "visibility")
    ours, ref = [], []
    for b in range(2):
        host = tloader.collate([ds[i] for i in range(b * BATCH,
                                                     (b + 1) * BATCH)])
        host["par"][1, :8, :20] = 255  # some ignored pixels
        t = {k: torch.from_numpy(host[k])
             for k in keys + ("scale", "crop_param")}
        t.update(render(*(t[k] for k in keys)))
        t["image"] = t["image"].contiguous()
        ours.append(t)
        ref.append({"image": jnp.asarray(_nhwc(t["image"])),
                    "pose": jnp.asarray(_nhwc(t["pose"])),
                    "pose_aux": jnp.asarray(_nhwc(t["pose_aux"])),
                    "par": jnp.asarray(host["par"].astype(np.int32)),
                    "edge": jnp.asarray(t["edge"].numpy().astype(np.int32)),
                    "scale": jnp.asarray(host["scale"]),
                    "crop_param": jnp.asarray(host["crop_param"])})
    return ours, ref


def _jparams(variables):
    return {"model": variables["params"],
            "criterion": jtrain.init_criterion_params(2)}


DARK_KW = dict(STEP_KW, flip_test=True, ohem_thres=0.7, flip_pairs=(),
               pose_flip_idx=FLIPPED_POSEIDX_PPP, blur_sigma=2.0, dark=True,
               decode_hw=(SIZE, SIZE))


@pytest.fixture(scope="module")
def jax_steps(bundle):
    """The module's one JAX program: the PPP step with flip, the PPP step
    without, and ``make_eval_step`` with ``DARK_KW``, on one batch (one
    compile, whose forwards XLA shares between the steps)."""
    jm, variables, _ = bundle
    flip = jeval.make_ppp_eval_step(jm, flip_test=True, **STEP_KW)
    noflip = jeval.make_ppp_eval_step(jm, flip_test=False, **STEP_KW)
    dark = jeval.make_eval_step_body(jm, **DARK_KW)
    program = jax.jit(lambda p, bs, b: (flip(p, bs, b), noflip(p, bs, b),
                                        dark(p, bs, b)))
    return lambda batch: program(_jparams(variables),
                                 variables["batch_stats"], batch)


@pytest.fixture(scope="module")
def ppp_runs(bundle, batches, jax_steps):
    """The PPP step with and without flip on batch 0, validate_ppp over
    both batches and the DARK eval step on batch 0, in both packages."""
    _, variables, tm = bundle
    ours_b, ref_b = batches
    crit = tcrit.init_criterion_params(2)
    ref = jax_steps(ref_b[0])
    out = {}
    for i, flip in enumerate(("flip", "noflip")):
        step = teval.make_ppp_eval_step(tm, flip_test=flip == "flip",
                                        **STEP_KW)
        out[flip] = (step(crit, ours_b[0]), ref[i])
    out["dark"] = (teval.make_eval_step(tm, **DARK_KW)(crit, ours_b[0]),
                   ref[2])
    logs_t, logs_j = [], []
    out["validate"] = (
        teval.validate_ppp(teval.make_ppp_eval_step(tm, **STEP_KW), crit,
                           ours_b, num_classes=7, log_fn=logs_t.append),
        jeval.validate_ppp(lambda p, bs, b: jax_steps(b)[0],
                           _jparams(variables), variables["batch_stats"],
                           ref_b, num_classes=7, log_fn=logs_j.append))
    out["logs"] = (logs_t, logs_j)
    return out


# --------------------------------------------------------------------------
# The presets.

@pytest.mark.parametrize("name,yaml", [("lip", "experiments/lip/384_384.yaml"),
                                       ("ppp",
                                        "experiments/pascal/384_384.yaml")])
def test_preset_matches_npp_tpu_config(name, yaml):
    cfg = load_config(os.path.join(ROOT, yaml))
    p = tconfig.PRESETS[name]
    assert (p.num_classes, p.num_joints) == (cfg.dataset.num_classes,
                                             cfg.dataset.num_joints)
    assert (tconfig.SIGMA, tconfig.IGNORE) == (cfg.model.sigma,
                                               cfg.train.ignore_label)
    assert p.class_weights == (jcrit.LIP_CLASS_WEIGHTS if name == "lip"
                               else jcrit.PASCAL_CLASS_WEIGHTS)
    # The JAX CLIs' parsing flip pairs (tools/augment_lip.py:228).
    assert p.flip_pairs == (((14, 15), (16, 17), (18, 19)) if name == "lip"
                            else ())
    for net, section in ((p.model, cfg.train), (p.search_model, cfg.search)):
        assert net == dict(num_classes=cfg.dataset.num_classes,
                           num_joints=cfg.dataset.num_joints,
                           layers=section.layers,
                           init_channels=section.init_channels,
                           refine_layers=cfg.model.refine_layers)
    run = dict(ohem_thres=cfg.loss.ohem_thres, ohem_keep=cfg.loss.ohem_keep,
               use_target_weight=cfg.loss.use_target_weight,
               print_freq=cfg.print_freq, workers=cfg.workers,
               crop=tuple(cfg.model.image_size))
    t = cfg.train
    assert p.train == dict(batch_size=t.batch_size, lr=t.lr,
                           lr_step=t.lr_step, lr_factor=t.lr_factor,
                           epochs=t.epochs, num_samples=t.num_samples,
                           begin_epoch=t.begin_epoch, **run)
    s = cfg.search
    assert p.search == dict(batch_size=s.batch_size, w_lr=s.w_lr,
                            alpha_lr=s.alpha_lr, lr_step=s.lr_step,
                            lr_factor=s.lr_factor,
                            warmup_epochs=s.warmup_epochs,
                            entropy_epoch=s.entropy_epoch, epochs=s.epochs,
                            **run)


def test_tiny_presets_and_old_names():
    """The JAX CLIs' --tiny overrides, and the names the CLIs exported
    before the presets existed."""
    for p in tconfig.PRESETS.values():
        model, hp = p.train_config(tiny=True)
        smodel, shp = p.search_config(tiny=True)
        assert model == dict(p.model, layers=8, init_channels=8)
        assert smodel == dict(p.search_model, layers=8, init_channels=8)
        assert (hp["batch_size"], shp["batch_size"]) == (4, 2)
        assert hp["crop"] == shp["crop"] == (128, 128)
    lip = tconfig.LIP
    assert eval_lip.FLAGSHIP == lip.model and eval_lip.TINY["layers"] == 8
    assert (eval_lip.NUM_CLASSES, eval_lip.NUM_JOINTS) == (20, 16)
    assert augment_lip.FLAGSHIP_TRAIN == lip.train
    assert augment_lip.TINY_TRAIN == lip.train_config(True)[1]
    assert search_lip.FLAGSHIP_SEARCH_MODEL == lip.search_model
    assert search_lip.FLAGSHIP_SEARCH == lip.search
    assert search_lip.TINY_SEARCH == lip.search_config(True)[1]


# --------------------------------------------------------------------------
# The metrics.

def _target_maps(seed: int, b: int = 3, j: int = 14, g: int = 16):
    """Rendered (B, J, g, g) target maps: some joints invisible (all-zero
    maps), some midway between two grid centres (two equal maxima)."""
    rng = np.random.default_rng(seed)
    joints = rng.uniform(0, 4 * g, (b, j, 2)).astype(np.float32)
    joints[:, ::4, 0] = 4 * rng.integers(1, g - 1, (b, len(range(0, j, 4))))
    joints[:, ::4, 0] += 3.5  # centres at 1.5 + 4i: x = 4i + 3.5 is a tie
    vis = (rng.random((b, j)) > 0.25).astype(np.float32)
    maps, _ = render_heatmaps_reference(torch.from_numpy(joints),
                                        torch.from_numpy(vis), stride=4,
                                        grid_x=g, grid_y=g, sigma=3.0)
    return maps[..., :j].permute(0, 3, 1, 2).numpy().copy()


def test_np_max_preds_matches_jax_with_ties_and_empty_maps():
    maps = _target_maps(0)
    ties = 0
    for m in maps.reshape(-1, maps.shape[2] * maps.shape[3]):
        ties += int((m == m.max()).sum() > 1 and m.max() > 0)
    assert ties > 0 and (maps.reshape(3, 14, -1).max(2) == 0).any()
    got, ref = tmetrics._np_max_preds(maps), jmetrics._np_max_preds(maps)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", range(3))
def test_heatmap_pck_accuracy_matches_jax(seed):
    """Targets with ties and invisible joints; outputs are the targets
    noised, one image's shifted by a pixel or two, and some maps blanked."""
    rng = np.random.default_rng(seed + 10)
    target = _target_maps(seed)
    output = target + rng.normal(0, 0.02, target.shape).astype(np.float32)
    output[1] = np.roll(output[1], rng.integers(1, 3, 2), axis=(1, 2))
    output[0, :3] = 0.0
    got, ref = (tmetrics.heatmap_pck_accuracy(output, target),
                jmetrics.heatmap_pck_accuracy(output, target))
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1:3] == ref[1:3]
    np.testing.assert_array_equal(got[3], ref[3])
    assert 0 < got[0][0] < 1  # neither all nor none of the joints scored


def test_mul_average_meter_and_ppp_pck_table_match_jax():
    rng = np.random.default_rng(5)
    ours, ref = tmetrics.MulAverageMeter(15), jmetrics.MulAverageMeter(15)
    assert np.array_equal(ours.val(), ref.val())
    for _ in range(4):
        v, n = rng.random(15), int(rng.integers(1, 5))
        ours.update(v, n)
        ref.update(v, n)
    np.testing.assert_array_equal(ours.val(), ref.val())
    pck = ours.val() * 100
    assert tmetrics.ppp_pck_table(pck) == jmetrics.ppp_pck_table(pck)
    assert tmetrics.ppp_pck_table(pck, "x") == jmetrics.ppp_pck_table(pck, "x")


def _ppp_people(rng, n_people: int, noise: float):
    """(GT joints (J, 3), (1, 4) boxes, predictions (J, 2) relative to the
    box corner) for ``n_people`` persons."""
    joints, boxes, preds = [], [], []
    for _ in range(n_people):
        x0, y0 = rng.uniform(0, 200, 2)
        w, h = rng.uniform(40, 160, 2)
        xy = rng.uniform(0, 1, (14, 2)) * (w, h) + (x0, y0)
        vis = (rng.random(14) > 0.2).astype(np.float64)
        joints.append(np.concatenate([xy, vis[:, None]], 1))
        boxes.append(np.array([[x0, y0, x0 + w, y0 + h]]))
        preds.append(xy - (x0, y0) + rng.normal(0, noise, (14, 2)))
    return joints, boxes, preds


def test_cal_oks_matches_jax():
    rng = np.random.default_rng(6)
    joints, boxes, preds = _ppp_people(rng, 4, 6.0)
    for g, b, p in zip(joints, boxes, preds):
        assert tmetrics.cal_oks(g, p, b) == jmetrics.cal_oks(g, p, b)
    assert np.array_equal(tmetrics.PPP_SIGMAS, jmetrics.PPP_SIGMAS)


def _map_fixtures(tmp_path, noise: float, seed: int = 7):
    """Six images: GT written with ``savemat`` and read back with
    ``loadmat`` (one image with no GT person, one listed without a .mat),
    and per-image person predictions (an extra, false person on the image
    without GT and on another; no entry for one image). npp_tpu's
    ``cal_map_image`` raises on an image with GT persons but an empty
    prediction list, and so does the port's."""
    rng = np.random.default_rng(seed)
    gt_dir = tmp_path / "PersonJoints"
    gt_dir.mkdir(exist_ok=True)
    names = [f"im{i}" for i in range(6)]
    preds = {}
    for i, name in enumerate(names):
        n = (0, 1, 2, 3, 1, 2)[i]
        joints, boxes, people = _ppp_people(rng, n, noise)
        if i in (0, 2):
            people.append(rng.uniform(0, 100, (14, 2)))
        if i != 4:
            preds[name] = people
        if i == 5:
            continue  # listed, no .mat
        cell_j = np.empty((1, n), dtype=object)
        cell_b = np.empty((1, n), dtype=object)
        for k in range(n):
            cell_j[0, k], cell_b[0, k] = joints[k], boxes[k]
        scio.savemat(str(gt_dir / f"{name}.mat"),
                     {"joints": cell_j, "boxes": cell_b})
    (tmp_path / "val_id.txt").write_text("\n".join(names) + "\n")
    np.save(tmp_path / "preds.npy", preds, allow_pickle=True)
    return gt_dir, names, preds


@pytest.mark.parametrize("noise", [0.0, 4.0])
def test_oks_map_matches_jax_on_mat_fixtures(tmp_path, noise):
    from tools.eval_ppp_map import load_gt as jload_gt

    gt_dir, names, preds = _map_fixtures(tmp_path, noise)
    gts = eval_ppp_map.load_gt(str(gt_dir), names)
    jgts = jload_gt(str(gt_dir), names)
    assert sorted(gts) == sorted(jgts) == names[:5]
    assert gts["im0"] == ([], [])
    ours = tmetrics.oks_map(preds, gts)
    np.testing.assert_array_equal(ours, jmetrics.oks_map(preds, jgts))
    assert ours.shape == (15,)
    if noise == 0.0:  # predictions equal to the GT: every AP is 1
        np.testing.assert_array_equal(ours, np.ones(15))
    else:
        assert 0 < ours[-1] < 1


def test_eval_ppp_map_cli_matches_jax(tmp_path, monkeypatch, capsys):
    from tools import eval_ppp_map as jtool

    gt_dir, _, _ = _map_fixtures(tmp_path, 4.0)
    args = ["--val-list", str(tmp_path / "val_id.txt"), "--gt-dir",
            str(gt_dir), "--preds", str(tmp_path / "preds.npy")]
    ap = eval_ppp_map.main(args)
    ours = capsys.readouterr().out
    monkeypatch.setattr("sys.argv", ["eval_ppp_map.py", *args])
    jtool.main()
    assert ours == capsys.readouterr().out
    assert len(ours.splitlines()) == 15 and ap.shape == (15,)


# --------------------------------------------------------------------------
# The eval steps.

STEP_KEYS = ("loss", "cm", "par_pred", "pose_hm")


def _check_step_output(key, ours, ref):
    if key == "loss":
        np.testing.assert_allclose(ours["loss"].item(), float(ref["loss"]),
                                   rtol=1e-4)
    elif key == "cm":
        np.testing.assert_array_equal(ours["cm"].numpy(),
                                      np.asarray(ref["cm"]).astype(np.int64))
    elif key == "par_pred":
        np.testing.assert_array_equal(ours["par_pred"].numpy(),
                                      np.asarray(ref["par_pred"]))
    else:
        got, want = _nhwc(ours["pose_hm"]), np.asarray(ref["pose_hm"])
        assert got.shape == want.shape == (BATCH, SIZE // 4, SIZE // 4, 14)
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("key", STEP_KEYS)
@pytest.mark.parametrize("flip", ["flip", "noflip"])
def test_ppp_eval_step_matches_jax(ppp_runs, flip, key):
    ours, ref = ppp_runs[flip]
    _check_step_output(key, ours, ref)


def test_ppp_eval_step_flip_unflips_the_heatmaps(bundle, batches):
    """On a mirror-symmetric image the flipped forward equals the direct
    one, so the fused maps are the mean of the direct maps and their
    joint-remapped mirror image (npp_tpu's unflip)."""
    _, _, tm = bundle
    crit = tcrit.init_criterion_params(2)
    batch = dict(batches[0][0])
    batch["image"] = 0.5 * (batch["image"] + batch["image"].flip(3))
    direct = teval.make_ppp_eval_step(tm, flip_test=False, **STEP_KW)(
        crit, batch)["pose_hm"]
    fused = teval.make_ppp_eval_step(tm, **STEP_KW)(crit, batch)["pose_hm"]
    mirror = direct.index_select(1, torch.as_tensor(FLIPPED_POSEIDX_PPP))
    torch.testing.assert_close(fused, 0.5 * (direct + mirror.flip(3)),
                               rtol=0, atol=0)


@pytest.mark.parametrize("key", ["pck", "mean_iou", "table", "loss"])
def test_validate_ppp_matches_jax(ppp_runs, key):
    (ours, ref), (logs_t, logs_j) = ppp_runs["validate"], ppp_runs["logs"]
    if key == "pck":
        assert ours["pck"].shape == (15,)
        np.testing.assert_array_equal(ours["pck"], ref["pck"])
        assert ours["pck_avg"] == ref["pck_avg"]
    elif key == "mean_iou":
        assert ours["mean_iou"] == ref["mean_iou"]
        np.testing.assert_array_equal(ours["iou_array"], ref["iou_array"])
    elif key == "table":
        assert logs_t == logs_j and len(logs_t) == 1
    else:
        np.testing.assert_allclose(ours["loss"], ref["loss"], rtol=1e-4)


@pytest.mark.parametrize("key", ["loss", "cm", "par_pred", "pose_pred"])
def test_eval_step_dark_ppp_pairs_matches_jax(ppp_runs, key):
    """make_eval_step's new parameters: dark=True, no parsing pairs, the
    PPP joint flip index, blur sigma 2, OHEM threshold 0.7."""
    ours, ref = ppp_runs["dark"]
    if key != "pose_pred":
        return _check_step_output(key, ours, ref)
    got, want = ours["pose_pred"].numpy(), np.asarray(ref["pose_pred"])
    assert got.shape == want.shape == (BATCH, 14, 3)
    assert np.abs(got[..., :2] - want[..., :2]).max() <= 5e-4
    assert (np.abs(got[..., 2] - want[..., 2]).max()
            <= 1e-4 * np.abs(want[..., 2]).max())


# --------------------------------------------------------------------------
# load_pretrained_params.

@pytest.fixture(scope="module")
def search_trees():
    """The tiny supernet (L=4, C=8, 7 classes, 14 joints): the JAX
    parameter tree's shapes in npp_tpu's default (vmapped) layout, and the
    port's state_dict filled from a seeded generator."""
    jshapes = jax.eval_shape(lambda: JSearchNet(dtype=jnp.float32,
                                                **TINY).init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)),
        train=False))["params"]
    with torch.device("meta"):
        sn = SearchNet(**TINY)
    sn.to_empty(device="cpu")
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for t in sn.state_dict().values():
            if t.is_floating_point():
                t.copy_(torch.randn(t.shape, generator=gen))
    return jshapes, sn.state_dict()


def _searched_genotype(tmp_path):
    """A genotype parsed from random architecture parameters, as the port
    and as npp_tpu read it back from the search CLI's JSON."""
    with torch.device("meta"):
        sn = SearchNet(**TINY)
    rng = np.random.default_rng(8)
    arch = {k: rng.normal(0, 1, p.shape).astype(np.float32)
            for k, p in sn.arch_parameters().items()}
    inter, fuse = tgp.extract_genotype(arch)
    path = str(tmp_path / "best_genotype.json")
    tgt.save_genotypes(path, inter, fuse)
    assert (inter, fuse) != (tgt.INTER, tgt.FUSION)
    return tgt.load_genotypes(path), jgt.load_genotypes(path)


def _jax_merge(template, search_params):
    """npp_tpu's merge of ``search_params`` into ``template`` (parameter
    trees of shapes): the loaded and the shape-skipped leaves as the port's
    state_dict names (the bridge's path rule), and its log lines."""
    logs = []
    jmerge(template, search_params, log_fn=logs.append)
    jflat, sflat = flatten_dict(template), flatten_dict(search_params)
    loaded = {convert.torch_key("params", p) for p in jflat
              if p in sflat and sflat[p].shape == jflat[p].shape}
    skipped = {convert.torch_key("params", p) for p in jflat
               if p in sflat and sflat[p].shape != jflat[p].shape}
    return loaded, skipped, logs


@pytest.mark.parametrize("case", ["released", "searched", "wider"])
def test_load_pretrained_params_matches_jax(bundle, search_trees, tmp_path,
                                            case):
    """SearchNet (L=4, C=8) -> NPPNet: the released genotypes at C=8
    (npp_tpu: 620 loaded, 0 shape-skipped), a searched genotype, and the
    released genotypes at C=16 (a width mismatch)."""
    jshapes, pretrained = search_trees
    kw, tkw, jkw = dict(TINY), {}, {}
    if case == "searched":
        (ti, tf), (ji, jf) = _searched_genotype(tmp_path)
        tkw, jkw = dict(inter=ti, fusion=tf), dict(inter=ji, fusion=jf)
    if case == "wider":
        kw["init_channels"] = 16
    if case == "released":
        template = bundle[1]["params"]
    else:
        template = jax.eval_shape(lambda: JNPPNet(
            dtype=jnp.float32, **kw, **jkw).init(
            jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)),
            train=False))["params"]
    j_loaded, j_skipped, logs = _jax_merge(template, jshapes)

    model = build_nppnet(device="cpu", dtype=torch.float32,
                         generator=torch.Generator().manual_seed(2),
                         **kw, **tkw)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tlogs = []
    loaded, skipped = load_pretrained_params(model, pretrained,
                                             log_fn=tlogs.append)
    assert set(loaded) == j_loaded and len(loaded) == len(j_loaded)
    assert set(skipped) == j_skipped and len(skipped) == len(j_skipped)
    assert tlogs[-1].startswith(logs[-1] + ",")
    if case == "released":
        assert (len(loaded), len(skipped)) == (620, 0)
    if case == "wider":
        assert skipped and loaded
    after = model.state_dict()
    for k, v in after.items():
        if k in loaded:
            assert torch.equal(v, pretrained[k]), k
        else:  # shape-skipped, no counterpart, and every buffer: kept
            assert torch.equal(v, before[k]), k


def test_load_pretrained_params_reference_widths():
    """SearchNet L=16, C=32 -> NPPNet L=16, C=64 (the reference search
    and train widths): the port's merge on the meta device loads and
    shape-skips the parameters that npp_tpu's merge does on its
    ``jax.eval_shape`` trees (its default search layout): 38 and 1,328
    of 1,640."""
    x = jnp.zeros((1, SIZE, SIZE, 3))
    jsearch = jax.eval_shape(lambda: JSearchNet(
        dtype=jnp.float32, **tconfig.LIP.search_model).init(
        jax.random.PRNGKey(0), x, train=False))["params"]
    jnet = jax.eval_shape(lambda: JNPPNet(
        dtype=jnp.float32, **tconfig.LIP.model).init(
        jax.random.PRNGKey(0), x, train=False))["params"]
    j_loaded, j_skipped, logs = _jax_merge(jnet, jsearch)
    with torch.device("meta"):
        sn = SearchNet(**tconfig.LIP.search_model)
        net = NPPNet(**tconfig.LIP.model)
    tlogs = []
    loaded, skipped = load_pretrained_params(net, sn.state_dict(),
                                             log_fn=tlogs.append)
    assert set(loaded) == j_loaded and len(loaded) == len(j_loaded)
    assert set(skipped) == j_skipped and len(skipped) == len(j_skipped)
    assert tlogs[-1].startswith(logs[-1] + ",")
    assert (len(loaded), len(skipped)) == (38, 1328)
    assert len(list(net.parameters())) == len(flatten_dict(jnet)) == 1640


# --------------------------------------------------------------------------
# The CLIs.

@pytest.fixture(scope="module")
def ppp_search(tmp_path_factory):
    out_root = tmp_path_factory.mktemp("ppp_search")
    out = search_lip.main(["--synthetic", "--dataset", "ppp", *CPU,
                           "--steps", "1", "--epochs", "1",
                           "--warmup-epochs", "0", "--out", str(out_root)])
    return out, out_root


def test_search_cli_ppp_runs_tiny_on_cpu(ppp_search):
    out, out_root = ppp_search
    assert np.isfinite(out["train_loss"]) and np.isfinite(
        out["result"]["loss"])
    assert out["result"]["pose_preds"].shape == (2, 14, 3)
    assert out["result"]["cm"].shape == (7, 7)
    assert out["state"].model.layers == 8
    assert out["out_dir"].startswith(str(out_root / "ppp" / "search"))
    assert os.path.isfile(os.path.join(out["out_dir"], "best_genotype.json"))


def test_train_cli_ppp_runs_tiny_on_cpu(tmp_path, capsys):
    out = augment_lip.main(["--synthetic", "--dataset", "ppp", *CPU,
                            "--steps", "2", "--epochs", "1", "--out",
                            str(tmp_path)])
    res = out["result"]
    assert np.isfinite(out["train_loss"]) and np.isfinite(res["loss"])
    assert res["pck"].shape == (15,) and res["cm"].shape == (7, 7)
    assert res["cm"].sum() == 4 * 128 * 128  # one val batch of 4, no ignore
    assert "PCK@0.5" in capsys.readouterr().err
    assert out["checkpoints"].startswith(str(tmp_path / "ppp" / "augment"))
    with open(os.path.join(out["checkpoints"], "meta_0.json")) as f:
        assert json.load(f)["pck"] == res["pck_avg"]


def test_search_train_eval_chain_tiny_on_cpu(ppp_search, tmp_path, capsys):
    """search_lip -> augment_lip --genotype --pretrained-encoder ->
    eval_lip --ckpt --genotype --pred-csv --json-out. The search ran on
    PPP (7 classes), the training on LIP (20): the encoder loads, the
    class heads are shape-skipped."""
    search = ppp_search[0]
    genotype = os.path.join(search["out_dir"], "best_genotype.json")
    train = augment_lip.main(["--synthetic", *CPU, "--steps", "1",
                              "--epochs", "1", "--out", str(tmp_path),
                              "--genotype", genotype, "--pretrained-encoder",
                              search["checkpoints"]])
    n_params = len(list(train["state"].model.parameters()))
    loaded, skipped = train["merged"]
    assert loaded > 0 and skipped > 0 and loaded + skipped <= n_params
    err = capsys.readouterr().err
    assert (f"pretrained merge: {loaded} loaded, {skipped} shape-skipped, "
            f"{n_params - loaded - skipped} without a counterpart, of "
            f"{n_params} parameters") in err
    inter, fuse = tgt.load_genotypes(genotype)
    with torch.device("meta"):
        searched = NPPNet(inter=inter, fusion=fuse, **eval_lip.TINY)
    shapes = lambda m: {k: v.shape for k, v in m.state_dict().items()}
    assert shapes(train["state"].model) == shapes(searched)
    csv, js = str(tmp_path / "pred.csv"), str(tmp_path / "m.json")
    res = eval_lip.main(["--synthetic", *CPU, "--batch", "2",
                         "--ckpt", train["checkpoints"], "--genotype",
                         genotype, "--pred-csv", csv, "--json-out", js])
    with open(js) as f:
        blob = json.load(f)
    assert blob["loss"] == res["loss"] and blob["mean_iou"] == res["mean_iou"]
    assert set(blob) >= {"mean_iou", "pixel_acc", "loss", "iou_array"}
    assert not set(blob) & {"pose_preds", "names", "cm"}
    with open(csv) as f:
        rows = f.read().splitlines()
    assert len(rows) == 4 and rows[0].startswith("synthetic_000000,")
    assert len(rows[0].split(",")) == 1 + 2 * 16
