"""The port's serving slice against npp_tpu on the CPU: the cv2-free
resizes, the preprocess and postprocess, the quarter-offset and DARK
decodes, the scale-list pose fusion, the PCKh metrics and CSVs, the PNG
writer and reader, the multi-scale parsing inference, the Predictor and
the predict / test_lip CLIs.

The model is the tiny NPPNet (L=8, C=8, 20 classes, 16 joints) at a
64x64 crop, its flax tree filled from a numpy RNG and carried into the
port through the weight bridge (as tests/test_torch_model.py). Three JAX
programs are compiled, once each, in module-scoped fixtures: the
single-scale Predictor, the pose-scales + DARK Predictor and one
multi-scale inference (~40 s together). Tolerances:

- bicubic resize and preprocess canvas: within 1 grey level of cv2
  (cv2 sums in fixed point or float by version; the share of pixels
  that differ is printed); crop params and scale equal;
- nearest resize and ``_postprocess``: equal to cv2;
- decodes and the pose fusion: atol 1e-5;
- multi-scale inference: atol 1e-4 (fp32 convs summed in another order);
- Predictor on npp_tpu's canvases: keypoints within 1e-4 px of the
  crop's grid (in image coordinates that is 1e-4 / scale), 5e-4 px with
  the DARK step (it divides the log-map's gradient by its curvature, about
  0.02 on a map blurred at sigma 3, so it magnifies the fused maps' fp32
  rounding ~50x; seen: 1.6e-4), peak scores within 1e-6 + 1e-5 relative;
  labels equal except where the top-2 margin of the
  fused logits is under 1e-4 (two argmaxes can part only there);
- PCKh functions, CSVs and PNG pixels/palettes: exact.
"""
import dataclasses
import struct
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

cv2 = pytest.importorskip("cv2")

from npp_tpu.core import evaluate as jeval  # noqa: E402
from npp_tpu.core import inference as jinf  # noqa: E402
from npp_tpu.core import multiscale as jms  # noqa: E402
from npp_tpu.core import test_seg as jts  # noqa: E402
from npp_tpu.core.predictor import Predictor as JPredictor  # noqa: E402
from npp_tpu.models.augment import NPPNet as JNPPNet  # noqa: E402
from npp_tpu.utils import metrics as jmetrics  # noqa: E402
from npp_tpu.utils import vis as jvis  # noqa: E402

from npp_tpu_torch import genotypes as tgt  # noqa: E402
from npp_tpu_torch.core import evaluate as teval  # noqa: E402
from npp_tpu_torch.core import inference as tinf  # noqa: E402
from npp_tpu_torch.core import loading  # noqa: E402
from npp_tpu_torch.core import multiscale as tms  # noqa: E402
from npp_tpu_torch.core import predictor as tpred  # noqa: E402
from npp_tpu_torch.core import test_seg as tts  # noqa: E402
from npp_tpu_torch.models.augment import build_nppnet  # noqa: E402
from npp_tpu_torch.ops.resize import resize_bilinear  # noqa: E402
from npp_tpu_torch.tools import augment_lip, predict, test_lip  # noqa: E402
from npp_tpu_torch.utils import convert  # noqa: E402
from npp_tpu_torch.utils import metrics as tmetrics  # noqa: E402
from npp_tpu_torch.utils import vis as tvis  # noqa: E402

from test_torch_model import _peaked_heatmaps  # noqa: E402
from test_torch_ops import random_variables  # noqa: E402

torch.set_num_threads(1)
TINY = dict(num_classes=20, num_joints=16, layers=8, init_channels=8,
            refine_layers=1)
CROP = 64
GREY_ATOL = 1        # grey levels, canvas vs cv2
DECODE_ATOL = 1e-5
MS_ATOL = 1e-4
KP_ATOL = 1e-4       # crop px, Predictor keypoints vs JAX
DARK_KP_ATOL = 5e-4  # crop px, the same with the DARK step
MARGIN = 1e-4        # top-2 logit margin under which labels may differ
POSE_SCALES = (0.8, 1.0, 1.2)
# (h, w): smaller than the crop, odd sizes, both orientations, large.
SIZES = ((31, 47), (100, 80), (50, 90), (64, 64), (333, 517), (701, 299))


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


def _images(seed, sizes=SIZES):
    rng = np.random.default_rng(seed)
    ims = []
    for i, (h, w) in enumerate(sizes):
        im = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        # Smooth bright blobs, so that the model sees structure.
        yy, xx = np.mgrid[:h, :w]
        blob = np.exp(-(((yy - h * 0.4) / (0.2 * h)) ** 2
                        + ((xx - w * (0.3 + 0.1 * i)) / (0.2 * w)) ** 2))
        ims.append(np.clip(im * 0.5 + 120 * blob[..., None], 0, 255)
                   .astype(np.uint8))
    return ims


# -- host-side geometry ------------------------------------------------------

@pytest.mark.parametrize("h,w,scale", [
    (200, 160, 384 / 200), (1280, 720, 0.3), (333, 517, 384 / 517),
    (640, 480, 0.6), (31, 47, 64 / 47), (77, 1000, 0.4608)])
def test_resize_cubic_within_one_grey_level_of_cv2(h, w, scale):
    im = np.random.default_rng(h + w).integers(0, 256, (h, w, 3)).astype(
        np.uint8)
    ours = tpred.resize_cubic_u8(im, scale)
    ref = cv2.resize(im, None, fx=scale, fy=scale,
                     interpolation=cv2.INTER_CUBIC)
    assert ours.shape == ref.shape
    d = np.abs(ours.astype(int) - ref.astype(int))
    print(f"cubic {h}x{w} x{scale:.4f}: {(d > 0).mean():.5f} of the "
          f"pixels differ, by {d.max()} at most")
    assert d.max() <= GREY_ATOL


@pytest.mark.parametrize("scale_mult", (1.0, 0.8, 1.2))
def test_preprocess_matches_jax(bundle, scale_mult):
    jm, variables, tm = bundle
    jp = JPredictor(jm, variables, crop_size=(CROP, CROP))
    tp = tpred.Predictor(tm, crop_size=(CROP, CROP))
    for im in _images(1):
        canvas, cp, scale = tp.preprocess(im, scale_mult)
        ref_c, ref_cp, ref_s = jp.preprocess(im, scale_mult)
        np.testing.assert_array_equal(cp, ref_cp)
        assert scale == ref_s
        d = np.abs(canvas.astype(int) - ref_c.astype(int))
        print(f"canvas of {im.shape[:2]} x{scale_mult}: {(d > 0).mean():.5f} "
              f"of the pixels differ")
        assert canvas.dtype == np.uint8 and d.max() <= GREY_ATOL


@pytest.mark.parametrize("src,dst", [((50, 40), (101, 79)),
                                     ((384, 307), (200, 160)),
                                     ((17, 23), (17, 23)),
                                     ((96, 96), (1280, 721))])
def test_resize_nearest_equals_cv2(src, dst):
    im = np.random.default_rng(3).integers(0, 20, src).astype(np.uint8)
    ref = cv2.resize(im, (dst[1], dst[0]), interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(tpred.resize_nearest_u8(im, dst), ref)


def test_postprocess_equals_jax(bundle):
    jm, variables, tm = bundle
    jp = JPredictor(jm, variables, crop_size=(CROP, CROP))
    tp = tpred.Predictor(tm, crop_size=(CROP, CROP))
    rng = np.random.default_rng(4)
    for im in _images(2):
        _, cp, scale = jp.preprocess(im)
        crop = rng.integers(0, 20, (CROP, CROP)).astype(np.uint8)
        kp = rng.random((16, 3)).astype(np.float32)
        ours = tp._postprocess(im, crop, cp, np.float32(scale), kp)
        ref = jp._postprocess(im, crop, cp, np.float32(scale), kp)
        np.testing.assert_array_equal(ours["parsing"], ref["parsing"])
        assert ours["parsing"].shape == im.shape[:2]


# -- decodes -------------------------------------------------------------------

def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def test_quarter_offset_and_dark_match_jax():
    hm = _peaked_heatmaps(11, b=3, g=24)
    blurred = np.asarray(jinf.gaussian_blur(jnp.asarray(hm), 3.0))
    preds, _ = jinf.get_max_preds(jnp.asarray(blurred))
    preds = np.array(preds)
    preds[0, :3] = [[0, 5], [23, 1], [1, 22]]  # on and next to the border
    blurred = np.array(blurred)
    for jfn, tfn in ((jinf.post_process_quarter_offset,
                      tinf.post_process_quarter_offset),
                     (jinf.post_process_dark, tinf.post_process_dark)):
        ref = np.asarray(jfn(jnp.asarray(preds), jnp.asarray(blurred)))
        ours = tfn(torch.from_numpy(preds), _nchw(blurred)).numpy()
        np.testing.assert_allclose(ours, ref, atol=DECODE_ATOL)
        assert not np.array_equal(ref, preds)  # the step did move peaks


@pytest.mark.parametrize("dark", (False, True))
def test_decode_pose_with_dark_matches_jax(dark):
    hm, fl = _peaked_heatmaps(5), _peaked_heatmaps(6)
    cp = np.tile(np.array([[[3, 5, 1, 2, 90, 90, 96, 96]]], np.float32),
                 (2, 1, 1))
    scale = np.array([1.0, 1.25], np.float32)
    ref = np.asarray(jinf.decode_pose_validate(
        jnp.asarray(hm), jnp.asarray(fl), jnp.asarray(cp),
        jnp.asarray(scale), out_hw=(96, 96), dark=dark))
    ours = tinf.decode_pose_validate(
        _nchw(hm), _nchw(fl), torch.from_numpy(cp), torch.from_numpy(scale),
        out_hw=(96, 96), dark=dark).numpy()
    np.testing.assert_allclose(ours[..., :2], ref[..., :2], atol=DECODE_ATOL)
    np.testing.assert_allclose(ours[..., 2], ref[..., 2], rtol=1e-5)
    fused = np.asarray(jinf.decode_pose_fused(
        jnp.asarray(hm), jnp.asarray(cp), jnp.asarray(scale), dark=dark))
    ours = tinf.decode_pose_fused(_nchw(hm), torch.from_numpy(cp),
                                  torch.from_numpy(scale), dark=dark).numpy()
    np.testing.assert_allclose(ours[..., :2], fused[..., :2],
                               atol=DECODE_ATOL)


def test_fuse_multiscale_pose_matches_jax(bundle):
    jm, variables, _ = bundle
    jp = JPredictor(jm, variables, crop_size=(CROP, CROP))
    ims = _images(6, ((100, 80), (50, 90)))
    cps = np.stack([np.stack([jp.preprocess(im, m)[1] for im in ims])
                    for m in POSE_SCALES])                   # (S, B, 1, 8)
    rng = np.random.default_rng(7)
    hm = rng.random((3, 2, CROP, CROP, 16)).astype(np.float32)
    ref = np.asarray(jinf.fuse_multiscale_pose(jnp.asarray(hm),
                                               jnp.asarray(cps), POSE_SCALES,
                                               1))
    ours = tinf.fuse_multiscale_pose(
        torch.from_numpy(hm).permute(0, 1, 4, 2, 3), torch.from_numpy(cps),
        POSE_SCALES, 1).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(ours, ref, atol=DECODE_ATOL)
    assert (ref == 0).any() and (ref > 0).any()  # the valid-region mask


# -- metrics and files ---------------------------------------------------------

def _pose_csvs(tmp_path, n=6):
    rng = np.random.default_rng(8)
    names = [f"im_{i:03d}" for i in range(n)]
    gt = rng.uniform(0, 300, (n, 16, 2)).round(1)
    vis = (rng.random((n, 16)) > 0.2).astype(int)
    gt_path = str(tmp_path / "gt.csv")
    with open(gt_path, "w") as f:
        for i, name in enumerate(names):
            vals = []
            for j in range(16):
                missing = (i + j) % 11 == 0
                vals += (["nan", "nan"] if missing
                         else [f"{gt[i, j, 0]}", f"{gt[i, j, 1]}"])
                vals.append(str(vis[i, j]))
            f.write(",".join([name] + vals) + "\n")
    pose = gt[:, np.argsort(tmetrics.IDX_MAP_TO_LIP)] + rng.normal(
        0, 8, (n, 16, 2))
    return names, pose, gt_path


def test_pckh_functions_and_csvs_match_jax(tmp_path):
    names, pose, gt_path = _pose_csvs(tmp_path)
    ours_csv, ref_csv = str(tmp_path / "ours.csv"), str(tmp_path / "ref.csv")
    tmetrics.save_pose_csv(names, pose, ours_csv)
    jmetrics.save_pose_csv(names, pose, ref_csv)
    with open(ours_csv, "rb") as a, open(ref_csv, "rb") as b:
        assert a.read() == b.read()
    for has_vis, path in ((True, gt_path), (False, ours_csv)):
        for o, r in zip(tmetrics.read_pose_csv(path, has_vis),
                        jmetrics.read_pose_csv(path, has_vis)):
            np.testing.assert_array_equal(o, r)
    gt, vis = tmetrics.read_pose_csv(gt_path, True)
    pred, _ = tmetrics.read_pose_csv(ours_csv, False)
    np.testing.assert_array_equal(tmetrics.get_head_size(gt),
                                  jmetrics.get_head_size(gt))
    ref_d = jmetrics.norm_dist(pred, gt, jmetrics.get_head_size(gt))
    np.testing.assert_array_equal(
        tmetrics.norm_dist(pred, gt, tmetrics.get_head_size(gt)), ref_d)
    th = (0.1, 0.5)
    np.testing.assert_array_equal(tmetrics.compute_pck(ref_d, th),
                                  jmetrics.compute_pck(ref_d, th))
    np.testing.assert_array_equal(tmetrics.pckh_from_arrays(pred, gt, vis),
                                  jmetrics.pckh_from_arrays(pred, gt, vis))
    pck = tmetrics.calc_pck_lip(gt_path, ours_csv, eval_num=5)
    np.testing.assert_array_equal(pck, jmetrics.calc_pck_lip(
        gt_path, ours_csv, eval_num=5))
    assert tmetrics.pckh_table(pck[-1]) == jmetrics.pckh_table(pck[-1])
    assert tmetrics.IDX_MAP_TO_LIP == jmetrics.IDX_MAP_TO_LIP


def test_validate_writes_the_csv_and_pckh_as_jax(tmp_path):
    """Both packages' ``validate`` on one stub eval step: the same CSV
    bytes, the same PCKh table and average."""
    names, pose, gt_path = _pose_csvs(tmp_path)
    cm = np.eye(20, dtype=np.float32)
    groups = (np.arange(4), np.arange(4, 6))
    loader = [{"names": [names[i] for i in g], "index": g} for g in groups]
    logs = {"ours": [], "ref": []}

    def outputs():
        for g in groups:
            kp = np.concatenate([pose[g], np.ones((len(g), 16, 1))], -1)
            yield cm, np.float32(0.5), kp.astype(np.float32)

    t_out, j_out = outputs(), outputs()

    def t_step(_, batch):
        c, loss, kp = next(t_out)
        return {"cm": torch.from_numpy(c), "loss": torch.tensor(loss),
                "pose_pred": torch.from_numpy(kp)}

    def j_step(_, __, batch):
        c, loss, kp = next(j_out)
        return {"cm": jnp.asarray(c), "loss": jnp.asarray(loss),
                "pose_pred": jnp.asarray(kp)}

    ours = teval.validate(t_step, None, loader, num_classes=20,
                          pred_csv=str(tmp_path / "o.csv"), gt_csv=gt_path,
                          log_fn=logs["ours"].append)
    ref = jeval.validate(j_step, None, None, loader, num_classes=20,
                         pred_csv=str(tmp_path / "r.csv"), gt_csv=gt_path,
                         log_fn=logs["ref"].append)
    with open(tmp_path / "o.csv", "rb") as a, open(tmp_path / "r.csv",
                                                   "rb") as b:
        assert a.read() == b.read()
    np.testing.assert_array_equal(ours["pck"], ref["pck"])
    assert ours["pck_avg"] == ref["pck_avg"]
    assert logs["ours"] == logs["ref"] and "PCKh@0.5" in logs["ours"][0]


def test_save_parsing_png_matches_pil_and_round_trips(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    labels = np.random.default_rng(9).integers(0, 20, (37, 53)).astype(
        np.uint8)
    ours, ref = str(tmp_path / "ours.png"), str(tmp_path / "ref.png")
    tvis.save_parsing_png(labels, ours, 20)
    jvis.save_parsing_png(labels, ref, 20)
    a, b = Image.open(ours), Image.open(ref)
    assert a.mode == b.mode == "P"
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert a.getpalette()[:60] == b.getpalette()[:60] == tvis.get_palette(20)
    for path in (ours, ref):
        pix, pal = tvis.read_png(path)
        np.testing.assert_array_equal(pix, labels)
        np.testing.assert_array_equal(pal[:20].reshape(-1),
                                      tvis.get_palette(20))
    assert tvis.get_palette(33) == jvis.get_palette(33)
    np.testing.assert_array_equal(tvis.colorize_parsing(labels),
                                  jvis.colorize_parsing(labels))


def _png_with_filters(pix: np.ndarray, ctype: int) -> bytes:
    """An 8-bit PNG whose row y uses filter type y % 5."""
    h, w = pix.shape[:2]
    bpp = 1 if pix.ndim == 2 else pix.shape[2]
    rows = pix.reshape(h, w * bpp).astype(np.int64)
    out = bytearray()
    for y in range(h):
        ft, cur = y % 5, rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        if ft == 0:
            pred = np.zeros_like(cur)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = up
        elif ft == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        out += bytes([ft]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes()

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("ctype,channels", [(0, 1), (2, 3), (6, 4)])
def test_read_png_undoes_all_five_filters(tmp_path, ctype, channels):
    shape = (11, 13) if channels == 1 else (11, 13, channels)
    pix = np.random.default_rng(ctype).integers(0, 256, shape).astype(np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_png_with_filters(pix, ctype))
    got, pal = tvis.read_png(str(path))
    assert pal is None
    np.testing.assert_array_equal(got, pix)
    rgb = tvis.read_image(str(path))
    assert rgb.shape == (11, 13, 3) and rgb.dtype == np.uint8
    np.testing.assert_array_equal(rgb[..., 0], pix if channels == 1
                                  else pix[..., 0])


def test_read_image_takes_png_npy_and_names_other_formats(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    im = np.random.default_rng(10).integers(0, 256, (20, 30, 3)).astype(
        np.uint8)
    Image.fromarray(im).save(tmp_path / "a.png")
    np.save(tmp_path / "b.npy", im)
    np.testing.assert_array_equal(tvis.read_image(str(tmp_path / "a.png")),
                                  im)
    np.testing.assert_array_equal(tvis.read_image(str(tmp_path / "b.npy")),
                                  im)
    with pytest.raises(ValueError, match=r"\.bmp format"):
        tvis.read_image(str(tmp_path / "c.bmp"))


# -- multi-scale parsing -------------------------------------------------------

def test_multi_scale_inference_matches_jax(bundle):
    jm, variables, tm = bundle
    image = np.random.default_rng(12).normal(0, 1, (1, 90, 70, 3)).astype(
        np.float32)
    kw = dict(num_classes=20, crop_size=(CROP, CROP), scales=(0.75, 1.0, 1.5),
              flip=True)
    ref = jms.multi_scale_inference(jts.make_parsing_apply_fn(jm), image,
                                    params=variables, **kw)
    ours = tms.multi_scale_inference(tts.make_parsing_apply_fn(tm),
                                     _nchw(image), chunk=5, **kw)
    assert ours.shape == (1, 20, 90, 70)
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), ref,
                               atol=MS_ATOL, rtol=MS_ATOL)


@pytest.mark.parametrize("length,crop,stride", [(64, 64, 42), (65, 64, 42),
                                                (150, 64, 42), (30, 64, 42)])
def test_tile_origins_match_jax(length, crop, stride):
    assert tms._tile_origins(length, crop, stride) == jms._tile_origins(
        length, crop, stride)


@pytest.mark.parametrize("pad_value,base_size", [
    (0.0, None), ((0.5, -1.0, 2.0), None), (0.0, 80)])
def test_multi_scale_padding_and_base_size_match_jax(pad_value, base_size):
    """The windows' padding fill and the base size, through a model-free
    apply_fn (3 'classes' = the tile's channels), so that the fill
    reaches the output."""
    image = np.random.default_rng(16).normal(0, 1, (1, 50, 37, 3)).astype(
        np.float32)
    kw = dict(num_classes=3, crop_size=(32, 32), scales=(0.8, 1.0, 1.7),
              flip=True, pad_value=pad_value, base_size=base_size)
    ref = jms.multi_scale_inference(lambda t: t * 0.5, image, **kw)
    ours = tms.multi_scale_inference(lambda t: t * 0.5, _nchw(image), **kw)
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), ref,
                               atol=1e-5, rtol=1e-5)


def test_testval_counts_every_valid_pixel(bundle):
    _, _, tm = bundle
    from npp_tpu_torch.data.loader import DataLoader
    from npp_tpu_torch.data.synthetic import SyntheticDataset
    ds = SyntheticDataset(length=2, crop_size=(CROP, CROP), is_train=False)
    loader = DataLoader(ds, 1, device="cpu", num_workers=1)
    res = tts.testval(tts.make_parsing_apply_fn(tm), loader, num_classes=20,
                      scales=(0.5, 1.0), crop_size=(CROP, CROP))
    assert int(res["cm"].sum()) == 2 * CROP * CROP
    assert 0.0 <= res["mean_iou"] <= 1.0


# -- the Predictor -------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_predictions(bundle):
    """JAX Predictor outputs (single scale; pose scales + DARK) on the
    same images, and npp_tpu's preprocess for feeding the port."""
    jm, variables, _ = bundle
    ims = _images(13, SIZES[:4])
    single = JPredictor(jm, variables, crop_size=(CROP, CROP))
    ms = JPredictor(jm, variables, crop_size=(CROP, CROP),
                    pose_scales=POSE_SCALES, dark_decode=True)
    return ims, single.preprocess, {"single": single.predict_batch(ims),
                                    "ms": ms.predict_batch(ims)}


def _fused_logits(model, pre):
    """The port's flip-fused parsing logits at crop size, for npp_tpu's
    preprocess outputs ``pre``."""
    single = tpred.Predictor(model, crop_size=(CROP, CROP))
    canvases = torch.from_numpy(np.stack([p[0] for p in pre]))
    cps = torch.from_numpy(np.stack([p[1] for p in pre]))[None]
    return single.fuse(canvases, cps)[0].numpy()


@pytest.mark.parametrize("variant", ("single", "ms"))
def test_predictor_matches_jax_on_its_canvases(bundle, jax_predictions,
                                               variant):
    _, _, tm = bundle
    ims, jax_preprocess, ref = jax_predictions
    kw = (dict(pose_scales=POSE_SCALES, dark_decode=True)
          if variant == "ms" else {})
    tp = tpred.Predictor(tm, crop_size=(CROP, CROP), **kw)
    tp.preprocess = jax_preprocess
    ours = tp.predict_batch(ims)
    logits = _fused_logits(tm, [jax_preprocess(im) for im in ims])
    top2 = np.sort(logits, axis=1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    n_diff = 0
    for i, (o, r) in enumerate(zip(ours, ref[variant])):
        scale = jax_preprocess(ims[i])[2]
        np.testing.assert_allclose(o["keypoints"][:, :2] * scale,
                                   r["keypoints"][:, :2] * scale,
                                   atol=DARK_KP_ATOL if variant == "ms"
                                   else KP_ATOL, rtol=0)
        np.testing.assert_allclose(o["keypoints"][:, 2],
                                   r["keypoints"][:, 2], rtol=1e-5,
                                   atol=1e-6)
        diff = o["parsing_crop"] != r["parsing_crop"]
        assert (margin[i][diff] < MARGIN).all()
        n_diff += int(diff.sum())
        if not diff.any():
            np.testing.assert_array_equal(o["parsing"], r["parsing"])
        assert o["parsing"].shape == ims[i].shape[:2]
    print(f"{variant}: {n_diff} crop labels differ, all at margins < "
          f"{MARGIN}")


def test_predictor_padding_stream_and_scale_rules(bundle):
    """Padding rows are invisible; the stream yields the batch's results
    in order; pose_scales=(1.0,) is the single-scale path; scales without
    1.0 raise; an exception in the stream's worker reaches the caller."""
    _, _, tm = bundle
    tp = tpred.Predictor(tm, crop_size=(CROP, CROP))
    ims = _images(14, ((100, 80), (64, 64), (50, 90), (71, 33), (40, 40),
                       (90, 91)))
    three = tp.predict_batch(ims[:3])
    eight = tp.predict_batch(ims[:3] + ims[:5])
    for a, b in zip(three, eight[:3]):
        np.testing.assert_array_equal(a["parsing"], b["parsing"])
        np.testing.assert_array_equal(a["keypoints"], b["keypoints"])
    streamed = list(tp.predict_stream(iter(ims), batch_size=2))
    direct = tp.predict_batch(ims)
    assert len(streamed) == len(ims)
    for s, d in zip(streamed, direct):
        np.testing.assert_array_equal(s["parsing"], d["parsing"])
        np.testing.assert_array_equal(s["keypoints"], d["keypoints"])
    base = tpred.Predictor(tm, crop_size=(CROP, CROP), pose_scales=(1.0,))
    for a, b in zip(base.predict_batch(ims), direct):
        np.testing.assert_array_equal(a["keypoints"], b["keypoints"])
    with pytest.raises(ValueError, match="must contain"):
        tpred.Predictor(tm, crop_size=(CROP, CROP), pose_scales=(0.8, 1.2))

    def failing():
        yield ims[0]
        raise OSError("unreadable image")
    with pytest.raises(OSError, match="unreadable"):
        list(tp.predict_stream(failing(), batch_size=1))


# -- loading and the CLIs ------------------------------------------------------

CPU = ["--tiny", "--device", "cpu", "--dtype", "float32"]


def test_predict_cli_synthetic_writes_pngs_and_csv(tmp_path):
    out = predict.main(["--synthetic", "3", "--batch", "2", "--out",
                        str(tmp_path), *CPU])
    for name, labels in zip(out["names"], out["parsings"]):
        pix, pal = tvis.read_png(str(tmp_path / f"{name}.png"))
        np.testing.assert_array_equal(pix, labels)
    with open(out["csv"]) as f:
        rows = f.read().splitlines()
    assert len(rows) == 3 and len(rows[0].split(",")) == 33
    ms = predict.main(["--synthetic", "2", "--pose-scales", "0.8, 1.0,,1.2,1.0",
                       "--dark", "--no-flip", "--out", str(tmp_path / "ms"),
                       *CPU])
    assert all(np.isfinite(k).all() for k in ms["keypoints"])
    assert predict.parse_pose_scales("1.0,0.8,1.0") == (1.0, 0.8)
    with pytest.raises(SystemExit, match="not a number"):
        predict.parse_pose_scales("1.0,x")


def test_predict_cli_reads_png_and_npy_and_refuses_the_rest(tmp_path):
    ims = _images(15, ((100, 80), (60, 90)))
    src = tmp_path / "in"
    src.mkdir()
    tvis.save_parsing_png(ims[0][..., 0] // 13, str(src / "a.png"), 20)
    np.save(src / "b.npy", ims[1])
    out = predict.main(["--images", str(src), "--out", str(tmp_path / "o"),
                        *CPU])
    assert out["names"] == ["a", "b"]
    assert out["parsings"][0].shape == (100, 80)
    assert out["parsings"][1].shape == (60, 90)
    (src / "c.bmp").write_bytes(b"")
    with pytest.raises(SystemExit, match=r"\.bmp format"):
        predict.main(["--images", str(src), "--out", str(tmp_path), *CPU])
    (src / "c.bmp").unlink()
    np.save(src / "a.npy", ims[1])
    with pytest.raises(SystemExit, match="duplicate"):
        predict.main(["--images", str(src), "--out", str(tmp_path), *CPU])


def test_load_eval_model_from_train_checkpoint_and_genotype(tmp_path):
    """train -> serve: the train CLI's checkpoint directory loads into the
    serving model; search -> serve: a genotype JSON builds the net."""
    run = augment_lip.main(["--synthetic", "--steps", "1", "--epochs", "1",
                            "--out", str(tmp_path), *CPU])
    model, size, _ = loading.load_eval_model(run["checkpoints"], tiny=True,
                                             device="cpu",
                                             dtype=torch.float32,
                                             log_fn=lambda s: None)
    assert size == (128, 128) and not model.training
    trained = run["state"].model.state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, trained[k]), k
    path = str(tmp_path / "g.json")
    inter = dataclasses.replace(tgt.INTER, task1=tuple(
        tuple(("se_connect", i) for _, i in g) for g in tgt.INTER.task1))
    tgt.save_genotypes(path, inter, tgt.FUSION)
    built, _, kw = loading.load_eval_model(genotype=path, tiny=True,
                                           device="cpu", dtype=torch.float32,
                                           log_fn=lambda s: None)
    assert kw["inter"] == inter and kw["fusion"] == tgt.FUSION
    assert sum(p.numel() for p in built.parameters()) != sum(
        p.numel() for p in model.parameters())
    with pytest.raises(FileNotFoundError):
        loading.load_eval_model(str(tmp_path / "none"), tiny=True,
                                device="cpu", log_fn=lambda s: None)


@pytest.mark.parametrize("mode", ("testval", "test"))
def test_test_lip_cli_runs_tiny_on_cpu(tmp_path, mode):
    out = test_lip.main(["--synthetic", "--mode", mode, "--limit", "1",
                         "--out", str(tmp_path), *CPU])
    if mode == "testval":
        assert int(out["cm"].sum()) == 128 * 128
    else:
        pix, _ = tvis.read_png(out["paths"][0])
        assert pix.shape == (128, 128)
