"""The port's host helpers against npp_tpu and cv2 on the CPU, no JAX
program: the keypoint transforms (``utils/transforms.py``), the zip
reader (``utils/zipreader.py``), the drawing helpers (``utils/vis.py``),
the host library's linear warp and resize (``data/imgproc.py``) and the
top-level exports.

npp_tpu's functions call cv2, which is the oracle. Everything is equal,
pixel for pixel or bit for bit, except:

- ``get_affine_transform``: within 1e-9 of cv2's ``getAffineTransform``
  (the port runs OpenCV's own elimination and matches it bit for bit
  here);
- the linear warp (``crop``): within one grey level. OpenCV 5 blends the
  last ``width % 16`` pixels of each row by a rule of its own that the
  port does not copy, so ~1e-4 of those values land on the other side
  of a rounding tie; over whole images the share of values that differ
  is pinned under ``WARP_SHARE`` = 1e-4 (measured 5.6e-6 over 3.8
  million). The linear resize of ``overlay_heatmap`` is exact.

Inputs come from numpy seeds; files are written into ``tmp_path``.
"""
import os
import zipfile

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from npp_tpu.utils import transforms as jtr  # noqa: E402
from npp_tpu.utils import vis as jvis  # noqa: E402
from npp_tpu.utils import zipreader as jzip  # noqa: E402

import npp_tpu_torch  # noqa: E402
from npp_tpu_torch.data import imgproc  # noqa: E402
from npp_tpu_torch.utils import transforms as ttr  # noqa: E402
from npp_tpu_torch.utils import vis as tvis  # noqa: E402
from npp_tpu_torch.utils import zipreader as tzip  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "torch_lip")
PAIRS = ((0, 5), (1, 4), (2, 3), (10, 15), (11, 14), (12, 13))
WARP_SHARE = 1e-4


# -- transforms ------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 16, 96, 96), (1, 14, 64, 48),
                                   (3, 16, 7, 5)])
def test_flip_back_matches_jax(shape):
    hm = np.random.default_rng(0).random(shape).astype(np.float32)
    pairs = [p for p in PAIRS if max(p) < shape[1]]
    np.testing.assert_array_equal(ttr.flip_back(hm, pairs),
                                  jtr.flip_back(hm, pairs))


def test_fliplr_joints_with_invisible_joints_matches_jax():
    rng = np.random.default_rng(1)
    joints = rng.uniform(-5, 105, (16, 3))
    vis = (rng.random((16, 3)) > 0.3).astype(np.float64)
    got = ttr.fliplr_joints(joints, vis, 100, PAIRS)
    want = jtr.fliplr_joints(joints, vis, 100, PAIRS)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _affine_cases(n: int, seed: int):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield (rng.uniform(-50, 450, 2), rng.uniform(0.05, 3.0),
               rng.uniform(-60, 60), (int(rng.integers(8, 400)),
                                      int(rng.integers(8, 400))),
               rng.uniform(-0.2, 0.2, 2).astype(np.float32))


@pytest.mark.parametrize("inv", [0, 1])
@pytest.mark.parametrize("pixel_std", [200.0, 1.0])
def test_get_affine_transform_within_1e9_of_cv2(inv, pixel_std):
    for center, scale, rot, size, shift in _affine_cases(60, 2):
        for s in (scale, np.array([scale, 1.3 * scale])):
            got = ttr.get_affine_transform(center, s, rot, size, shift,
                                           inv=inv, pixel_std=pixel_std)
            want = jtr.get_affine_transform(center, s, rot, size, shift,
                                            inv=inv, pixel_std=pixel_std)
            assert got.dtype == want.dtype == np.float64
            assert np.abs(got - want).max() <= 1e-9


def test_solve_affine_matches_cv2_on_random_triangles():
    rng = np.random.default_rng(3)
    for _ in range(200):
        src = rng.uniform(-500, 500, (3, 2)).astype(np.float32)
        dst = rng.uniform(-500, 500, (3, 2)).astype(np.float32)
        want = cv2.getAffineTransform(src, dst)
        assert np.abs(ttr.solve_affine(src, dst) - want).max() <= 1e-9
    assert ttr.get_dir([0, 3.0], 0.7) == jtr.get_dir([0, 3.0], 0.7)
    a, b = np.float32([3, 4]), np.float32([1, -2])
    np.testing.assert_array_equal(ttr.get_3rd_point(a, b),
                                  jtr.get_3rd_point(a, b))


def test_affine_transform_and_transform_preds_match_jax():
    rng = np.random.default_rng(4)
    for center, scale, rot, size, _ in _affine_cases(20, 5):
        t = jtr.get_affine_transform(center, scale, rot, size)
        pt = rng.uniform(-10, 100, 2)
        np.testing.assert_allclose(ttr.affine_transform(pt, t),
                                   jtr.affine_transform(pt, t), rtol=0,
                                   atol=1e-12)
        coords = rng.uniform(-2, 98, (16, 3)).astype(np.float32)
        np.testing.assert_allclose(
            ttr.transform_preds(coords, center, scale, size),
            jtr.transform_preds(coords, center, scale, size), rtol=0,
            atol=1e-6 * max(1.0, float(np.abs(center).max())))


@pytest.mark.parametrize("hw", [(96, 96), (64, 48), (12, 9)])
def test_get_final_preds_matches_jax(hw):
    """Peaks in the middle, on and next to the border (where the quarter
    offset is skipped), maps of zeros (invisible joints) and flat ties."""
    h, w = hw
    rng = np.random.default_rng(hw[0] + hw[1])
    hm = rng.random((3, 16, h, w)).astype(np.float32) * 0.2
    peaks = [(h // 2, w // 2), (0, 0), (h - 1, w - 1), (1, w - 2),
             (h - 2, 1), (2, 2), (h - 3, w - 3), (0, w // 3)]
    for j, (y, x) in enumerate(peaks):
        hm[:, j, y, x] = 1.0
    hm[0, 8] = 0.0  # invisible: all zero
    hm[1, 9] = 0.5  # flat: the first maximum wins
    hm[2, 10, h // 2, w // 2 + 1] = hm[2, 10, h // 2, w // 2 - 1] = 0.9
    center = rng.uniform(50, 300, (3, 2))
    scale = rng.uniform(0.5, 2.0, 3)
    for post in (True, False):
        got = ttr.get_final_preds(hm, center, scale, post_process=post)
        want = jtr.get_final_preds(hm, center, scale, post_process=post)
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-9)
        np.testing.assert_array_equal(got[1], want[1])


def _share_within_one(got: np.ndarray, want: np.ndarray) -> float:
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert int(diff.max()) <= 1
    return float((diff > 0).mean())


def test_crop_within_one_level_of_jax():
    """Colour and grey images, rotated, centres inside, near and past the
    border; the share of differing values over all draws is pinned."""
    rng = np.random.default_rng(6)
    n_diff = n_all = 0
    for k in range(24):
        shape = (int(rng.integers(60, 320)), int(rng.integers(60, 320)))
        img = rng.integers(0, 256, shape + ((3,) if k % 3 else ()),
                           dtype=np.uint8)
        center = rng.uniform(-40, max(shape) + 40, 2)
        size = (int(rng.integers(16, 300)), int(rng.integers(16, 300)))
        scale, rot = rng.uniform(0.2, 2.5), rng.uniform(-45, 45) * (k % 2)
        got = ttr.crop(img, center, scale, size, rot)
        want = jtr.crop(img, center, scale, size, rot)
        share = _share_within_one(got, want)
        n_diff += share * got.size
        n_all += got.size
    assert n_diff / n_all <= WARP_SHARE, n_diff / n_all


# -- the host library's linear rules against cv2 -------------------------

def test_linear_warp_within_one_level_of_cv2():
    rng = np.random.default_rng(7)
    n_diff = n_all = 0
    for k in range(16):
        shape = (int(rng.integers(20, 300)), int(rng.integers(20, 300)))
        img = rng.integers(0, 256, shape + ((3,) if k % 2 else ()),
                           dtype=np.uint8)
        m = cv2.getRotationMatrix2D(
            (float(rng.uniform(0, shape[1])), float(rng.uniform(0, shape[0]))),
            float(rng.uniform(-60, 60)), float(rng.uniform(0.3, 3)))
        m[:, 2] += rng.uniform(-30, 30, 2)
        dsize = (int(rng.integers(10, 300)), int(rng.integers(10, 300)))
        border = int(rng.integers(0, 256)) if k % 3 == 0 else 0
        want = cv2.warpAffine(img, m, dsize, flags=cv2.INTER_LINEAR,
                              borderMode=cv2.BORDER_CONSTANT,
                              borderValue=(border,) * 3)
        got = imgproc.warp_affine(img, m, dsize, "linear", border)
        n_diff += _share_within_one(got, want) * got.size
        n_all += got.size
    assert n_diff / n_all <= WARP_SHARE, n_diff / n_all


@pytest.mark.parametrize("src,dsize", [
    ((96, 96), (384, 384)), ((96, 96), (360, 480)), ((24, 24), (300, 384)),
    ((97, 51), (137, 200)), ((96, 96), (48, 48)), ((96, 96), (61, 37)),
    ((5, 7), (2, 3)), ((64, 48), (64, 48)), ((17, 33), (999, 1000))])
def test_resize_linear_equals_cv2(src, dsize):
    rng = np.random.default_rng(src[0] * dsize[0])
    noise = rng.integers(0, 256, src, dtype=np.uint8)
    yy, xx = np.mgrid[:src[0], :src[1]]
    blob = (np.exp(-((yy - src[0] / 3) ** 2 + (xx - src[1] / 2) ** 2) / 50)
            * 255).astype(np.uint8)
    for plane in (noise, blob):
        np.testing.assert_array_equal(imgproc.resize_linear(plane, dsize),
                                      cv2.resize(plane, dsize))


# -- drawing ---------------------------------------------------------------

@pytest.mark.parametrize("alpha", [0.5, 0.3, 0.7, 0.1, 0.25, 0.9])
def test_add_weighted_equals_cv2(alpha):
    rng = np.random.default_rng(8)
    a = rng.integers(0, 256, (60, 70, 3), dtype=np.uint8)
    b = rng.integers(0, 256, (60, 70, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tvis.add_weighted(a, 1 - alpha, b, alpha),
                                  cv2.addWeighted(a, 1 - alpha, b, alpha, 0))


def test_jet_table_equals_cv2():
    grey = np.arange(256, dtype=np.uint8).reshape(16, 16)
    want = cv2.applyColorMap(grey, cv2.COLORMAP_JET)[:, :, ::-1]
    np.testing.assert_array_equal(tvis.JET_RGB[grey], want)


def test_lines_and_circles_equal_cv2():
    """Thickness 2-4 segments inside, crossing and past the border (some
    wholly outside, some of length 0-3), and filled discs of radius 0-7
    anywhere, on colour and grey images."""
    rng = np.random.default_rng(9)
    for k in range(400):
        h, w = (int(v) for v in rng.integers(5, 60, 2))
        img = np.zeros((h, w, 3) if k % 4 else (h, w), np.uint8)
        color = (0, 255, 0) if img.ndim == 3 else 200
        p = tuple(int(v) for v in rng.integers(-20, 80, 2))
        q = tuple(int(v) for v in rng.integers(-20, 80, 2))
        if k % 5 == 0:
            q = (p[0] + int(rng.integers(-3, 4)), p[1] + int(rng.integers(-3, 4)))
        t = int(rng.choice([2, 2, 3, 4]))
        np.testing.assert_array_equal(
            tvis.draw_line(img.copy(), p, q, color, t),
            cv2.line(img.copy(), p, q, color, t), err_msg=f"{p} {q} {t}")
        c = tuple(int(v) for v in rng.integers(-5, 65, 2))
        r = int(rng.integers(0, 8))
        np.testing.assert_array_equal(
            tvis.fill_circle(img.copy(), c, r, color),
            cv2.circle(img.copy(), c, r, color, -1), err_msg=f"{c} {r}")


def _joints(rng, h: int, w: int, n: int = 16) -> np.ndarray:
    """Joints inside, on, near and past the border, at half-pixel ties."""
    pts = rng.uniform(0, 1, (n, 2)) * [w - 1, h - 1]
    pts[0] = (0, 0)
    pts[1] = (w - 1, h - 1)
    pts[2] = (-3.4, h / 2)
    pts[3] = (w + 2.6, -1.5)
    pts[4] = (w / 2 + 0.5, h / 2 - 0.5)
    pts[5] = (1.5, 2.5)
    return pts


@pytest.mark.parametrize("hw", [(96, 96), (384, 384), (57, 83)])
def test_draw_skeleton_equals_jax(hw):
    rng = np.random.default_rng(hw[1])
    img = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
    joints = _joints(rng, *hw)
    vis = (rng.random(16) > 0.25).astype(np.float32)
    for v in (None, vis):
        np.testing.assert_array_equal(tvis.draw_skeleton(img, joints, v),
                                      jvis.draw_skeleton(img, joints, v))
    np.testing.assert_array_equal(
        tvis.draw_skeleton(img, joints[:10], radius=5),
        jvis.draw_skeleton(img, joints[:10], radius=5))


@pytest.mark.parametrize("hm_hw,img_hw", [((96, 96), (384, 384)),
                                          ((48, 40), (200, 150)),
                                          ((96, 96), (96, 96)),
                                          ((24, 24), (7, 9))])
def test_overlays_equal_jax(hm_hw, img_hw):
    rng = np.random.default_rng(hm_hw[0] + img_hw[1])
    img = rng.integers(0, 256, img_hw + (3,), dtype=np.uint8)
    heat = rng.normal(0.5, 0.4, hm_hw)  # float64, clipped to [0, 1]
    for alpha in (0.5, 0.3):
        np.testing.assert_array_equal(
            tvis.overlay_heatmap(img, heat, alpha),
            jvis.overlay_heatmap(img, heat, alpha))
        np.testing.assert_array_equal(
            tvis.overlay_heatmap(img, heat.astype(np.float32), alpha),
            jvis.overlay_heatmap(img, heat.astype(np.float32), alpha))
    pred = rng.integers(0, 20, img_hw)
    for alpha, n in ((0.5, 20), (0.7, 7)):
        np.testing.assert_array_equal(
            tvis.overlay_parsing(img.astype(np.float32), pred % n, alpha, n),
            jvis.overlay_parsing(img.astype(np.float32), pred % n, alpha, n))


def test_save_debug_batch_equals_jax_as_decoded_pixels(tmp_path):
    rng = np.random.default_rng(10)
    images = rng.normal(0, 1, (3, 64, 48, 3))
    joints = np.stack([_joints(rng, 64, 48) for _ in range(3)])
    vis = (rng.random((3, 16)) > 0.2).astype(np.float32)
    for v in (None, vis):
        ours = tvis.save_debug_batch(images, joints, str(tmp_path / "t"),
                                     visibility=v)
        ref = jvis.save_debug_batch(images, joints, str(tmp_path / "j"),
                                    visibility=v)
        assert [os.path.basename(p) for p in ours] == [
            os.path.basename(p) for p in ref]
        for a, b in zip(ours, ref):
            want = cv2.imread(b, cv2.IMREAD_UNCHANGED)[:, :, ::-1]
            got, palette = tvis.read_png(a)
            assert palette is None
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(cv2.imread(a, 1)[:, :, ::-1], want)


def test_save_png_round_trips_through_cv2(tmp_path):
    rng = np.random.default_rng(11)
    rgb = rng.integers(0, 256, (13, 17, 3), dtype=np.uint8)
    grey = rng.integers(0, 256, (13, 17), dtype=np.uint8)
    tvis.save_png(str(tmp_path / "c.png"), rgb)
    tvis.save_png(str(tmp_path / "g.png"), grey)
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "c.png"), cv2.IMREAD_UNCHANGED)[:, :, ::-1],
        rgb)
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "g.png"), cv2.IMREAD_UNCHANGED), grey)
    np.testing.assert_array_equal(tvis.read_png(str(tmp_path / "c.png"))[0],
                                  rgb)
    with pytest.raises(ValueError):
        tvis.save_png(str(tmp_path / "x.png"), rgb[..., :2])


# -- zip reader ------------------------------------------------------------

@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """A zip of the LIP fixtures' JPEGs and label PNGs, a grey JPEG, grey,
    RGB and RGBA PNGs, a progressive JPEG and an XML member."""
    root = tmp_path_factory.mktemp("zip")
    rng = np.random.default_rng(12)
    grey = rng.integers(0, 256, (20, 30), dtype=np.uint8)
    colour = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    extra = {"grey.jpg": grey, "grey.png": grey, "colour.png": colour,
             "rgba.png": np.dstack([colour, grey])}
    for name, im in extra.items():
        cv2.imwrite(str(root / name), im)
    cv2.imwrite(str(root / "prog.jpg"), colour,
                [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    path = str(root / "set.zip")
    with zipfile.ZipFile(path, "w") as z:
        for name in sorted(os.listdir(FIXTURES)):
            if name.endswith((".jpg", ".png")):
                z.write(os.path.join(FIXTURES, name), f"images/{name}")
        for name in list(extra) + ["prog.jpg"]:
            z.write(str(root / name), name)
        z.writestr("ann/a.xml", '<annotation><object name="person">'
                                "<part>head</part></object></annotation>")
    return path


def test_zip_paths():
    assert tzip.split_zip_path("/d/a.zip@x/y.jpg") == jzip.split_zip_path(
        "/d/a.zip@x/y.jpg") == ("/d/a.zip", "x/y.jpg")
    for p in ("/d/a.zip@x.jpg", "/d/a.zip", "/d/a.jpg", "a.zip@"):
        assert tzip.is_zip_path(p) == jzip.is_zip_path(p)


def test_zip_imread_equals_jax_and_the_readers(archive):
    names = zipfile.ZipFile(archive).namelist()
    read = 0
    for name in names:
        if not name.endswith((".jpg", ".png")) or name == "prog.jpg":
            continue
        path = f"{archive}@{name}"
        colour = tzip.imread(path)
        np.testing.assert_array_equal(colour, jzip.imread(path, 1))
        if name.startswith("images/"):
            src = os.path.join(FIXTURES, os.path.basename(name))
            own = (imgproc.read_jpeg(src) if name.endswith(".jpg")
                   else tvis.read_image(src))
            np.testing.assert_array_equal(colour[:, :, ::-1], own)
        grey = cv2.imdecode(np.frombuffer(jzip.read_bytes(path), np.uint8),
                            cv2.IMREAD_UNCHANGED).ndim == 2
        if grey:
            np.testing.assert_array_equal(tzip.imread(path, 0),
                                          jzip.imread(path, 0))
        else:  # a colour file under flag 0
            with pytest.raises(ValueError, match=name):
                tzip.imread(path, 0)
        read += 1
    assert read == 20


def test_zip_refusals_name_the_member(archive):
    with pytest.raises(ValueError, match="prog.jpg"):
        tzip.imread(f"{archive}@prog.jpg")
    with pytest.raises(ValueError, match="flags"):
        tzip.imread(f"{archive}@grey.png", -1)
    with pytest.raises(KeyError):
        tzip.imread(f"{archive}@missing.png")


def test_zip_xmlread_equals_jax(archive):
    path = f"{archive}@ann/a.xml"
    ours, ref = tzip.xmlread(path), jzip.xmlread(path)
    assert ours.tag == ref.tag == "annotation"
    assert [(e.tag, e.attrib, e.text) for e in ours.iter()] == [
        (e.tag, e.attrib, e.text) for e in ref.iter()]
    assert tzip.read_bytes(path) == jzip.read_bytes(path)


# -- the top-level API -----------------------------------------------------

def test_top_level_lazy_exports():
    """``import npp_tpu_torch`` stays light; npp_tpu's names resolve to the
    port's counterparts lazily; a wrong name raises AttributeError."""
    import npp_tpu

    assert npp_tpu_torch.__version__
    assert "Predictor" in dir(npp_tpu_torch)
    from npp_tpu_torch.core.predictor import Predictor
    assert npp_tpu_torch.Predictor is Predictor
    from npp_tpu_torch.models.augment import build_nppnet, fuse_neck_state
    assert npp_tpu_torch.build_model is build_nppnet
    assert npp_tpu_torch.fuse_neck_variables is fuse_neck_state
    from npp_tpu_torch.config import load_preset
    assert npp_tpu_torch.load_config is load_preset
    not_ported = {"convert_reference_state_dict",
                  "export_reference_state_dict"}
    assert set(npp_tpu_torch.__all__) == set(npp_tpu.__all__) - not_ported
    for name in npp_tpu_torch.__all__:
        assert getattr(npp_tpu_torch, name) is not None
    with pytest.raises(AttributeError):
        npp_tpu_torch.NoSuchThing
    with pytest.raises(AttributeError):
        npp_tpu_torch.convert_reference_state_dict
