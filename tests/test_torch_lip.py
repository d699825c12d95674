"""The port's LIP reader against cv2 and npp_tpu on the CPU: the host
library's JPEG decoder, resize by a factor and affine warps
(``npp_tpu_torch/data/imgproc.py``), the augmentation chain, the label
chain, ``LIPDataset`` and the CLIs on a LIP-layout tree.

The host library is built once per process (module-scoped fixture);
every file is written into ``tmp_path`` with cv2. The oracle is the
installed cv2 (OpenCV 5, with libjpeg-turbo). Tolerances:

- JPEG decode: at most 1 grey level from ``cv2.imread(p, 1)`` + BGR->RGB
  (the aim, and what is seen, is exact: every integer step is libjpeg's);
  refused files raise ValueError naming the cause;
- nearest resize and nearest warp: equal to cv2;
- cubic resize: at most 1 grey level (cv2 sums in float, in an order of
  its own); cubic warp: at most 1 grey level, and under 0.1% of the
  pixels of all draws differ;
- ``LIPDataset`` on a PNG tree against npp_tpu's, 16 sequential samples
  per mode: joints, visibility, scale, crop_param and labels equal, the
  uint8 image within 1 grey level (two cubic resamplings, each within 1);
- one JPEG-tree sample: labels and geometry equal, the image within
  JPEG_CHAIN_ATOL = 6 grey levels: the decoder's 1 level, magnified by
  the L1 norm of the cubic taps (at most 1.375 per axis, so 1.375^4 =
  3.57 over the two 2-D resamplings), plus 1 of rounding in each.
"""
import hashlib
import json
import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from npp_tpu.data import lip as jlip  # noqa: E402
from npp_tpu.data import targets as jtgt  # noqa: E402

from npp_tpu_torch.config import LIP  # noqa: E402
from npp_tpu_torch.data import augmentation as taug  # noqa: E402
from npp_tpu_torch.data import imgproc  # noqa: E402
from npp_tpu_torch.data import lip as tlip  # noqa: E402
from npp_tpu_torch.data import targets as ttgt  # noqa: E402
from npp_tpu_torch.tools import (augment_lip, eval_lip, predict,  # noqa: E402
                                 search_lip, test_lip)
from npp_tpu_torch.utils import vis  # noqa: E402

DECODE_ATOL = 1
CUBIC_ATOL = 1
WARP_DIFF_SHARE = 1e-3
JPEG_CHAIN_ATOL = 6
CPU = ["--tiny", "--device", "cpu", "--dtype", "float32"]
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "torch_lip")
with open(os.path.join(FIXTURES, "fixtures.json")) as _f:
    FIXTURE_RECORDS = json.load(_f)


@pytest.fixture(scope="module", autouse=True)
def library():
    path, _ = imgproc.build_library()
    return path


def smooth_image(rng, h, w, c=3):
    """A photo-like uint8 image: a bicubic blow-up of coarse noise plus
    fine noise (JPEG and the cubic taps see edges and texture)."""
    base = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2, c)).astype(np.uint8)
    im = cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC)
    if im.ndim == 2:
        im = im[..., None]
    im = im.astype(np.int64) + rng.integers(-24, 25, im.shape)
    im = np.clip(im, 0, 255).astype(np.uint8)
    return im if c == 3 else im[..., 0]


def cv2_rgb(path_or_buf) -> np.ndarray:
    if isinstance(path_or_buf, (str, os.PathLike)):
        bgr = cv2.imread(str(path_or_buf), cv2.IMREAD_COLOR)
    else:
        bgr = cv2.imdecode(path_or_buf, cv2.IMREAD_COLOR)
    return np.ascontiguousarray(bgr[..., ::-1])


# -- the JPEG decoder ---------------------------------------------------------

SAMPLINGS = ("444", "422", "420", "440", "411")
SIZES = ((1, 1), (7, 13), (37, 53), (333, 211))
DECODE_CASES = (
    [(q, s, hw, ()) for q in (50, 75, 95) for s in SAMPLINGS for hw in SIZES]
    + [(80, "420", (61, 90), ("rst", 1)), (80, "422", (120, 77), ("rst", 5)),
       (90, "420", (100, 130), ("opt",)),
       (70, "411", (45, 99), ("opt", "rst", 2)),
       (85, "grey", (53, 37), ()), (60, "grey", (130, 75), ("opt", "rst", 3))])


@pytest.mark.parametrize("quality,sampling,hw,extra", DECODE_CASES)
def test_jpeg_decode_matches_cv2(tmp_path, quality, sampling, hw, extra):
    rng = np.random.default_rng(quality * 1000 + hw[0] * 7 + hw[1])
    grey = sampling == "grey"
    im = smooth_image(rng, *hw, c=1 if grey else 3)
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if not grey:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                   getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")]
    if "opt" in extra:
        params += [cv2.IMWRITE_JPEG_OPTIMIZE, 1]
    if "rst" in extra:
        interval = extra[extra.index("rst") + 1]
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, interval]
    path = tmp_path / "a.jpg"
    assert cv2.imwrite(str(path), im, params)
    ours = imgproc.read_jpeg(str(path))
    ref = cv2_rgb(path)
    assert ours.shape == ref.shape == (*hw, 3)
    diff = np.abs(ours.astype(np.int64) - ref)
    print(f"q{quality} {sampling} {hw} {extra}: max |diff| {diff.max()}, "
          f"{(diff > 0).mean():.5f} of the values differ")
    assert diff.max() <= DECODE_ATOL
    # vis.read_image routes .jpg / .jpeg to the decoder.
    np.testing.assert_array_equal(vis.read_image(str(path)), ours)


@pytest.mark.parametrize("record", FIXTURE_RECORDS,
                         ids=[r["image"] for r in FIXTURE_RECORDS])
def test_fixture_decodes_to_cv2_and_its_recorded_hash(record):
    """The committed fixtures (chip_smoke.py phase 15 reads them beside
    the card, without cv2) decode to cv2's pixels and to their recorded
    SHA-256; their labels are 8-bit grey PNGs of the image's size."""
    path = os.path.join(FIXTURES, record["image"])
    ours = imgproc.read_jpeg(path)
    np.testing.assert_array_equal(ours, cv2_rgb(path))
    assert hashlib.sha256(ours.tobytes()).hexdigest() == record["sha256"]
    lab = tlip.read_label_png(os.path.join(FIXTURES, record["label"]))
    assert lab.shape == ours.shape[:2] == (record["height"], record["width"])


def _jpeg(rng) -> bytearray:
    ok, buf = cv2.imencode(".jpg", smooth_image(rng, 40, 48),
                           [cv2.IMWRITE_JPEG_QUALITY, 80])
    assert ok
    return bytearray(buf.tobytes())


def _marker(data: bytearray, code: int) -> int:
    i = 2
    while True:
        assert data[i] == 0xFF
        if data[i + 1] == code:
            return i
        i += 2 + ((data[i + 2] << 8) | data[i + 3])


def _with_exif(data: bytearray, orientation: int) -> bytes:
    """``data`` with an APP1 EXIF segment (little-endian TIFF, IFD0 holding
    one Orientation entry) after SOI."""
    tiff = (b"II*\x00" + (8).to_bytes(4, "little") + (1).to_bytes(2, "little")
            + (0x0112).to_bytes(2, "little") + (3).to_bytes(2, "little")
            + (1).to_bytes(4, "little") + orientation.to_bytes(2, "little")
            + b"\x00\x00" + (0).to_bytes(4, "little"))
    body = b"Exif\x00\x00" + tiff
    seg = b"\xff\xe1" + (len(body) + 2).to_bytes(2, "big") + body
    return bytes(data[:2]) + seg + bytes(data[2:])


def test_jpeg_refusals_raise_value_error(tmp_path):
    rng = np.random.default_rng(3)
    ok, buf = cv2.imencode(".jpg", smooth_image(rng, 40, 48),
                           [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    path = tmp_path / "p.jpg"
    path.write_bytes(buf.tobytes())
    with pytest.raises(ValueError, match=r"p\.jpg: progressive"):
        imgproc.read_jpeg(str(path))
    with pytest.raises(ValueError, match="progressive"):
        vis.read_image(str(path))
    cases = {0xC9: "arithmetic", 0xC3: "lossless", 0xC5: "hierarchical"}
    for code, why in cases.items():
        data = _jpeg(rng)
        data[_marker(data, 0xC0) + 1] = code
        with pytest.raises(ValueError, match=why):
            imgproc.decode_jpeg(bytes(data), "x.jpg")
    data = _jpeg(rng)
    data[_marker(data, 0xC0) + 4] = 12  # sample precision
    with pytest.raises(ValueError, match="12-bit"):
        imgproc.decode_jpeg(bytes(data))
    data = _jpeg(rng)
    data[_marker(data, 0xC0) + 9] = 4  # component count
    with pytest.raises(ValueError, match="CMYK"):
        imgproc.decode_jpeg(bytes(data))
    with pytest.raises(ValueError, match="not a JPEG"):
        imgproc.decode_jpeg(b"\x89PNG....")
    for orientation in (3, 6, 8):
        with pytest.raises(ValueError,
                           match=f"EXIF orientation {orientation}"):
            imgproc.decode_jpeg(_with_exif(_jpeg(rng), orientation))


def test_jpeg_exif_orientation_1_decodes_as_cv2(tmp_path):
    rng = np.random.default_rng(4)
    path = tmp_path / "e.jpg"
    path.write_bytes(_with_exif(_jpeg(rng), 1))
    np.testing.assert_array_equal(imgproc.read_jpeg(str(path)),
                                  cv2_rgb(path))


# -- resize by a factor -------------------------------------------------------

@pytest.mark.parametrize("case", range(50))
def test_resize_by_factor_matches_cv2(case):
    rng = np.random.default_rng(100 + case)
    h, w = (int(v) for v in rng.integers(1, 420, 2))
    scale = float(rng.uniform(0.2, 2.5))
    if round(h * scale) < 1 or round(w * scale) < 1:
        scale = 1.0
    im = smooth_image(rng, h, w)
    ref = cv2.resize(im, None, fx=scale, fy=scale,
                     interpolation=cv2.INTER_CUBIC)
    ours = imgproc.resize(im, scale, "cubic")
    assert ours.shape == ref.shape
    diff = np.abs(ours.astype(np.int64) - ref)
    print(f"{h}x{w} x{scale:.4f}: cubic max |diff| {diff.max()}, "
          f"{(diff > 0).mean():.5f} differ")
    assert diff.max() <= CUBIC_ATOL
    lab = rng.integers(0, 20, (h, w)).astype(np.uint8)
    np.testing.assert_array_equal(
        imgproc.resize(lab, scale, "nearest"),
        cv2.resize(lab, None, fx=scale, fy=scale,
                   interpolation=cv2.INTER_NEAREST))


def test_resize_and_warp_check_their_input():
    im = np.zeros((4, 5, 3), np.uint8)
    with pytest.raises(ValueError, match="nearest takes"):
        imgproc.resize(im, 2.0, "nearest")
    with pytest.raises(ValueError, match="cubic takes"):
        imgproc.resize(im[..., 0], 2.0, "cubic")
    with pytest.raises(ValueError, match="interpolation"):
        imgproc.warp_affine(im, np.eye(2, 3), (5, 4), "area", 0)
    with pytest.raises(ValueError, match="interpolation"):
        imgproc.resize(im, 2.0, "linear")  # resize_linear takes a dsize
    with pytest.raises(ValueError, match="empty"):
        imgproc.resize(im, 0.01, "cubic")


# -- warpAffine ---------------------------------------------------------------

def _reader_draw(rng):
    """A rotation of the reader's kind: a scaled image, an angle of up to
    +-40 degrees, the canvas expanded as ``augmentation_rotate`` does."""
    h, w = (int(v) for v in rng.integers(40, 420, 2))
    deg = float(rng.uniform(-40, 40))
    m = cv2.getRotationMatrix2D((w / 2, h / 2), deg, 1)
    r = np.deg2rad(deg)
    new_w = abs(np.sin(r) * h) + abs(np.cos(r) * w)
    new_h = abs(np.sin(r) * w) + abs(np.cos(r) * h)
    m[0, 2] += (new_w - w) / 2
    m[1, 2] += (new_h - h) / 2
    return h, w, m, (int(new_w), int(new_h))


def test_warp_affine_matches_cv2_over_100_reader_draws():
    rng = np.random.default_rng(7)
    differ = total = 0
    worst = 0
    for _ in range(100):
        h, w, m, dsize = _reader_draw(rng)
        im = smooth_image(rng, h, w)
        ref = cv2.warpAffine(im, m, dsize=dsize, flags=cv2.INTER_CUBIC,
                             borderMode=cv2.BORDER_CONSTANT,
                             borderValue=(128, 128, 128))
        ours = imgproc.warp_affine(im, m, dsize, "cubic", 128)
        diff = np.abs(ours.astype(np.int64) - ref)
        worst = max(worst, int(diff.max()))
        differ += int((diff > 0).sum())
        total += diff.size
        lab = rng.integers(0, 20, (h, w)).astype(np.uint8)
        np.testing.assert_array_equal(
            imgproc.warp_affine(lab, m, dsize, "nearest", 255),
            cv2.warpAffine(lab, m, dsize=dsize, flags=cv2.INTER_NEAREST,
                           borderMode=cv2.BORDER_CONSTANT,
                           borderValue=(255,)))
    print(f"cubic warp: max |diff| {worst}, {differ / total:.6f} of the "
          f"values differ")
    assert worst <= CUBIC_ATOL
    assert differ / total < WARP_DIFF_SHARE


def test_rotation_matrix_equals_cv2():
    rng = np.random.default_rng(8)
    for _ in range(50):
        w, h = rng.integers(1, 900, 2)
        deg = float(rng.uniform(-40, 40))
        np.testing.assert_array_equal(
            taug.rotation_matrix((w / 2, h / 2), deg, 1),
            cv2.getRotationMatrix2D((w / 2, h / 2), deg, 1))


# -- the label chain ----------------------------------------------------------

def _labels(rng, h, w) -> np.ndarray:
    """Blocky part labels, the LIP left/right classes 14-19 among them."""
    par = np.zeros((h, w), np.uint8)
    for _ in range(14):
        y0, x0 = rng.integers(0, h), rng.integers(0, w)
        par[y0:y0 + h // 4 + 1, x0:x0 + w // 4 + 1] = rng.integers(0, 20)
    return par


@pytest.mark.parametrize("flip,stride", [(False, 1), (True, 1), (True, 2)])
def test_gen_parsing_target_matches_npp_tpu(flip, stride):
    rng = np.random.default_rng(9)
    par = _labels(rng, 150, 110)
    scale = 1.2345
    h, w = round(150 * scale), round(110 * scale)
    m = taug.rotation_matrix((w / 2, h / 2), 23.5, 1)
    crop = np.array([[10, 5, 0, 3, 138, 130, 128, 128]])
    kw = dict(scale_param=scale, rotate_param=[m, w + 20, h + 10],
              crop_param=[crop, 128, 128], flip_param=flip, stride=stride,
              flip_pairs=tlip.LIP_FLIP_PAIRS)
    np.testing.assert_array_equal(ttgt.gen_parsing_target(par, **kw),
                                  jtgt.gen_parsing_target(par, **kw))


# -- LIPDataset on a LIP-layout tree ------------------------------------------

def write_lip_tree(root, *, n_train: int, n_val: int, fmt: str, seed: int):
    """A LIP directory as ``config.LIP.data`` lays it out: images
    (``fmt``: 'png' or 'jpg') and grey PNG labels of 90-200 px, the
    annotation JSONs of every split (joint_self in MPII order with some
    joints at (0, 0), objpos near the middle) and the pose GT CSV of the
    val entries. Returns the GT CSV's path."""
    rng = np.random.default_rng(seed)
    layout = LIP.data
    entries = {}
    for split, n in (("train", n_train), ("val", n_val)):
        im_dir = os.path.join(root, layout[f"{split}_imroot"])
        seg_dir = os.path.join(root, layout[f"{split}_segroot"])
        os.makedirs(im_dir, exist_ok=True)
        os.makedirs(seg_dir, exist_ok=True)
        annos = []
        for i in range(n):
            h, w = (int(v) for v in rng.integers(90, 200, 2))
            name = f"{split}_{i:03d}"
            im = smooth_image(rng, h, w)
            cv2.imwrite(os.path.join(im_dir, f"{name}.{fmt}"), im[..., ::-1])
            cv2.imwrite(os.path.join(seg_dir, f"{name}.png"),
                        _labels(rng, h, w))
            joints = np.stack([rng.uniform(5, w - 5, 16),
                               rng.uniform(5, h - 5, 16),
                               np.ones(16)], 1)
            joints[rng.random(16) < 0.15] = 0.0
            joints[8:10] = [[w / 2, h / 3, 1], [w / 2 + 3, h / 3 - 25, 1]]
            annos.append({"im_name": f"{name}.{fmt}",
                          "joint_self": joints.tolist(),
                          "objpos": [w / 2 + rng.uniform(-10, 10),
                                     h / 2 + rng.uniform(-10, 10)],
                          "scale_provided": 1.0})
        entries[split] = annos
    os.makedirs(os.path.join(root, "jsons"), exist_ok=True)
    files = {"train_set": "train", "search_train_set": "train",
             "search_mini_set": "train", "val_set": "val",
             "search_val_set": "val", "test_set": "val"}
    for key, split in files.items():
        with open(os.path.join(root, layout[key]), "w") as f:
            json.dump({"root": entries[split]}, f)
    gt = os.path.join(root, "pose_gt.csv")
    with open(gt, "w") as f:
        for a in entries["val"]:
            cells = [a["im_name"].split(".")[0]]
            for x, y, v in a["joint_self"]:
                cells += [f"{x:.3f}", f"{y:.3f}", str(int(v))]
            f.write(",".join(cells) + "\n")
    return gt


@pytest.fixture(scope="module")
def png_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("lip_png"))
    gt = write_lip_tree(root, n_train=16, n_val=16, fmt="png", seed=11)
    return root, gt


def _pair(root, split, is_train, seed, crop=(128, 128)):
    layout = LIP.data
    im_root, anno, seg_root = (layout[k] for k in tlip.SPLITS[split])
    kw = dict(crop_size=crop, is_train=is_train, seed=seed,
              device_normalize=True)
    return (jlip.LIPDataset(root, im_root, anno, seg_root, **kw),
            tlip.dataset_for(layout, split, root, **kw))


@pytest.mark.parametrize("is_train", [True, False])
def test_lip_dataset_matches_npp_tpu(png_tree, is_train):
    root, _ = png_tree
    ref, ours = _pair(root, "train" if is_train else "val", is_train, 5)
    assert len(ref) == len(ours) == 16
    assert ours.image_names() == ref.image_names()
    worst, flips, outside = 0, 0, 0
    draws = np.random.default_rng(5)  # the reader's draws, replayed
    for i in range(16):  # sequential: the shared rng gives equal draws
        a, b = ref[i], ours[i]
        assert a["name"] == b["name"]
        for key in ("joints", "visibility", "scale", "crop_param", "par"):
            np.testing.assert_array_equal(b[key], a[key], err_msg=key)
            assert b[key].dtype == a[key].dtype, key
        assert b["image"].dtype == np.uint8
        assert b["image"].shape == (128, 128, 3)
        worst = max(worst, int(np.abs(b["image"].astype(np.int64)
                                      - a["image"]).max()))
        d = draws.random(5 if is_train else 3)
        flips += bool(is_train and d[4] < 0.5)
        outside += int(((b["joints"] < 0) | (b["joints"] > 127)).any())
    print(f"is_train={is_train}: image max |diff| {worst}; {flips} flips, "
          f"{outside} samples with a joint outside the crop")
    assert worst <= CUBIC_ATOL
    if is_train:  # the draws flip some samples and push joints out
        assert 0 < flips < 16 and outside > 0
    # Host normalisation, as test_lip's reader uses it.
    ref.device_normalize = ours.device_normalize = False
    np.testing.assert_allclose(ours[0]["image"], ref[0]["image"],
                               atol=CUBIC_ATOL / 255 / 0.224 + 1e-6)


def test_lip_dataset_jpeg_sample_within_chain_bound(tmp_path):
    root = str(tmp_path)
    write_lip_tree(root, n_train=2, n_val=2, fmt="jpg", seed=12)
    for split, is_train in (("train", True), ("val", False)):
        ref, ours = _pair(root, split, is_train, 6)
        a, b = ref[1], ours[1]
        for key in ("joints", "visibility", "scale", "crop_param", "par"):
            np.testing.assert_array_equal(b[key], a[key], err_msg=key)
        diff = int(np.abs(b["image"].astype(np.int64) - a["image"]).max())
        print(f"JPEG tree, {split}: image max |diff| {diff}")
        assert diff <= JPEG_CHAIN_ATOL


def test_labels_must_be_grey_png(tmp_path):
    path = str(tmp_path / "l.png")
    vis.save_parsing_png(np.zeros((4, 4), np.uint8), path)
    with pytest.raises(ValueError, match="8-bit grey PNG"):
        tlip.read_label_png(path)


# -- the CLIs on the tree -----------------------------------------------------

def test_train_and_eval_clis_read_the_lip_tree(png_tree, tmp_path):
    root, gt = png_tree
    out = augment_lip.main(["--data-root", root, "--gt-csv", gt, "--steps",
                            "1", "--epochs", "1", "--out", str(tmp_path),
                            *CPU])
    assert np.isfinite(out["train_loss"])
    assert np.isfinite(out["result"]["pck_avg"])
    assert len(out["result"]["names"]) == 4  # one val batch of the tiny bs4
    res = eval_lip.main(["--data-root", root, "--gt-csv", gt, "--ckpt",
                         out["checkpoints"], "--sample", "6", "--batch", "4",
                         "--pred-csv", str(tmp_path / "p.csv"), *CPU])
    assert res["names"] == [f"val_{i:03d}" for i in range(6)]
    assert np.isfinite(res["loss"]) and np.isfinite(res["mean_iou"])
    assert res["pck"].shape[-1] == 18 and np.isfinite(res["pck_avg"])
    with open(tmp_path / "p.csv") as f:
        assert len(f.read().splitlines()) == 6


def test_test_cli_reads_the_lip_tree(png_tree):
    root, _ = png_tree
    metrics = test_lip.main(["--data-root", root, "--mode", "testval",
                             "--limit", "2", *CPU])
    assert metrics["cm"].sum() > 0 and np.isfinite(metrics["mean_iou"])


def test_predict_cli_serves_jpegs(tmp_path):
    out = predict.main(["--images", os.path.join(FIXTURES, "lip_[ae].jpg"),
                        "--out", str(tmp_path), *CPU])
    assert out["names"] == ["lip_a", "lip_e"]
    assert [p.shape for p in out["parsings"]] == [
        (r["height"], r["width"]) for r in FIXTURE_RECORDS
        if r["image"] in ("lip_a.jpg", "lip_e.jpg")]


def test_clis_refuse_ppp_and_mixed_sources(png_tree):
    # The train CLI reads a PPP directory now; the search CLI still
    # refuses one (npp_tpu's search reads LIP JSONs under the PPP root).
    root, gt = png_tree
    with pytest.raises(SystemExit):
        search_lip.main(["--dataset", "ppp", "--data-root", root, *CPU])
    with pytest.raises(SystemExit):
        eval_lip.main(["--synthetic", "--gt-csv", gt, *CPU])
