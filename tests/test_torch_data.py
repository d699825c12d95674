"""The rest of the port's data package against npp_tpu on the CPU: the
Pascal-Person-Part reader (``data/pascal.py``), the ``--fast-aug`` fused
warp (``data/fast_aug.py``, ``data/csrc/fused_augment.cpp``,
``FastLIPDataset``), the host targets of ``data/targets.py`` and the
train CLI reading a PPP directory or a LIP one with ``--fast-aug``.

The trees are written into ``tmp_path`` by ``chip_smoke.write_ppp_tree``
and ``chip_smoke.write_lip_tree`` from the committed JPEG and grey PNG
fixtures, ``scipy.io.savemat`` and ``np.save``. npp_tpu reads them with
cv2 and its own native library (``native/``, which it builds with
``make`` at its first use: the tests fail, not skip, without it). No JAX
program runs. Bounds:

- ``build_ppp_db``: the same entries in the same order, arrays equal;
- ``PPPDataset``, 8 sequential draws per mode: joints, visibility,
  scale, crop_param and labels equal, the uint8 image within 1 grey
  level (two cubic resamplings, each within 1);
- ``fused_augment`` and ``FastLIPDataset``: labels equal, uint8 images
  within 1 level, float32 images within 1/255/min(std) + 1e-5, joints
  within 1e-4 px (both are built with npp_tpu's flags, so equal is what
  is seen);
- host ``generate_edge``: equal to cv2's dilation; host
  ``gen_pose_target`` and ``gen_pose_target_paf``: within 1e-6.
"""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from npp_tpu.data import fast_aug as jfast  # noqa: E402
from npp_tpu.data import lip as jlip  # noqa: E402
from npp_tpu.data import pascal as jpascal  # noqa: E402
from npp_tpu.data import targets as jtgt  # noqa: E402

import chip_smoke  # noqa: E402
from npp_tpu_torch.config import LIP, PPP  # noqa: E402
from npp_tpu_torch.data import fast_aug as tfast  # noqa: E402
from npp_tpu_torch.data import imgproc  # noqa: E402
from npp_tpu_torch.data import lip as tlip  # noqa: E402
from npp_tpu_torch.data import pascal as tpascal  # noqa: E402
from npp_tpu_torch.data import targets as ttgt  # noqa: E402
from npp_tpu_torch.data.synthetic import IMAGENET_STD  # noqa: E402
from npp_tpu_torch.tools import augment_lip, search_lip  # noqa: E402

torch.set_num_threads(1)

GREY_ATOL = 1
F32_ATOL = 1 / 255 / float(IMAGENET_STD.min()) + 1e-5
JOINT_ATOL = 1e-4
TARGET_ATOL = 1e-6
DRAWS = 8
CROP = (128, 128)
CPU = ["--tiny", "--device", "cpu", "--dtype", "float32"]
with open(os.path.join(chip_smoke.PPP_FIXTURES, "fixtures.json")) as _f:
    PPP_RECORDS = json.load(_f)


@pytest.fixture(scope="module", autouse=True)
def libraries():
    """The port's host library, and npp_tpu's native one (built by its
    own ``make`` when absent); a missing one fails the tests."""
    imgproc.build_library()
    assert jfast.is_available(), "npp_tpu's native library did not build"


@pytest.fixture(scope="module")
def ppp_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ppp"))
    implied = chip_smoke.write_ppp_tree(root, 8, 4,
                                        np.random.default_rng(21))
    return root, implied


@pytest.fixture(scope="module")
def lip_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("lip"))
    with open(os.path.join(chip_smoke.FIXTURES, "fixtures.json")) as f:
        records = json.load(f)
    chip_smoke.write_lip_tree(root, records, np.random.default_rng(22))
    return root


def _image_diff(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a.astype(np.float64) - b).max())


# -- the PPP label fixtures ---------------------------------------------------

@pytest.mark.parametrize("record", PPP_RECORDS, ids=lambda r: r["label"])
def test_ppp_label_fixture_reads_to_its_hash(record):
    path = os.path.join(chip_smoke.PPP_FIXTURES, record["label"])
    ours = tlip.read_label_png(path)
    assert ours.shape == (record["height"], record["width"])
    assert hashlib.sha256(ours.tobytes()).hexdigest() == record["sha256"]
    np.testing.assert_array_equal(ours, cv2.imread(path, 0))
    assert sorted(np.unique(ours).tolist()) == record["classes"] \
        == list(range(7))


# -- build_ppp_db and PPPDataset ----------------------------------------------

def _ppp_pair(root, split, **kw):
    layout = PPP.data
    ref = jpascal.PPPDataset(root, layout[f"{split}_imroot"],
                             layout[f"{split}_set"], layout["pose_root"],
                             layout[f"{split}_segroot"], layout["mask_root"],
                             **kw)
    return ref, tpascal.dataset_for(layout, split, root, **kw)


@pytest.mark.parametrize("split", ["train", "val"])
def test_build_ppp_db_matches_npp_tpu(ppp_tree, split):
    root, implied = ppp_tree
    layout = PPP.data
    with open(os.path.join(root, layout[f"{split}_set"])) as f:
        ids = [line.strip() for line in f]
    args = (ids, os.path.join(root, layout["pose_root"]),
            os.path.join(root, layout["mask_root"]))
    ref, ours = jpascal.build_ppp_db(*args), tpascal.build_ppp_db(*args)
    # The tree holds every case: unmatched GTs dropped, non-person
    # instances filtered, an id with masks and no .mat skipped.
    cases = implied[split]
    assert cases["unmatched_gt"] > 0 and cases["non_person"] > 0
    assert cases["without_mat"] == 1 and ids[-1] not in {
        e["im_name"] for e in ours}
    assert len(ours) == len(ref) == cases["entries"]
    for a, b in zip(ref, ours):
        assert a.keys() == b.keys()
        assert a["im_name"] == b["im_name"]
        for key in ("box", "joint", "mask"):
            np.testing.assert_array_equal(b[key], a[key], err_msg=key)
            assert b[key].dtype == a[key].dtype, key
    assert {e["mask"].dtype for e in ours} == {np.dtype(bool),
                                               np.dtype(np.uint8)}
    assert tpascal.box_iou([0, 0, 4, 4], [2, 2, 6, 6]) == \
        jpascal.box_iou([0, 0, 4, 4], [2, 2, 6, 6]) == 4 / 28


@pytest.mark.parametrize("is_train", [True, False])
def test_ppp_dataset_matches_npp_tpu(ppp_tree, is_train):
    root, _ = ppp_tree
    split = "train" if is_train else "val"
    ref, ours = _ppp_pair(root, split, crop_size=CROP, is_train=is_train,
                          seed=7, device_normalize=True)
    assert len(ref) == len(ours) and ours.image_names() == ref.image_names()
    draws = np.random.default_rng(7)  # the reader's draws, replayed
    worst, flips = 0.0, 0
    for i in range(DRAWS):  # sequential: the shared rng gives equal draws
        a, b = ref[i % len(ref)], ours[i % len(ours)]
        assert a["name"] == b["name"]
        for key in ("joints", "visibility", "scale", "crop_param", "par"):
            np.testing.assert_array_equal(b[key], a[key], err_msg=key)
            assert b[key].dtype == a[key].dtype, key
        assert b["image"].dtype == np.uint8 and b["image"].shape == (
            *CROP, 3)
        assert set(np.unique(b["par"])) <= set(range(7)) | {255}
        worst = max(worst, _image_diff(b["image"], a["image"]))
        if is_train:
            flips += bool(draws.random(5)[4] < 0.5)
    print(f"is_train={is_train}: image max |diff| {worst}; {flips} flips")
    assert worst <= GREY_ATOL
    if is_train:
        assert 0 < flips < DRAWS
    ref.device_normalize = ours.device_normalize = False
    np.testing.assert_allclose(ours[0]["image"], ref[0]["image"],
                               atol=GREY_ATOL / 255 / 0.224 + 1e-6)


# -- the fused warp -----------------------------------------------------------

@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("with_joints", [False, True])
@pytest.mark.parametrize("with_label", [False, True])
@pytest.mark.parametrize("as_uint8", [False, True])
def test_fused_augment_matches_npp_tpu(as_uint8, with_label, with_joints,
                                       flip):
    rng = np.random.default_rng(hash((as_uint8, with_label, with_joints,
                                      flip)) % 2**32)
    lut = tfast.make_swap_lut(tlip.LIP_FLIP_PAIRS)
    np.testing.assert_array_equal(lut, jfast.make_swap_lut(
        jlip.LIP_FLIP_PAIRS))
    for k in range(6):
        h, w = (int(v) for v in rng.integers(60, 260, 2))
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        lab = rng.integers(0, 20, (h, w)).astype(np.uint8) \
            if with_label else None
        joints = rng.uniform(-10, 270, (16, 2)) if with_joints else None
        kw = dict(scale=float(rng.uniform(0.4, 2.0)),
                  rot_deg=float(rng.uniform(-40, 40)) if k % 3 else 0.0,
                  crop_dx=float(rng.integers(-60, 60)),
                  crop_dy=float(rng.integers(-60, 60)), flip=flip,
                  out_hw=(96, 80), swap_lut=lut, as_uint8=as_uint8)
        a = jfast.fused_augment(img, lab, joints, **kw)
        b = tfast.fused_augment(img, lab, joints, **kw)
        assert b[0].dtype == (np.uint8 if as_uint8 else np.float32)
        assert b[0].shape == (96, 80, 3)
        assert _image_diff(b[0], a[0]) <= (GREY_ATOL if as_uint8
                                           else F32_ATOL)
        if with_label:
            np.testing.assert_array_equal(b[1], a[1])
        else:
            assert b[1] is None
        if with_joints:
            assert b[2].dtype == np.float32
            np.testing.assert_allclose(b[2], a[2], atol=JOINT_ATOL, rtol=0)
        else:
            assert b[2] is None


@pytest.mark.parametrize("device_normalize", [True, False])
@pytest.mark.parametrize("is_train", [True, False])
def test_fast_lip_dataset_matches_npp_tpu(lip_tree, is_train,
                                          device_normalize):
    split = "train" if is_train else "val"
    layout = LIP.data
    im_root, anno, seg_root = (layout[k] for k in tlip.SPLITS[split])
    kw = dict(crop_size=CROP, is_train=is_train, seed=9,
              device_normalize=device_normalize)
    ref = jlip.FastLIPDataset(lip_tree, im_root, anno, seg_root, **kw)
    ours = tlip.dataset_for(layout, split, lip_tree,
                            cls=tlip.FastLIPDataset, **kw)
    assert ours.image_names() == ref.image_names()
    draws = np.random.default_rng(9)
    flips = 0
    for i in range(DRAWS):
        a, b = ref[i], ours[i]
        assert a["name"] == b["name"]
        for key in ("visibility", "scale", "crop_param", "par"):
            np.testing.assert_array_equal(b[key], a[key], err_msg=key)
            assert b[key].dtype == a[key].dtype, key
        np.testing.assert_allclose(b["joints"], a["joints"], atol=JOINT_ATOL,
                                   rtol=0)
        assert b["image"].dtype == a["image"].dtype
        assert _image_diff(b["image"], a["image"]) <= (
            GREY_ATOL if device_normalize else F32_ATOL)
        if is_train:
            flips += bool(draws.random(5)[4] < 0.5)
    if is_train:
        assert 0 < flips < DRAWS


def test_fused_augment_checks_its_input():
    im, geo = np.zeros((40, 30, 3), np.uint8), dict(
        scale=1.0, rot_deg=0.0, crop_dx=0.0, crop_dy=0.0, flip=False,
        out_hw=(16, 16))
    for image, label, joints, lut in (
            (im[..., 0], None, None, None),
            (im, np.zeros((30, 40), np.uint8), None, None),
            (im, None, np.zeros((16, 3)), None),
            (im, None, None, np.arange(20, dtype=np.uint8))):
        with pytest.raises(ValueError):
            tfast.fused_augment(image, label, joints, swap_lut=lut, **geo)


def test_fast_aug_raises_without_the_host_library(lip_tree, monkeypatch,
                                                  tmp_path):
    """No fallback: when the host library cannot be built, the fused warp
    and the fused reader raise."""
    ds = tlip.dataset_for(LIP.data, "train", lip_tree,
                          cls=tlip.FastLIPDataset, crop_size=CROP,
                          is_train=True, seed=0)
    monkeypatch.setattr(imgproc, "_LIBRARY", {})
    monkeypatch.setattr(imgproc, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(imgproc.shutil, "which", lambda name: None)
    im, lab = np.zeros((40, 30, 3), np.uint8), np.zeros((40, 30), np.uint8)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        tfast.fused_augment(im, lab, None, scale=1.0, rot_deg=0.0,
                            crop_dx=0.0, crop_dy=0.0, flip=False,
                            out_hw=(16, 16))
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        ds._build_sample(im, lab, np.zeros((16, 2)), np.ones(16, bool),
                         np.array([[15.0, 20.0]]), "probe", ds.flip_pairs)


# -- the host targets ---------------------------------------------------------

@pytest.mark.parametrize("edge_width", [1, 3, 5])
def test_host_generate_edge_matches_cv2(edge_width):
    rng = np.random.default_rng(edge_width)
    for h, w in ((37, 53), (64, 64), (5, 9)):
        lab = np.zeros((h, w), np.uint8)
        for _ in range(6):
            y0, x0 = rng.integers(0, h), rng.integers(0, w)
            lab[y0:y0 + h // 3, x0:x0 + w // 3] = rng.integers(0, 20)
        lab[rng.random((h, w)) < 0.05] = 255
        lab[:, : w // 7] = 255
        ref = jtgt.generate_edge(lab, edge_width)
        ours = ttgt.generate_edge(lab, edge_width)
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("aux", [False, True])
def test_host_pose_targets_match_npp_tpu(aux):
    rng = np.random.default_rng(int(aux))
    kw = dict(stride=4, grid_x=96, grid_y=96, sigma=3, aux=aux)
    pairs = []
    for j in (16, 14):
        joints = rng.uniform(-20, 400, (j, 2))
        vis = (rng.random(j) > 0.2).astype(np.float32)
        pairs.append((jtgt.gen_pose_target(joints, vis, **kw),
                      ttgt.gen_pose_target(joints, vis, **kw)))
    joints = rng.uniform(0, 380, (16, 2))
    vis = (rng.random(16) > 0.2).astype(np.float32)
    pairs.append((jtgt.gen_pose_target_paf(joints, vis, **kw),
                  ttgt.gen_pose_target_paf(joints, vis, **kw)))
    for ref, ours in pairs:
        for a, b in zip(ref, ours):
            if a is None:
                assert b is None
                continue
            assert b.shape == a.shape and b.dtype == a.dtype
            np.testing.assert_allclose(b, a, atol=TARGET_ATOL, rtol=0)
    assert ttgt.LIP_BODY_PARTS == jtgt.LIP_BODY_PARTS
    hm, _ = jtgt.gen_pose_target(rng.uniform(0, 90, (16, 2)), np.ones(16),
                                 stride=4, grid_x=24, grid_y=24, sigma=2)
    np.testing.assert_allclose(
        ttgt.get_paf_by_hm(hm, np.ones(16), variable_width=aux),
        jtgt.get_paf_by_hm(hm, np.ones(16), variable_width=aux),
        atol=TARGET_ATOL, rtol=0)


# -- the CLIs -----------------------------------------------------------------

def test_train_cli_reads_a_ppp_directory(ppp_tree, tmp_path):
    root, _ = ppp_tree
    out = augment_lip.main(["--dataset", "ppp", "--data-root", root,
                            "--steps", "1", "--epochs", "1", "--out",
                            str(tmp_path), *CPU])
    res = out["result"]
    assert np.isfinite(out["train_loss"]) and np.isfinite(res["loss"])
    assert res["pck"].shape == (15,) and int(res["cm"].sum()) > 0


def test_train_cli_fast_aug_reads_a_lip_directory(lip_tree, tmp_path):
    out = augment_lip.main(["--fast-aug", "--data-root", lip_tree,
                            "--steps", "1", "--epochs", "1", "--out",
                            str(tmp_path), *CPU])
    assert np.isfinite(out["train_loss"])
    assert np.isfinite(out["result"]["loss"])


def test_clis_refuse_fast_aug_and_ppp_search_from_disk(ppp_tree, lip_tree):
    root, _ = ppp_tree
    for argv in (["--fast-aug", "--synthetic"],
                 ["--fast-aug", "--dataset", "ppp", "--data-root", root],
                 ["--dataset", "ppp", "--data-root", root, "--gt-csv",
                  os.path.join(lip_tree, "pose_gt.csv")]):
        with pytest.raises(SystemExit):
            augment_lip.main(argv + CPU)
    with pytest.raises(SystemExit):
        search_lip.main(["--dataset", "ppp", "--data-root", root, *CPU])
