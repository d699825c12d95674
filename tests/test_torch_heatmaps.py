"""The port's heatmap renderer and target completion against npp_tpu (CPU).

On the CPU the port's renderer runs its plain PyTorch version; the CUDA
kernel itself is checked against that version on the card by
``chip_smoke.py`` (phase 3). Inputs are made with numpy from a seed and
fed to both packages; NHWC <-> NCHW at compare.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from npp_tpu.data import loader as jloader
from npp_tpu.data import synthetic as jsynthetic
from npp_tpu.data import targets as jtargets
from npp_tpu.ops.pallas_kernels import render_heatmaps_pallas

from npp_tpu_torch.data import loader as tloader
from npp_tpu_torch.data import synthetic as tsynthetic
from npp_tpu_torch.data import targets as ttargets
from npp_tpu_torch.ops import heatmaps

torch.set_num_threads(1)
ATOL = 1e-6  # the renderers share op order; exp differs by ~1 ulp


def _joints(seed, b=2, j=16, lo=-20.0, hi=120.0):
    rng = np.random.default_rng(seed)
    joints = rng.uniform(lo, hi, (b, j, 2)).astype(np.float32)
    vis = (rng.random((b, j)) > 0.2).astype(np.float32)
    return joints, vis


@pytest.mark.parametrize("gy,gx", [(24, 24), (24, 18)])
def test_reference_matches_pallas_and_xla(gy, gx):
    joints, vis = _joints(7 + gx)
    kw = dict(stride=4, grid_x=gx, grid_y=gy)
    tm, ta = heatmaps.render_heatmaps_reference(
        torch.from_numpy(joints), torch.from_numpy(vis), sigma=3.0, **kw)
    pm, pa = render_heatmaps_pallas(jnp.asarray(joints), jnp.asarray(vis),
                                    sigma=3.0, **kw)
    xm, xa = jtargets.gen_pose_target_device(
        jnp.asarray(joints), jnp.asarray(vis), sigma=3, aux=True, **kw)
    assert tm.shape == (2, gy, gx, 17)
    for ours, ref in ((tm, pm), (ta, pa), (tm, xm), (ta, xa)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)


def test_render_heatmaps_on_cpu_is_the_plain_version():
    joints, vis = _joints(3, b=3, j=14)
    before = heatmaps.render_heatmaps.launches
    got = heatmaps.render_heatmaps(torch.from_numpy(joints),
                                   torch.from_numpy(vis), grid_x=18,
                                   grid_y=24, sigma=2.0)
    ref = heatmaps.render_heatmaps_reference(
        torch.from_numpy(joints), torch.from_numpy(vis), grid_x=18,
        grid_y=24, sigma=2.0)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert heatmaps.render_heatmaps.launches == before  # no kernel launched


def test_render_heatmaps_refuses_other_devices():
    joints = torch.zeros((1, 2, 2), device="meta")
    vis = torch.zeros((1, 2), device="meta")
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        heatmaps.render_heatmaps(joints, vis)


def test_gen_pose_target_device_matches_jax():
    joints, vis = _joints(11)
    tm, ta = ttargets.gen_pose_target_device(
        torch.from_numpy(joints), torch.from_numpy(vis), stride=4,
        grid_x=20, grid_y=24, sigma=3)
    xm, xa = jtargets.gen_pose_target_device(
        jnp.asarray(joints), jnp.asarray(vis), stride=4, grid_x=20,
        grid_y=24, sigma=3, aux=True)
    assert tm.shape == (2, 17, 24, 20)  # NCHW view of the NHWC maps
    assert tm.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(tm.permute(0, 2, 3, 1).numpy(),
                               np.asarray(xm), atol=ATOL)
    np.testing.assert_allclose(ta.permute(0, 2, 3, 1).numpy(),
                               np.asarray(xa), atol=ATOL)


def test_generate_edge_device_matches_jax():
    rng = np.random.default_rng(5)
    label = rng.integers(0, 4, (2, 23, 17)).astype(np.uint8)
    label[:, 5:9, 3:11] = 255
    ours = ttargets.generate_edge_device(torch.from_numpy(label))
    ref = jtargets.generate_edge_device(jnp.asarray(label))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("device_normalize", [True, False])
def test_synthetic_dataset_matches_jax(device_normalize):
    kw = dict(length=3, crop_size=(48, 40), num_joints=16, num_classes=20,
              seed=4, device_normalize=device_normalize)
    ours, ref = tsynthetic.SyntheticDataset(**kw), jsynthetic.SyntheticDataset(**kw)
    np.testing.assert_array_equal(tsynthetic.IMAGENET_MEAN,
                                  jsynthetic.IMAGENET_MEAN)
    np.testing.assert_array_equal(tsynthetic.IMAGENET_STD,
                                  jsynthetic.IMAGENET_STD)
    for i in range(len(ours)):
        a, b = ours[i], ref[i]
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def _batch(n=2, size=64, seed=2):
    ds = tsynthetic.SyntheticDataset(length=n, crop_size=(size, size),
                                     num_joints=16, num_classes=20,
                                     seed=seed, device_normalize=True)
    batch = tloader.collate([ds[i] for i in range(n)])
    batch["par"][0, :6, :10] = 255  # an ignored region
    return batch


def test_target_renderer_matches_jax():
    b = _batch()
    ours = tloader.make_target_renderer(normalize_images=True)(
        *(torch.from_numpy(b[k])
          for k in ("image", "par", "joints", "visibility")))
    ref = jloader.make_target_renderer(normalize_images=True)(
        *(jnp.asarray(b[k]) for k in ("image", "par", "joints", "visibility")))
    np.testing.assert_array_equal(ours["edge"].numpy(), np.asarray(ref["edge"]))
    assert (ours["edge"][0, :6, :10] == 255).all()
    np.testing.assert_allclose(ours["image"].permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref["image"]), atol=ATOL)
    for k in ("pose", "pose_aux"):
        assert ours[k].shape == (2, 16, 16, 16)
        np.testing.assert_allclose(ours[k].permute(0, 2, 3, 1).numpy(),
                                   np.asarray(ref[k]), atol=ATOL)
    np.testing.assert_array_equal(ours["pose_weight"].numpy(),
                                  np.asarray(ref["pose_weight"]))


def test_target_renderer_rejects_raw_images_without_normalising():
    b = _batch(n=1)
    render = tloader.make_target_renderer(normalize_images=False)
    with pytest.raises(ValueError, match="uint8"):
        render(*(torch.from_numpy(b[k])
                 for k in ("image", "par", "joints", "visibility")))


def test_loader_yields_rendered_batches_in_order():
    ds = tsynthetic.SyntheticDataset(length=5, crop_size=(32, 32),
                                     num_joints=16, num_classes=20,
                                     device_normalize=True)
    loader = tloader.DataLoader(
        ds, 2, device="cpu", num_workers=2,
        renderer=tloader.make_target_renderer(normalize_images=True))
    batches = list(loader)
    assert len(batches) == len(loader) == 3
    assert [b["image"].shape[0] for b in batches] == [2, 2, 1]
    assert np.concatenate([b["index"] for b in batches]).tolist() == [0, 1, 2, 3, 4]
    assert batches[2]["names"] == ["synthetic_000004"]
    assert batches[0]["pose"].shape == (2, 16, 8, 8)
    assert batches[0]["image"].dtype == torch.float32


# The kernel's arithmetic, in float32 numpy (each op rounds to nearest).
SIGMAS = [1.5, 2.0, 2.5, 3.0, 6.0]


def _d2(seed, sigma):
    """Squared distances of seeded joints to a 96x96 stride-4 grid, and a
    band of values around the cut at 2 sigma."""
    rng = np.random.default_rng(seed)
    centres = np.float32(1.5) + np.arange(96, dtype=np.float32) * np.float32(4)
    joints = rng.uniform(-20, 404, (40, 2)).astype(np.float32)
    dx = centres[None, None, :] - joints[:, 0, None, None]
    dy = centres[None, :, None] - joints[:, 1, None, None]
    d2 = (dx * dx + dy * dy).ravel()
    edge = np.float32(4 * 2 * sigma * sigma * heatmaps.TRUNC)
    band = edge * rng.uniform(0.999, 1.001, 20000).astype(np.float32)
    return np.concatenate([d2, band, edge[None]])


@pytest.mark.parametrize("sigma", SIGMAS)
def test_aux_exponent_is_a_quarter_of_the_main_one(sigma):
    two = np.float32(2.0 * sigma * sigma)
    eight = np.float32(2.0 * (2.0 * sigma) * (2.0 * sigma))
    assert eight == np.float32(4) * two
    d2 = _d2(int(sigma * 10), sigma)
    quarter = (d2 / two) * np.float32(0.25)
    aux = d2 / eight
    np.testing.assert_array_equal(quarter.view(np.uint32), aux.view(np.uint32))
    trunc = np.float32(heatmaps.TRUNC)

    def cut_exp(e):
        return np.where(e > trunc, np.float32(0), np.exp(-e))

    assert (aux > trunc).any() and (aux <= trunc).any()
    np.testing.assert_array_equal(cut_exp(quarter).view(np.uint32),
                                  cut_exp(aux).view(np.uint32))


@pytest.mark.parametrize("sigma", SIGMAS)
def test_cut_threshold_only_skips_pairs_over_the_cut(sigma):
    two_sig2 = 2.0 * sigma * sigma
    t = np.float32(heatmaps.cut_threshold(two_sig2))
    two = np.float32(two_sig2)
    eight = np.float32(4) * two
    trunc = np.float32(heatmaps.TRUNC)
    # every float32 within 4096 ulps of the threshold, and seeded ones
    near = (t.view(np.uint32) + np.arange(-4096, 4097)).astype(np.uint32)
    d2 = np.concatenate([near.view(np.float32), _d2(3, sigma)])
    skipped = d2 > t
    assert skipped.any() and (~skipped).any()
    assert (d2[skipped] / two > trunc).all()
    assert (d2[skipped] / eight > trunc).all()
    # and it is tight: a few ulps above 4 * TRUNC * 2 sigma^2
    assert float(t) <= 4 * float(trunc) * float(two) * (1 + 2**-20)


@pytest.mark.parametrize("shape,sms,expect", [
    # (B, J, gy, gx), SMs -> (P, tiles, span, grid, smem bytes, tail bytes)
    # P = 128 while 4 buffers * P * (J+1) * 4 B <= 48 KiB, else halved;
    # smem = 4 B * (4 P (J+1) + 3 span J + 3 P); grid = min(tiles,
    # SMs * min(2048 / 256, 233472 // (smem + 1024))).
    ((8, 16, 96, 96), 132, (128, 576, 2, 576, 36736, 8704)),     # eval slice
    ((16, 16, 96, 96), 132, (128, 1152, 2, 792, 36736, 8704)),   # train slice
    ((16, 16, 96, 96), 10, (128, 1152, 2, 60, 36736, 8704)),
    ((3, 14, 96, 72), 132, (128, 162, 2, 162, 32592, 7680)),     # ragged
    ((1, 13, 25, 23), 132, (128, 5, 1, 5, 30364, 3528)),         # tail % 16 = 8
    ((2, 30, 96, 96), 132, (64, 288, 2, 288, 33232, 7936)),      # P halved
    ((2, 200, 96, 96), 132, (8, 2304, 2, 924, 30624, 6432)),     # P = 8
    ((4, 16, 1, 1), 132, (128, 1, 4, 1, 37120, 272)),            # spans 4
])
def test_launch_geometry(shape, sms, expect):
    g = heatmaps.launch_geometry(*shape, sms)
    assert (g.tile_pixels, g.num_tiles, g.span, g.grid, g.smem_bytes,
            g.tail_bytes) == expect
    assert g.tile_pixels % 4 == 0 and g.smem_bytes <= heatmaps.SMEM_BLOCK_LIMIT
    b, j, gy, gx = shape
    assert (g.num_tiles - 1) * g.tile_pixels * (j + 1) * 4 + g.tail_bytes \
        == b * gy * gx * (j + 1) * 4


def test_launch_geometry_refuses_what_shared_memory_cannot_hold():
    with pytest.raises(ValueError, match="shared memory"):
        heatmaps.launch_geometry(2, 3000, 96, 96, 132)
