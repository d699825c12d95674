"""Serving API: raw RGB images in, parsing maps and keypoints out.

Port of ``npp_tpu/core/predictor.py`` without cv2. The host side is
numpy: the eval-path crop (long side scaled to the crop size with a
bicubic resize that follows cv2's ``INTER_CUBIC`` size and coordinate
rules, centre crop onto a canvas of grey 128) and the way back (un-crop,
then cv2's ``INTER_NEAREST`` rule). The device side is one function per
batch: the uint8 canvases are uploaded and normalised on the device, the
direct and flipped forwards run in the model's compute dtype, and the
parsing upsample, flip fusion, argmax and the pose decode run in float32.
``pose_scales`` adds scale-list pose TTA: every scale's crop goes through
one batched forward and the heatmaps are fused on the base canvas
(``inference.fuse_multiscale_pose``) before the decode.

``mesh`` (a ``parallel.mesh.make_grid`` grid; npp_tpu's name for its
``data x space`` mesh) serves over a grid of ranks: every rank preprocesses
the whole request batch, pads it to a multiple of lcm(8, n_data), takes
its data shard and, with n_space > 1, its rows of each canvas; the
model runs on those rows (``spatial.convert_spatial``), the last stage's
heatmaps and parsing are gathered along H inside the space group before
the fusion and the decode, and the per-image labels and keypoints are
gathered over the data group, so that every rank returns the full list
in request order.

``fuse_necks`` / ``fuse_cells`` serve npp_tpu's fused layouts
(``models/augment.py``): the caller's model is left as it is, and a twin
in the fused layout, holding its weights through the state transforms,
serves. ``quantize="int8"`` serves every dense conv in int8
(``ops/quantize.py``; on the card, the hand-written int8 conv) on a copy
of the model whose weights are quantized at construction; activation
scales are dynamic until ``calibrate_int8`` installs static ones. Both
serve on a ``mesh`` too: the twin or the copy is fused, then split over
the rows, then prepared. There each dynamic scale is the max over the
whole grid (npp_tpu's one program takes it over the global activation),
and ``calibrate_int8`` runs each rank's part of every calibration batch,
so every rank holds npp_tpu's one scale tree.
"""
from __future__ import annotations

import copy
import math
import queue
import threading

import numpy as np
import torch

from npp_tpu_torch.core.inference import (FLIPPED_POSEIDX,
                                          FLIPPED_POSEIDX_PPP,
                                          decode_pose_fused,
                                          flip_parsing_fuse,
                                          fuse_multiscale_pose)
from npp_tpu_torch.data.synthetic import IMAGENET_MEAN, IMAGENET_STD
from npp_tpu_torch.models.augment import fused_twin
from npp_tpu_torch.ops.quantize import calibrate_acts, prepare_int8
from npp_tpu_torch.ops.resize import resize_bilinear
from npp_tpu_torch.parallel.mesh import all_concat
from npp_tpu_torch.parallel.spatial import convert_spatial, gather_rows
from npp_tpu_torch.parallel.tensor import sharding_of


def _cubic_taps(n_in: int, n_out: int, inv_scale: float):
    """Source rows (n_out, 4) and float32 weights (n_out, 4) of cv2's
    bicubic resize along one axis: source coordinate (d + 0.5) / scale -
    0.5 rounded to float32, A = -0.75, indices clamped to the border."""
    f = ((np.arange(n_out) + 0.5) * (1.0 / inv_scale) - 0.5).astype(
        np.float32)
    s = np.floor(f)
    t = f - s
    a, one = np.float32(-0.75), np.float32(1.0)
    t1, u = t + one, one - t
    c0 = ((a * t1 - 5 * a) * t1 + 8 * a) * t1 - 4 * a
    c1 = ((a + 2) * t - (a + 3)) * t * t + one
    c2 = ((a + 2) * u - (a + 3)) * u * u + one
    c3 = one - c0 - c1 - c2
    idx = np.clip(s.astype(np.int64)[:, None] + np.arange(-1, 3), 0, n_in - 1)
    return idx, np.stack([c0, c1, c2, c3], 1).astype(np.float32)


def resize_cubic_u8(im: np.ndarray, scale: float) -> np.ndarray:
    """``cv2.resize(im, None, fx=scale, fy=scale, interpolation=
    cv2.INTER_CUBIC)`` for (H, W, C) uint8, in float32: the output size
    is round(H * scale) x round(W * scale) (half to even), the result is
    rounded and saturated to uint8. cv2 sums in fixed point or in float
    by version and instruction set, so a pixel may differ from it by
    one grey level."""
    h, w = im.shape[:2]
    oh, ow = int(round(h * scale)), int(round(w * scale))
    yi, yc = _cubic_taps(h, oh, scale)
    xi, xc = _cubic_taps(w, ow, scale)
    src = im.astype(np.float32)
    rows = src[yi[:, 0]] * yc[:, 0, None, None]
    for k in range(1, 4):
        rows += src[yi[:, k]] * yc[:, k, None, None]
    out = rows[:, xi[:, 0]] * xc[None, :, 0, None]
    for k in range(1, 4):
        out += rows[:, xi[:, k]] * xc[None, :, k, None]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def resize_nearest_u8(im: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(im, (W', H'), interpolation=cv2.INTER_NEAREST)``:
    source index floor(d * (1 / (out / in))), clamped to the last."""
    (h, w), (oh, ow) = im.shape[:2], out_hw
    sy = np.minimum(np.floor(np.arange(oh) * (1.0 / (oh / h))), h - 1)
    sx = np.minimum(np.floor(np.arange(ow) * (1.0 / (ow / w))), w - 1)
    return im[sy.astype(np.int64)[:, None], sx.astype(np.int64)[None, :]]


def _flip_index(n_j: int) -> tuple:
    return (FLIPPED_POSEIDX if n_j == 16 else FLIPPED_POSEIDX_PPP
            if n_j == 14 else tuple(range(n_j)))


class Predictor:
    """Joint parsing + pose predictor for raw RGB images, on the device of
    ``model``'s parameters (an eval-mode NPPNet; its ``dtype`` is the
    forward's compute dtype)."""

    def __init__(self, model, *, crop_size=(384, 384), flip_test: bool = True,
                 flip_pairs=((14, 15), (16, 17), (18, 19)),
                 blur_sigma: float = 3.0, dark_decode: bool = False,
                 pose_scales: tuple = (1.0,), mesh=None,
                 quantize: str | None = None, fuse_necks: bool = False,
                 fuse_cells: bool = False):
        """``crop_size`` is (width, height). ``dark_decode`` refines the
        keypoints with the DARK step (``inference.post_process_dark``).
        ``pose_scales`` lists the scale multipliers of scale-list pose
        TTA and must hold 1.0; the parsing always comes from scale 1.0.
        ``mesh``: a grid of ranks to serve over (module docstring); with
        n_space > 1 the crop height and height / 4 must divide by it, and
        the served model is converted to run on rows in place. A grid with
        a model axis, or a model split over one, is refused: npp_tpu
        serves over ``data x space`` meshes only. ``fuse_necks`` /
        ``fuse_cells`` serve a fused twin of ``model`` (the sibling
        families are the model's ``sibling_families``);
        ``quantize="int8"`` serves int8 dense convs (module docstring)."""
        if (mesh is not None and mesh.n_model > 1) or \
                sharding_of(model) is not None:
            raise ValueError("Predictor serves over a data x space grid; it "
                             "does not run a model split over n_model > 1")
        if quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize mode {quantize!r}")
        necks = fuse_necks or model.fused_necks
        cells = fuse_cells or model.fused_cells
        if (necks, cells) != (model.fused_necks, model.fused_cells):
            model = fused_twin(model, fused_necks=necks, fused_cells=cells)
        elif quantize is not None:
            model = copy.deepcopy(model)
        self.quantize = quantize
        self.pose_scales = tuple(float(s) for s in pose_scales)
        if 1.0 not in self.pose_scales:
            raise ValueError("pose_scales must contain the base scale 1.0")
        self._base_si = self.pose_scales.index(1.0)
        self.mesh = mesh
        self._n_data = 1 if mesh is None else mesh.n_data
        if mesh is not None and mesh.n_space > 1:
            ch_ = crop_size[1]
            if ch_ % mesh.n_space or (ch_ // 4) % mesh.n_space:
                raise ValueError(
                    f"crop height {ch_} (and {ch_}//4) must divide "
                    f"space={mesh.n_space} for spatial serving")
            convert_spatial(model, mesh)
        if quantize is not None:
            prepare_int8(model, mesh)
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.crop_size = tuple(crop_size)
        self.flip_test = flip_test
        self.flip_pairs = flip_pairs
        self.blur_sigma = blur_sigma
        self.dark_decode = dark_decode
        self._mean = torch.as_tensor(IMAGENET_MEAN,
                                     device=self.device).reshape(1, 3, 1, 1)
        self._std = torch.as_tensor(IMAGENET_STD,
                                    device=self.device).reshape(1, 3, 1, 1)

    # -- device side -----------------------------------------------------

    def _forward(self, x: torch.Tensor):
        """Last-stage pose heatmaps and parsing logits in float32 (whole
        maps: on a space axis, gathered from every rank's rows)."""
        pose_list, par_list = self.model(x)
        hm, par = pose_list[-1][0].float(), par_list[-1][0].float()
        if self.mesh is not None and self.mesh.n_space > 1:
            hm, par = gather_rows(hm, self.mesh), gather_rows(par, self.mesh)
        return hm, par

    def _own_rows(self, canvases):
        """This rank's rows of (B, ch, cw, 3) canvases (all of them
        without a space axis)."""
        if self.mesh is None or self.mesh.n_space == 1:
            return canvases
        rows = self.crop_size[1] // self.mesh.n_space
        return canvases[:, self.mesh.s * rows:(self.mesh.s + 1) * rows]

    def _normalize(self, image_u8: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 -> ImageNet-normalised (B, 3, H, W) float32;
        the NHWC layout stays underneath (channels_last)."""
        x = image_u8.permute(0, 3, 1, 2).to(torch.float32)
        return (x / 255.0 - self._mean) / self._std

    @torch.inference_mode()
    def fuse(self, flat_u8: torch.Tensor, crop_params: torch.Tensor):
        """The forwards and the fusion, before the decode. ``flat_u8``:
        (B * S, ch, cw, 3) uint8 canvases, image-major (each image's S
        scale crops in a row, in ``pose_scales`` order); ``crop_params``:
        (S, B, 1, 8). Returns the base scale's parsing logits (B, C, ch,
        cw), flip-fused, and the pose heatmaps (B, J, ch, cw), flip-fused
        and, with several scales, fused on the base canvas; float32."""
        ch, cw = self.crop_size[1], self.crop_size[0]
        s = len(self.pose_scales)
        b = flat_u8.shape[0] // s
        x = self._normalize(self._own_rows(flat_u8))
        pose_hm, par_logits = self._forward(x)

        def base(t):
            return t.reshape((b, s) + t.shape[1:])[:, self._base_si]

        def up(t):
            return resize_bilinear(t, (ch, cw), align_corners=False)

        par, hm = up(base(par_logits)), up(pose_hm)
        n_j = hm.shape[1]
        if self.flip_test:
            fhm, fpar = self._forward(x.flip(3))
            par = flip_parsing_fuse(par, up(base(fpar)), self.flip_pairs)
            perm = torch.as_tensor(_flip_index(n_j), device=fhm.device)
            hm = 0.5 * (hm + up(fhm.index_select(1, perm)).flip(3))
        if s > 1:
            hm = fuse_multiscale_pose(
                hm.reshape(b, s, n_j, ch, cw).transpose(0, 1), crop_params,
                self.pose_scales, self._base_si)
        return par, hm

    @torch.inference_mode()
    def _serve(self, flat_u8, crop_params, scales):
        """Labels (B, ch, cw) uint8 and keypoints (B, J, 3) of a batch."""
        par, hm = self.fuse(flat_u8, crop_params)
        kp = decode_pose_fused(hm, crop_params[self._base_si], scales,
                               blur_sigma=self.blur_sigma,
                               dark=self.dark_decode)
        return par.argmax(dim=1).to(torch.uint8), kp

    def calibrate_int8(self, images, *, batch_size: int = 8) -> None:
        """Static int8 activation scales from ``images`` (raw RGB, through
        the serving preprocess), in batches of ``batch_size`` with the
        last one repeat-padded as npp_tpu's: the int8 forward records
        each dense conv input's absmax (``ops/quantize.calibrate_acts``),
        and later batches quantize with absmax / 127, clipped. On a
        ``mesh`` each rank runs its data shard and rows of every batch
        (``batch_size`` must divide by n_data), and the scales come out
        equal on every rank."""
        if self.quantize != "int8":
            raise ValueError("calibrate_int8 requires quantize='int8'")
        if not images:
            raise ValueError("calibrate_int8 needs at least one image")
        if batch_size % self._n_data:
            raise ValueError(f"calibrate_int8: batch_size {batch_size} not "
                             f"divisible by data={self._n_data}")
        pre = np.stack([self.preprocess(im)[0] for im in images])
        n = len(images)
        padded = -(-n // batch_size) * batch_size
        if padded != n:
            pre = np.concatenate(
                [pre, np.repeat(pre[-1:], padded - n, axis=0)])
        per = batch_size // self._n_data
        d = 0 if self.mesh is None else self.mesh.d
        calibrate_acts(self.model, (
            self._normalize(self._own_rows(self._to_device(
                pre[i + d * per:i + (d + 1) * per])))
            for i in range(0, padded, batch_size)))

    # -- host side -------------------------------------------------------

    def preprocess(self, im_rgb: np.ndarray, scale_mult: float = 1.0):
        """The eval-path geometry: the long side scaled to the crop width
        (times ``scale_mult``), a centre crop onto a grey canvas. Returns
        (canvas (ch, cw, 3) uint8, crop_param (1, 8) float32, scale). The
        reference's quirks stay: ``int()`` truncates toward zero and the
        crop's end drops the last row and column."""
        cw, ch = self.crop_size
        scale = scale_mult * float(cw) / max(im_rgb.shape[0],
                                             im_rgb.shape[1])
        scaled = resize_cubic_u8(im_rgb, scale)
        h, w = scaled.shape[:2]
        canvas = np.full((ch, cw, 3), 128, np.uint8)
        cy, cx = h / 2.0, w / 2.0
        off_sx, off_sy = int(cx - cw / 2.0), int(cy - ch / 2.0)
        crop_sx, crop_sy = max(off_sx, 0), max(off_sy, 0)
        store_sx, store_sy = max(-off_sx, 0), max(-off_sy, 0)
        crop_ex = min(int(cx + cw / 2.0), w - 1)
        crop_ey = min(int(cy + ch / 2.0), h - 1)
        store_ex = store_sx + (crop_ex - crop_sx)
        store_ey = store_sy + (crop_ey - crop_sy)
        canvas[store_sy:store_ey, store_sx:store_ex] = \
            scaled[crop_sy:crop_ey, crop_sx:crop_ex]
        crop_param = np.array([[crop_sx, crop_sy, store_sx, store_sy,
                                crop_ex, crop_ey, store_ex, store_ey]],
                              np.float32)
        return canvas, crop_param, scale

    def __call__(self, im_rgb: np.ndarray) -> dict:
        """{'parsing': (H, W) labels at the image's size, 'keypoints':
        (J, 3) x, y, score in image coordinates, 'parsing_crop': labels at
        crop size}."""
        return self.predict_batch([im_rgb])[0]

    def predict_batch(self, images, *, pad_to_multiple: int = 8) -> list:
        """One ``__call__``-style dict per image. The device batch is padded
        to a multiple of ``pad_to_multiple`` by repeating the last image
        (a single image runs alone); pad rows are dropped."""
        if not images:
            return []
        pre = [self.preprocess(im) for im in images]
        return self._predict_preprocessed(pre, images, pad_to_multiple)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _predict_preprocessed(self, pre, images, pad_to_multiple):
        n = len(images)
        if self._n_data > 1:
            pad_to_multiple = math.lcm(pad_to_multiple, self._n_data)
        padded = (n if n == 1 and self._n_data == 1
                  else -(-n // pad_to_multiple) * pad_to_multiple)
        canv_rows, cp_rows = [], []  # per scale, (padded, ...)
        for si, sm in enumerate(self.pose_scales):
            ps = (pre if si == self._base_si
                  else [self.preprocess(im, scale_mult=sm) for im in images])
            rows = [p[:2] for p in ps] + [ps[-1][:2]] * (padded - n)
            canv_rows.append(np.stack([r[0] for r in rows]))
            cp_rows.append(np.stack([r[1] for r in rows]))
        scales = np.asarray([p[2] for p in pre] + [pre[-1][2]] * (padded - n),
                            np.float32)
        stack = np.stack(canv_rows)                      # (S, B, ch, cw, 3)
        flat = stack.transpose(1, 0, 2, 3, 4).reshape((-1,) + stack.shape[2:])
        cps = np.stack(cp_rows)
        dev_scales = scales
        if self._n_data > 1:  # this rank's images (image-major: all scales)
            per = padded // self._n_data
            mine = slice(self.mesh.d * per, (self.mesh.d + 1) * per)
            s = len(self.pose_scales)
            flat = flat[mine.start * s:mine.stop * s]
            cps, dev_scales = cps[:, mine], scales[mine]
        par_crops, kp = self._serve(self._to_device(flat),
                                    self._to_device(cps),
                                    self._to_device(dev_scales))
        if self._n_data > 1:
            par_crops = all_concat(par_crops, self.mesh.data_group)
            kp = all_concat(kp, self.mesh.data_group)
        par_crops, kp = par_crops.cpu().numpy(), kp.cpu().numpy()
        base_cp = cp_rows[self._base_si]
        return [self._postprocess(images[i], par_crops[i], base_cp[i],
                                  scales[i], kp[i]) for i in range(n)]

    def predict_stream(self, images, *, batch_size: int = 8,
                       prefetch: int = 2):
        """Generator of ``__call__``-style dicts over an iterable of
        images, in input order. A worker thread preprocesses one batch
        ahead of the device; an exception there (an unreadable image, a
        failing iterator) is raised here. The tail batch is padded as in
        ``predict_batch``."""
        q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        end = object()

        def feed():
            try:
                chunk, pres = [], []
                for im in images:
                    chunk.append(im)
                    pres.append(self.preprocess(im))
                    if len(chunk) == batch_size:
                        q.put((pres, chunk))
                        chunk, pres = [], []
                if chunk:
                    q.put((pres, chunk))
                q.put(end)
            except BaseException as e:  # noqa: BLE001 -- raised below
                q.put(e)

        t = threading.Thread(target=feed, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is end:
                break
            if isinstance(item, BaseException):
                t.join()
                raise item
            pres, chunk = item
            yield from self._predict_preprocessed(pres, chunk, 8)
        t.join()

    def _postprocess(self, im_rgb, par_crop, crop_param, scale,
                     keypoints) -> dict:
        """Un-crop the crop's labels onto the scaled image, then a nearest
        resize back to the image's size."""
        oh, ow = im_rgb.shape[:2]
        cp = crop_param[0].astype(int)
        sh, sw = int(round(oh * scale)), int(round(ow * scale))
        full = np.zeros((sh, sw), np.uint8)
        full[cp[1]:cp[5], cp[0]:cp[4]] = par_crop[cp[3]:cp[7], cp[2]:cp[6]]
        return {"parsing": resize_nearest_u8(full, (oh, ow)),
                "keypoints": keypoints, "parsing_crop": par_crop}
