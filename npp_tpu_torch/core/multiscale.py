"""Multi-scale sliding-window parsing inference.

Port of ``npp_tpu/core/multiscale.py`` as eager PyTorch on the image's
device: for every scale the image is resized (bilinear), padded to whole
windows, cut into crop-sized windows at a stride of 2/3 of the crop; all
windows of all scales, and their horizontal flips, go through the model
together (in chunks of ``chunk`` windows: eval-mode BN makes that exact);
per scale the windows' exp-logits are overlap-added and divided by the
window count, resized back to the image, and summed over the scales. The
window grid keeps the reference's clipped tail: the last window starts at
``(n - 1) * stride`` and runs past the image edge, into padding that the
accumulation then crops away.

``mesh`` (a ``parallel.mesh.make_grid`` grid) splits the windows over the
data axis: each data index runs a contiguous share of the windows (with
their flips), accumulates their exp-logits into its own partial sum and
the partial sums are added over the data group, so every rank returns
the whole result. npp_tpu pads its one batched program's tile count to
lcm(8, n_data); eager chunks have no fixed shape, so the port pads
nothing. The ranks of a space axis run the same windows.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from npp_tpu_torch.ops.resize import resize_bilinear
from npp_tpu_torch.parallel.mesh import all_sum


def _tile_origins(length: int, crop: int, stride: int) -> list[int]:
    """Window origins along one axis, at ``stride`` steps; the last window
    is clipped at the edge, not shifted back to fit."""
    if length <= crop:
        return [0]
    n = int(np.ceil((length - crop) / stride)) + 1
    return [i * stride for i in range(n)]


@functools.lru_cache(maxsize=64)
def _geometry(oh: int, ow: int, ch: int, cw: int, scales: tuple,
              base_size: int | None) -> tuple:
    """Per scale: (resized h, w, extended canvas h, w, window origins in
    y and x, 1 / window count over the extended canvas)."""
    stride_h, stride_w = int(ch * 2.0 / 3.0), int(cw * 2.0 / 3.0)
    geo = []
    for scale in scales:
        long_size = int((base_size or max(oh, ow)) * scale + 0.5)
        if oh > ow:
            nh, nw = long_size, int(ow * long_size / oh + 0.5)
        else:
            nh, nw = int(oh * long_size / ow + 0.5), long_size
        ys = _tile_origins(max(nh, ch), ch, stride_h)
        xs = _tile_origins(max(nw, cw), cw, stride_w)
        eh, ew = ys[-1] + ch, xs[-1] + cw
        count = np.zeros((eh, ew), np.float32)
        for y in ys:
            for x in xs:
                count[y:y + ch, x:x + cw] += 1.0
        geo.append((nh, nw, eh, ew, tuple(ys), tuple(xs), 1.0 / count))
    return tuple(geo)


def multi_scale_inference(apply_fn, image: torch.Tensor, *, num_classes: int,
                          crop_size=(384, 384),
                          scales=(0.5, 0.75, 1.0, 1.25, 1.5),
                          flip: bool = True, pad_value=0.0,
                          base_size: int | None = None,
                          chunk: int = 16, mesh=None) -> torch.Tensor:
    """``image``: (1, 3, H, W) normalised, on the model's device;
    ``apply_fn(tiles)`` maps (N, 3, ch, cw) windows to (N, num_classes, ch,
    cw) logits. ``crop_size`` is (height, width). Returns (1, num_classes,
    H, W): the exp-logits summed over the scales.

    ``pad_value`` fills the windows' padding: a scalar pads with zeros, as
    the reference's windows; a 3-vector fills it with that pixel.
    ``base_size`` is the long side the scales multiply (default: the
    image's own). ``mesh`` splits the windows over its data axis (module
    docstring)."""
    _, _, oh, ow = image.shape
    ch, cw = crop_size
    geo = _geometry(oh, ow, ch, cw, tuple(float(s) for s in scales),
                    base_size)
    pad_pixel = (None if np.isscalar(pad_value) else torch.as_tensor(
        np.asarray(pad_value, np.float32).reshape(1, 3, 1, 1),
        device=image.device))
    tiles = []
    for nh, nw, eh, ew, ys, xs, _ in geo:
        scaled = resize_bilinear(image, (nh, nw), align_corners=False)
        ph, pw = eh - nh, ew - nw
        if ph or pw:
            scaled = F.pad(scaled, (0, pw, 0, ph))
            if pad_pixel is not None:
                mask = F.pad(torch.ones((1, 1, nh, nw), device=image.device),
                             (0, pw, 0, ph))
                scaled = scaled * mask + (1 - mask) * pad_pixel
        tiles.extend(scaled[0, :, y:y + ch, x:x + cw] for y in ys for x in xs)
    total = len(tiles)
    first, last = 0, total
    if mesh is not None and mesh.n_data > 1:
        per = -(-total // mesh.n_data)
        first, last = (min(mesh.d * per, total),
                       min((mesh.d + 1) * per, total))
    probs = None
    if last > first:  # a data index may get no window of a small image
        tiles = torch.stack(tiles[first:last])
        if flip:
            tiles = torch.cat([tiles, tiles.flip(3)])
        logits = torch.cat([apply_fn(tiles[i:i + chunk]).float()
                            for i in range(0, tiles.shape[0], chunk)])
        if flip:
            n_mine = last - first
            logits = 0.5 * (logits[:n_mine] + logits[n_mine:].flip(3))
        probs = torch.exp(logits)
    final = torch.zeros((1, num_classes, oh, ow), device=image.device)
    k = 0
    for nh, nw, eh, ew, ys, xs, inv_count in geo:
        preds = torch.zeros((num_classes, eh, ew), device=image.device)
        for y in ys:
            for x in xs:
                if first <= k < last:
                    preds[:, y:y + ch, x:x + cw] += probs[k - first]
                k += 1
        preds = preds * torch.as_tensor(inv_count, device=image.device)
        final = final + resize_bilinear(preds[None, :, :nh, :nw], (oh, ow),
                                        align_corners=False)
    if mesh is not None and mesh.n_data > 1:
        final = all_sum(final, mesh.data_group)
    return final
