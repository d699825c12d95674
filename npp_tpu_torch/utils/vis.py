"""Parsing palettes, PNG files and the debug drawings without PIL or cv2.

Port of ``npp_tpu/utils/vis.py``: the PASCAL-style palette, label
colouring and the indexed parsing PNG (``:17-50``), and the drawing
helpers (``:52-110``): ``overlay_parsing``, ``overlay_heatmap``,
``draw_skeleton`` and ``save_debug_batch``. PNGs are written with the
standard library (``zlib`` + ``struct``): 8-bit colour type 3 with a
``PLTE`` chunk for the parsing maps, colour type 2 (RGB) or 0 (grey)
for ``save_png``. ``read_png`` / ``decode_png`` read the PNGs the port
and common encoders write (8-bit grey, RGB, RGBA or palette, not
interlaced, any of the five row filters); ``read_image`` feeds the
serving CLI and the LIP reader from ``.jpg`` / ``.jpeg`` (the host JPEG
decoder, ``data/imgproc.py``), ``.png`` or ``.npy`` files.

The drawing helpers give what npp_tpu's cv2 calls give, pixel for
pixel: each cv2 call has its rule here (``add_weighted``,
``apply_jet``, ``data/imgproc.resize_linear``, ``draw_line``,
``fill_circle``; see each docstring).
"""
from __future__ import annotations

import math
import os
import struct
import zlib

import numpy as np

from npp_tpu_torch.data import imgproc

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 6: 4}  # colour type -> samples


def get_palette(num_cls: int) -> list[int]:
    """PASCAL VOC colour map: ``3 * num_cls`` values, RGB per class."""
    palette = [0] * (num_cls * 3)
    for j in range(num_cls):
        lab, i = j, 0
        while lab:
            palette[j * 3 + 0] |= ((lab >> 0) & 1) << (7 - i)
            palette[j * 3 + 1] |= ((lab >> 1) & 1) << (7 - i)
            palette[j * 3 + 2] |= ((lab >> 2) & 1) << (7 - i)
            i += 1
            lab >>= 3
    return palette


def colorize_parsing(pred: np.ndarray, num_cls: int = 20) -> np.ndarray:
    """(H, W) labels -> (H, W, 3) uint8 RGB."""
    pal = np.array(get_palette(max(num_cls, int(pred.max()) + 1)),
                   np.uint8).reshape(-1, 3)
    return pal[pred.astype(np.int64)]


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def save_parsing_png(pred: np.ndarray, path: str, num_cls: int = 20) -> None:
    """Write (H, W) labels as an indexed PNG whose palette is
    ``get_palette(num_cls)``."""
    labels = np.ascontiguousarray(pred, dtype=np.uint8)
    h, w = labels.shape
    rows = np.zeros((h, w + 1), np.uint8)  # filter byte 0 (None) per row
    rows[:, 1:] = labels
    header = struct.pack(">IIBBBBB", w, h, 8, 3, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"PLTE", bytes(get_palette(num_cls)))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))


def save_png(path: str, pixels: np.ndarray) -> None:
    """Write (H, W, 3) uint8 RGB as an 8-bit colour type 2 PNG, or (H, W)
    uint8 as colour type 0 (grey): the file ``cv2.imwrite(path,
    pixels[:, :, ::-1])`` writes, as decoded pixels."""
    pix = np.ascontiguousarray(pixels, dtype=np.uint8)
    if not (pix.ndim == 2 or (pix.ndim == 3 and pix.shape[2] == 3)):
        raise ValueError(f"save_png takes (H, W, 3) RGB or (H, W) grey "
                         f"uint8, got {pix.shape}")
    h, w = pix.shape[:2]
    rows = np.zeros((h, pix[0].size + 1), np.uint8)  # filter byte 0 a row
    rows[:, 1:] = pix.reshape(h, -1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2 if pix.ndim == 3 else 0,
                         0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (None, Sub, Up, Average, Paeth)."""
    data = np.frombuffer(raw, np.uint8)
    if data.size != h * (stride + 1):
        raise ValueError(f"PNG image data holds {data.size} bytes, "
                         f"expected {h * (stride + 1)}")
    data = data.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(data[y, 0]), data[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:
            cur = (np.cumsum(line.reshape(-1, bpp).astype(np.int64), axis=0)
                   & 0xFF).astype(np.uint8).reshape(-1)
        elif kind == 2:
            cur = line + prior
        elif kind in (3, 4):
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                if kind == 3:
                    cur[i] = (cur[i] + ((a + up[i]) >> 1)) & 0xFF
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    cur[i] = (cur[i] + _paeth(a, up[i], c)) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {kind}")
        out[y] = cur
        prior = out[y]
    return out


def read_png(path: str) -> tuple[np.ndarray, np.ndarray | None]:
    """Read an 8-bit, non-interlaced PNG file: ``decode_png`` of its
    bytes."""
    with open(path, "rb") as f:
        return decode_png(f.read(), str(path))


def decode_png(blob: bytes, path: str = "<bytes>"
               ) -> tuple[np.ndarray, np.ndarray | None]:
    """Decode an 8-bit, non-interlaced PNG; ``path`` names it in errors.
    Returns (pixels, palette): the pixels (H, W) for grey or palette
    images, else (H, W, C) with C = 3 or 4; the palette (N, 3) uint8 for
    colour type 3, else None."""
    if blob[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, palette, idat = 8, None, None, []
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos:pos + 4])
        kind = blob[pos + 4:pos + 8]
        data = blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3).copy()
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"{path}: only 8-bit, non-interlaced grey, RGB, "
                         f"RGBA and palette PNGs are read (bit depth {depth}, "
                         f"colour type {ctype}, interlace {interlace})")
    ch = _CHANNELS[ctype]
    pix = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    pix = pix.reshape(h, w) if ch == 1 else pix.reshape(h, w, ch)
    return pix, (palette if ctype == 3 else None)


def check_readable(path: str) -> None:
    """Raise ValueError naming the format unless ``read_image`` reads it."""
    ext = os.path.splitext(path)[1].lower()
    if ext not in (".jpg", ".jpeg", ".png", ".npy"):
        raise ValueError(f"{path}: the {ext or 'extensionless'} format is "
                         f"not read here; give .jpg, .png or .npy (H, W, 3) "
                         f"uint8 RGB")


def read_image(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB from a ``.jpg`` / ``.jpeg`` (the host decoder:
    what ``cv2.imread(path, 1)`` gives, as RGB; the files it refuses raise
    ValueError), a ``.png`` (alpha dropped, grey and palette expanded) or
    a ``.npy`` holding (H, W, 3) uint8 RGB."""
    check_readable(path)
    if path.lower().endswith((".jpg", ".jpeg")):
        return imgproc.read_jpeg(path)
    if path.lower().endswith(".npy"):
        im = np.load(path)
        if im.dtype != np.uint8 or im.ndim != 3 or im.shape[2] != 3:
            raise ValueError(f"{path}: expected (H, W, 3) uint8 RGB, got "
                             f"{im.dtype} {im.shape}")
        return im
    pix, palette = read_png(path)
    if palette is not None:
        return palette[pix]
    if pix.ndim == 2:
        return np.repeat(pix[..., None], 3, axis=2)
    return np.ascontiguousarray(pix[..., :3])


# -- the drawing helpers (npp_tpu/utils/vis.py:52-110) ----------------------

# OpenCV's COLORMAP_JET as RGB: row v is the colour cv2.applyColorMap gives
# grey level v, channels reversed.
_JET_HEX = (
    "00008000008400008800008c00009000009400009800009c0000a00000a40000"
    "a80000ac0000b00000b40000b80000bc0000c00000c40000c80000cc0000d000"
    "00d40000d80000dc0000e00000e40000e80000ec0000f00000f40000f80000fc"
    "0000ff0004ff0008ff000cff0010ff0014ff0018ff001cff0020ff0024ff0028"
    "ff002cff0030ff0034ff0038ff003cff0040ff0044ff0048ff004cff0050ff00"
    "54ff0058ff005cff0060ff0064ff0068ff006cff0070ff0074ff0078ff007cff"
    "0080ff0084ff0088ff008cff0090ff0094ff0098ff009cff00a0ff00a4ff00a8"
    "ff00acff00b0ff00b4ff00b8ff00bcff00c0ff00c4ff00c8ff00ccff00d0ff00"
    "d4ff00d8ff00dcff00e0ff00e4ff00e8ff00ecff00f0ff00f4ff00f8ff00fcff"
    "02fffe06fffa0afff60efff212ffee16ffea1affe61effe222ffde26ffda2aff"
    "d62effd232ffce36ffca3affc63effc242ffbe46ffba4affb64effb252ffae56"
    "ffaa5affa65effa262ff9e66ff9a6aff966eff9272ff8e76ff8a7aff867eff82"
    "82ff7e86ff7a8aff768eff7292ff6e96ff6a9aff669eff62a2ff5ea6ff5aaaff"
    "56aeff52b2ff4eb6ff4abaff46beff42c2ff3ec6ff3acaff36ceff32d2ff2ed6"
    "ff2adaff26deff22e2ff1ee6ff1aeaff16eeff12f2ff0ef6ff0afaff06feff01"
    "fffc00fff800fff400fff000ffec00ffe800ffe400ffe000ffdc00ffd800ffd4"
    "00ffd000ffcc00ffc800ffc400ffc000ffbc00ffb800ffb400ffb000ffac00ff"
    "a800ffa400ffa000ff9c00ff9800ff9400ff9000ff8c00ff8800ff8400ff8000"
    "ff7c00ff7800ff7400ff7000ff6c00ff6800ff6400ff6000ff5c00ff5800ff54"
    "00ff5000ff4c00ff4800ff4400ff4000ff3c00ff3800ff3400ff3000ff2c00ff"
    "2800ff2400ff2000ff1c00ff1800ff1400ff1000ff0c00ff0800ff0400ff0000"
    "fc0000f80000f40000f00000ec0000e80000e40000e00000dc0000d80000d400"
    "00d00000cc0000c80000c40000c00000bc0000b80000b40000b00000ac0000a8"
    "0000a40000a000009c00009800009400009000008c0000880000840000800000"
)
JET_RGB = np.frombuffer(bytes.fromhex("".join(_JET_HEX)),
                        np.uint8).reshape(256, 3)

# Internal 16-joint skeleton (LIP order).
LIP_SKELETON = ((1, 0), (1, 2), (2, 3), (3, 4), (1, 5), (5, 6), (6, 7),
                (1, 14), (14, 15), (15, 8), (8, 9), (9, 10), (15, 11),
                (11, 12), (12, 13))

_XY_SHIFT = 16  # OpenCV's sub-pixel bits for polygons and thick lines
_XY_ONE = 1 << _XY_SHIFT


def add_weighted(src1: np.ndarray, alpha: float, src2: np.ndarray,
                 beta: float) -> np.ndarray:
    """``cv2.addWeighted(src1, alpha, src2, beta, 0)`` on uint8: per value
    fma(src1, f32(alpha), f32(src2 * f32(beta))) in float32, rounded half
    to even and saturated. The float64 sum below is exact for weights in
    [2^-20, 1], so its one rounding to float32 is the fused
    multiply-add's."""
    if src1.shape != src2.shape:
        raise ValueError(f"add_weighted: shapes {src1.shape} and "
                         f"{src2.shape} differ")
    a, b = np.float32(alpha), np.float32(beta)
    t = src2.astype(np.float32) * b
    v = (src1.astype(np.float64) * np.float64(a)
         + t.astype(np.float64)).astype(np.float32)
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


def overlay_parsing(image_rgb: np.ndarray, pred: np.ndarray,
                    alpha: float = 0.5, num_cls: int = 20) -> np.ndarray:
    """The parsing colours over the image, weighted ``1 - alpha`` and
    ``alpha``."""
    color = colorize_parsing(pred, num_cls)
    return add_weighted(image_rgb.astype(np.uint8), 1 - alpha, color, alpha)


def overlay_heatmap(image_rgb: np.ndarray, heatmap: np.ndarray,
                    alpha: float = 0.5) -> np.ndarray:
    """A heatmap in [0, 1] as a JET overlay: quantized to uint8
    (truncated), resized to the image with cv2's linear rule
    (``imgproc.resize_linear``), coloured by ``JET_RGB``."""
    hm = np.clip(heatmap, 0, 1)
    hm = (hm * 255).astype(np.uint8)
    hm = imgproc.resize_linear(hm, (image_rgb.shape[1], image_rgb.shape[0]))
    return add_weighted(image_rgb.astype(np.uint8), 1 - alpha, JET_RGB[hm],
                        alpha)


def _tdiv(a: int, b: int) -> int:
    """C's integer division, truncated toward zero."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """``cv::clipLine`` on a (w, h) box: the clipped end points, or None
    when the segment misses the box."""
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2, c2 = a, 0
    return None if c1 | c2 else (x1, y1, x2, y2)


def _put(img: np.ndarray, x: int, y: int, color) -> None:
    if 0 <= x < img.shape[1] and 0 <= y < img.shape[0]:
        img[y, x] = color


def _edge(img: np.ndarray, p0, p1, color) -> None:
    """OpenCV's 8-connected segment between sub-pixel points (``Line2``:
    coordinates with ``_XY_SHIFT`` fraction bits, clipped to the image)."""
    h, w = img.shape[:2]
    clipped = _clip_line(w << _XY_SHIFT, h << _XY_SHIFT, *p0, *p1)
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    half = _XY_ONE >> 1
    along_x = abs(dx) > abs(dy)
    if along_x:
        if dx < 0:  # run left to right
            dy, (x1, y1, x2, y2) = -dy, (x2, y2, x1, y1)
        x_step, y_step = _XY_ONE, _tdiv(dy << _XY_SHIFT, abs(dx) | 1)
        count = (x2 - x1) >> _XY_SHIFT
    else:
        if dy < 0:  # run top to bottom
            dx, (x1, y1, x2, y2) = -dx, (x2, y2, x1, y1)
        x_step, y_step = _tdiv(dx << _XY_SHIFT, abs(dy) | 1), _XY_ONE
        count = (y2 - y1) >> _XY_SHIFT
    x1 += half
    y1 += half
    _put(img, (x2 + half) >> _XY_SHIFT, (y2 + half) >> _XY_SHIFT, color)
    if along_x:
        x1 >>= _XY_SHIFT
        for _ in range(count + 1):
            _put(img, x1, y1 >> _XY_SHIFT, color)
            x1 += 1
            y1 += y_step
    else:
        y1 >>= _XY_SHIFT
        for _ in range(count + 1):
            _put(img, x1 >> _XY_SHIFT, y1, color)
            x1 += x_step
            y1 += 1


def _fill_convex_poly(img: np.ndarray, pts: list, color) -> None:
    """OpenCV's ``FillConvexPoly`` for 8-connected edges, the points with
    ``_XY_SHIFT`` fraction bits: the outline's segments, then one span a
    row between the two edges that bound it."""
    h, w = img.shape[:2]
    n, half = len(pts), _XY_ONE >> 1
    xs_all = [p[0] for p in pts]
    ys_all = [p[1] for p in pts]
    imin = ys_all.index(min(ys_all))
    prev = pts[-1]
    for p in pts:
        _edge(img, prev, p, color)
        prev = p
    xmin = (min(xs_all) + half) >> _XY_SHIFT
    xmax = (max(xs_all) + half) >> _XY_SHIFT
    ymin = (min(ys_all) + half) >> _XY_SHIFT
    ymax = (max(ys_all) + half) >> _XY_SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    # per edge: [index, step, x, dx, end row]
    edge = [[imin, 1, -_XY_ONE, 0, ymin], [imin, n - 1, -_XY_ONE, 0, ymin]]
    edges, y = n, ymin
    while True:
        for e in edge:
            if y < e[4]:
                continue
            idx0, di = e[0], e[1]
            idx = (idx0 + di) % n
            while True:
                more = edges > 0
                edges -= 1
                if not more:
                    break
                ty = (pts[idx][1] + half) >> _XY_SHIFT
                if ty > y:
                    xs, xe = pts[idx0][0], pts[idx][0]
                    e[4] = ty
                    e[3] = _tdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                    e[2], e[0] = xs, idx
                    break
                idx0, idx = idx, (idx + di) % n
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0][2] > edge[1][2] else (0, 1)
            x1 = (edge[left][2] + half) >> _XY_SHIFT
            x2 = (edge[right][2] + half) >> _XY_SHIFT
            if x2 >= 0 and x1 < w:
                img[y, max(x1, 0):min(x2, w - 1) + 1] = color
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break


def fill_circle(img: np.ndarray, center, radius: int, color) -> np.ndarray:
    """``cv2.circle(img, center, radius, color, -1)`` in place: OpenCV's
    midpoint circle, each octant pair filled by one span a row, clipped
    to the image."""
    h, w = img.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    radius = int(radius)
    if radius < 0:
        raise ValueError(f"fill_circle: radius {radius} < 0")
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for yy, xa, xb in ((cy - dy, cx - dx, cx + dx),
                           (cy + dy, cx - dx, cx + dx),
                           (cy - dx, cx - dy, cx + dy),
                           (cy + dx, cx - dy, cx + dy)):
            if 0 <= yy < h and xa < w and xb >= 0:
                img[yy, max(xa, 0):min(xb, w - 1) + 1] = color
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return img


def draw_line(img: np.ndarray, pt1, pt2, color,
              thickness: int = 2) -> np.ndarray:
    """``cv2.line(img, pt1, pt2, color, thickness)`` in place, 8-connected,
    for thickness 2 and more: the segment clipped to the image grown by
    ``thickness`` on each side (nothing drawn if it misses), then
    OpenCV's ``ThickLine``, a quadrilateral ``thickness / 2`` either side
    of it (``_fill_convex_poly``) and a filled circle at each end."""
    if thickness < 2:
        raise ValueError(f"draw_line draws thickness 2 and more, got "
                         f"{thickness}")
    t, (h, w) = thickness, img.shape[:2]
    clipped = _clip_line(w + 2 * t, h + 2 * t, int(pt1[0]) + t,
                         int(pt1[1]) + t, int(pt2[0]) + t, int(pt2[1]) + t)
    if clipped is None:
        return img
    x0, y0, x1, y1 = ((c - t) << _XY_SHIFT for c in clipped)
    dx, dy = (x0 - x1) / _XY_ONE, (y1 - y0) / _XY_ONE
    r = dx * dx + dy * dy
    half_width = thickness << (_XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (half_width + (thickness & 1) * _XY_ONE * 0.5) / math.sqrt(r)
        px, py = round(dy * r), round(dx * r)  # half to even, as cvRound
        _fill_convex_poly(img, [(x0 + px, y0 + py), (x0 - px, y0 - py),
                                (x1 - px, y1 - py), (x1 + px, y1 + py)],
                          color)
    radius = (half_width + (_XY_ONE >> 1)) >> _XY_SHIFT
    for x, y in ((x0, y0), (x1, y1)):
        fill_circle(img, ((x + (_XY_ONE >> 1)) >> _XY_SHIFT,
                          (y + (_XY_ONE >> 1)) >> _XY_SHIFT), radius, color)
    return img


def draw_skeleton(image_rgb: np.ndarray, joints: np.ndarray,
                  visibility=None, skeleton=LIP_SKELETON,
                  radius: int = 3) -> np.ndarray:
    """A copy of the image with the skeleton's visible limbs in green
    (thickness 2) and the visible joints as red discs; joints are rounded
    half to even."""
    out = image_rgb.astype(np.uint8).copy()
    vis = (np.ones(len(joints)) if visibility is None
           else np.asarray(visibility))
    for a, b in skeleton:
        if a < len(joints) and b < len(joints) and vis[a] and vis[b]:
            pa = tuple(np.round(joints[a]).astype(int))
            pb = tuple(np.round(joints[b]).astype(int))
            draw_line(out, pa, pb, (0, 255, 0), 2)
    for j, (x, y) in enumerate(joints):
        if vis[j]:
            fill_circle(out, (int(round(x)), int(round(y))), radius,
                        (255, 0, 0))
    return out


def save_debug_batch(images: np.ndarray, joints: np.ndarray, out_dir: str,
                     prefix: str = "debug", visibility=None,
                     mean=(0.485, 0.456, 0.406),
                     std=(0.229, 0.224, 0.225)) -> list[str]:
    """Each normalised (B, H, W, 3) image un-normalised, its skeleton drawn
    and saved as ``<out_dir>/<prefix>_<i>.png`` (RGB); returns the
    paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i in range(images.shape[0]):
        img = images[i] * np.asarray(std) + np.asarray(mean)
        img = np.clip(img * 255, 0, 255).astype(np.uint8)
        vis = None if visibility is None else visibility[i]
        drawn = draw_skeleton(img, joints[i], vis)
        path = os.path.join(out_dir, f"{prefix}_{i}.png")
        save_png(path, drawn)
        paths.append(path)
    return paths
