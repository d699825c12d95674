"""Parsing palettes and PNG files without PIL or cv2.

Port of ``npp_tpu/utils/vis.py:17-50``: the PASCAL-style palette, label
colouring and the indexed parsing PNG. The PNG is written with the
standard library (``zlib`` + ``struct``): 8-bit colour type 3 with a
``PLTE`` chunk of the palette. ``read_png`` reads the PNGs the port and
common encoders write (8-bit grey, RGB, RGBA or palette, not
interlaced, any of the five row filters); ``read_image`` feeds the
serving CLI and the LIP reader from ``.jpg`` / ``.jpeg`` (the host JPEG
decoder, ``data/imgproc.py``), ``.png`` or ``.npy`` files. The cv2
drawing helpers (overlays, skeletons, debug grids) are not ported.
"""
from __future__ import annotations

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
    """Read an 8-bit, non-interlaced PNG. Returns (pixels, palette): the
    pixels (H, W) for grey or palette images, else (H, W, C) with C = 3
    or 4; the palette (N, 3) uint8 for colour type 3, else None."""
    with open(path, "rb") as f:
        blob = f.read()
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
