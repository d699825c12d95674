"""Read images and XML straight out of zip archives, without cv2.

Port of ``npp_tpu/utils/zipreader.py:17-49``: a path of the form
``/path/archive.zip@member/inner.jpg`` names a member of an archive,
read without extracting it, through one open handle per archive (a
process-wide cache).

``imread`` keeps ``cv2.imread``'s conventions, which npp_tpu's callers
rely on: flag 1 (``IMREAD_COLOR``) gives (H, W, 3) uint8 in BGR order,
flag 0 (``IMREAD_GRAYSCALE``) an (H, W) uint8 plane. JPEG members are
decoded by the host library (``data/imgproc.decode_jpeg``), PNG members
by ``utils/vis.decode_png``. What those readers refuse stays refused, by
a ``ValueError`` naming the member: progressive and other JPEGs the
decoder does not read, PNGs other than 8-bit grey, RGB, RGBA or
palette, and a colour file under flag 0 (cv2 would convert it to grey
by its own weights, which the port does not copy).
"""
from __future__ import annotations

import os
import threading
import xml.etree.ElementTree as ET
import zipfile

import numpy as np

from npp_tpu_torch.data import imgproc
from npp_tpu_torch.utils import vis

IMREAD_GRAYSCALE = 0
IMREAD_COLOR = 1

_cache: dict[str, zipfile.ZipFile] = {}
_LOCK = threading.Lock()


def split_zip_path(path: str) -> tuple[str, str]:
    """``archive.zip@member`` -> (archive path, member name)."""
    pos = path.index("@")
    return path[0:pos], path[pos + 1:]


def is_zip_path(path: str) -> bool:
    return ".zip@" in path


def _handle(zip_path: str) -> zipfile.ZipFile:
    key = os.path.abspath(zip_path)
    with _LOCK:
        if key not in _cache:
            _cache[key] = zipfile.ZipFile(zip_path, "r")
        return _cache[key]


def read_bytes(path: str) -> bytes:
    """The bytes of the member that ``path`` names."""
    zip_path, member = split_zip_path(path)
    return _handle(zip_path).read(member)


def _jpeg_components(data: bytes, path: str) -> int:
    """The component count of a JPEG's frame header (1 for grey)."""
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            break
        marker = data[pos + 1]
        if marker == 0xFF:  # fill byte
            pos += 1
            continue
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if pos + 9 < len(data):
                return data[pos + 9]
            break
        pos += 2 + length
    raise ValueError(f"{path}: no JPEG frame header")


def _decode(data: bytes, path: str, flags: int) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a JPEG or PNG, or (H, W) for a grey file
    under flag 0."""
    if data[:2] == b"\xff\xd8":
        rgb = imgproc.decode_jpeg(data, path)
        if flags == IMREAD_GRAYSCALE:
            if _jpeg_components(data, path) != 1:
                raise ValueError(f"{path}: a colour JPEG under flag 0; the "
                                 f"port reads grey files only as grey")
            return np.ascontiguousarray(rgb[..., 0])  # the plane, thrice
        return rgb
    pix, palette = vis.decode_png(data, path)
    if flags == IMREAD_GRAYSCALE:
        if pix.ndim != 2 or palette is not None:
            raise ValueError(f"{path}: a colour PNG under flag 0; the port "
                             f"reads grey files only as grey")
        return pix
    if palette is not None:
        return palette[pix]
    if pix.ndim == 2:
        return np.repeat(pix[..., None], 3, axis=2)
    return np.ascontiguousarray(pix[..., :3])


def imread(path: str, flags: int = IMREAD_COLOR) -> np.ndarray:
    """``cv2.imread`` of an ``archive.zip@member`` JPEG or PNG: (H, W, 3)
    uint8 BGR for flag 1, (H, W) uint8 for flag 0 (grey files only)."""
    if flags not in (IMREAD_COLOR, IMREAD_GRAYSCALE):
        raise ValueError(f"{path}: flags must be 1 (colour) or 0 (grey), "
                         f"got {flags}")
    img = _decode(read_bytes(path), path, flags)
    return img if img.ndim == 2 else np.ascontiguousarray(img[..., ::-1])


def xmlread(path: str) -> ET.Element:
    """The parsed XML member that ``path`` names."""
    return ET.fromstring(read_bytes(path).decode("utf-8"))
