"""The LIP reader's host image library: JPEG decoding, resize by a factor
and affine warps, with OpenCV's rules and without cv2.

Binds ``csrc/imgproc.cpp`` through ctypes. The library is built with the
host C++ compiler (``g++``, else ``c++``, from ``PATH``) at its first use,
into ``npp_tpu_torch/_build/`` under a name that carries a hash of the
source, the compiler and the flags; importing this module builds nothing,
and a failed build raises. ctypes releases the GIL for each call, so the
loader's threads decode and warp in parallel.

- ``decode_jpeg`` / ``read_jpeg``: baseline and extended sequential
  Huffman JPEGs, 8-bit, grey or YCbCr, any integral sampling, restart
  intervals -> (H, W, 3) uint8 RGB, the array ``cv2.imread(p, 1)`` and a
  BGR -> RGB swap give (libjpeg's ``islow`` IDCT, fancy upsampling and
  YCbCr tables). A grey file gives its plane three times. Progressive,
  lossless, hierarchical and arithmetic-coded files, 12-bit samples,
  CMYK / four-component and RGB-coded files, and an EXIF orientation of
  2-8 (which cv2 would apply) raise ``ValueError`` naming the file.
- ``resize``: ``cv2.resize(im, None, fx=s, fy=s, ...)``: cubic for
  (H, W, 3) uint8, nearest for (H, W) uint8.
- ``warp_affine``: ``cv2.warpAffine(im, m, (w, h), flags,
  BORDER_CONSTANT, border)``: cubic for (H, W, 3) uint8, nearest for
  (H, W) uint8, by OpenCV 5's coordinate rule (see the C source).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_CSRC = Path(__file__).resolve().parent / "csrc" / "imgproc.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# No -ffast-math: the warps' float32 rounding is part of their contract.
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off")
_LIBRARY: dict = {}  # the loaded ctypes library, once built
_LOCK = threading.Lock()
_ERRLEN = 512

_u8p = ctypes.POINTER(ctypes.c_uint8)


def _cxx() -> str:
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler (g++ or c++) on PATH: the LIP "
                       f"reader's host library is built from {_CSRC}")


def build_library() -> tuple[Path, str]:
    """Compile ``csrc/imgproc.cpp`` into a shared library under
    ``BUILD_DIR`` (named by a hash of the source, the compiler and the
    flags, so an edit rebuilds). Returns (library path, compiler output;
    empty when the library was already built). Raises on a failed
    build."""
    cxx = _cxx()
    src = _CSRC.read_bytes()
    tag = hashlib.sha256(src + " ".join((cxx, *CXX_FLAGS)).encode()
                         ).hexdigest()
    out = BUILD_DIR / f"libimgproc_{tag[:16]}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}"
                        ".tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(_CSRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def _library() -> ctypes.CDLL:
    with _LOCK:
        if "lib" not in _LIBRARY:
            path, _ = build_library()
            lib = ctypes.CDLL(str(path))
            err = [ctypes.c_char_p, ctypes.c_int]
            lib.npp_jpeg_info.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                *err]
            lib.npp_jpeg_info.restype = ctypes.c_int
            lib.npp_jpeg_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, _u8p, ctypes.c_int,
                ctypes.c_int, *err]
            lib.npp_jpeg_decode.restype = ctypes.c_int
            resize = [_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _u8p,
                      ctypes.c_int, ctypes.c_int, ctypes.c_double,
                      ctypes.c_double]
            for fn in (lib.npp_resize_cubic_u8, lib.npp_resize_nearest_u8):
                fn.argtypes = resize
                fn.restype = None
            lib.npp_warp_affine_u8.argtypes = [
                _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _u8p,
                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_double),
                ctypes.c_int, ctypes.c_int]
            lib.npp_warp_affine_u8.restype = ctypes.c_int
            _LIBRARY["lib"] = lib
        return _LIBRARY["lib"]


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_u8p)


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 RGB; ``ValueError`` naming ``name``
    and the cause for a file this decoder does not read."""
    lib = _library()
    err = ctypes.create_string_buffer(_ERRLEN)
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.npp_jpeg_info(data, len(data), ctypes.byref(h), ctypes.byref(w),
                         err, _ERRLEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.npp_jpeg_decode(data, len(data), _ptr(out), h.value, w.value,
                           err, _ERRLEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    return out


def read_jpeg(path: str) -> np.ndarray:
    """``decode_jpeg`` of the file at ``path``."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), str(path))


def _check(im: np.ndarray, interpolation: str) -> tuple[np.ndarray, int]:
    """The contiguous image and its channel count, or ValueError: cubic
    takes (H, W, 3) uint8, nearest (H, W) uint8."""
    want = {"cubic": 3, "nearest": 2}
    if interpolation not in want:
        raise ValueError(f"interpolation must be 'cubic' or 'nearest', got "
                         f"{interpolation!r}")
    if im.dtype != np.uint8 or im.ndim != want[interpolation] or (
            im.ndim == 3 and im.shape[2] != 3) or min(im.shape[:2]) < 1:
        shape = "(H, W, 3)" if interpolation == "cubic" else "(H, W)"
        raise ValueError(f"{interpolation} takes {shape} uint8, got "
                         f"{im.dtype} {im.shape}")
    return np.ascontiguousarray(im), (3 if im.ndim == 3 else 1)


def resize(im: np.ndarray, scale: float, interpolation: str) -> np.ndarray:
    """``cv2.resize(im, None, fx=scale, fy=scale, interpolation=...)``:
    the output is round(H * scale) x round(W * scale) (half to even);
    'cubic' (3-channel) samples at (d + 0.5) / scale - 0.5 with cv2's
    float32 taps, clamped to the border, within one grey level of cv2;
    'nearest' (1-channel) takes floor(d * (1 / scale)), exactly."""
    src, cn = _check(im, interpolation)
    h, w = src.shape[:2]
    scale = float(scale)
    oh, ow = round(h * scale), round(w * scale)
    if oh < 1 or ow < 1:
        raise ValueError(f"scale {scale} of {h}x{w} gives an empty image")
    out = np.empty((oh, ow) + src.shape[2:], np.uint8)
    fn = (_library().npp_resize_cubic_u8 if interpolation == "cubic"
          else _library().npp_resize_nearest_u8)
    fn(_ptr(src), h, w, cn, _ptr(out), oh, ow, scale, scale)
    return out


def warp_affine(im: np.ndarray, m: np.ndarray, dsize: tuple[int, int],
                interpolation: str, border: int) -> np.ndarray:
    """``cv2.warpAffine(im, m, dsize=(w, h), flags=INTER_CUBIC or
    INTER_NEAREST, borderMode=BORDER_CONSTANT, borderValue=border)`` for
    the 2x3 forward matrix ``m``: 'nearest' (1-channel) equal to OpenCV
    5's, 'cubic' (3-channel) within one grey level of it."""
    src, cn = _check(im, interpolation)
    ow, oh = int(dsize[0]), int(dsize[1])
    if ow < 1 or oh < 1:
        raise ValueError(f"empty output size {dsize}")
    mat = np.ascontiguousarray(np.asarray(m, np.float64).reshape(6))
    out = np.empty((oh, ow) + src.shape[2:], np.uint8)
    if _library().npp_warp_affine_u8(
            _ptr(src), src.shape[0], src.shape[1], cn, _ptr(out), oh, ow,
            mat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            int(interpolation == "cubic"), int(border)):
        raise ValueError(f"the cubic warp takes 3 channels, not {cn}")
    return out
