"""The readers' host image library: JPEG decoding, resize by a factor
and affine warps, with OpenCV's rules and without cv2.

Binds ``csrc/imgproc.cpp`` through ctypes. The library is built with the
host C++ compiler (``g++``, else ``c++``, from ``PATH``) at its first use,
into ``npp_tpu_torch/_build/`` under a name that carries a hash of the
sources, the compiler, the flags and the host's name (``-march=native``
ties a build to its machine); importing this module builds nothing, and a failed build raises. The same library holds the
``--fast-aug`` fused warp (``csrc/fused_augment.cpp``, bound by
``data/fast_aug.py``), compiled with flags of its own (``SOURCES``).
ctypes releases the GIL for each call, so the loader's threads decode
and warp in parallel.

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
  (H, W) uint8, linear for either, by OpenCV 5's coordinate rule (see
  the C source).
- ``resize_linear``: ``cv2.resize(plane, (w, h))`` (``INTER_LINEAR``)
  for an (H, W) uint8 plane, in numpy, exactly.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# (source, compile flags). No -ffast-math in either: the warps' float32
# rounding is part of their contract. imgproc.cpp follows OpenCV 5's
# rule, so it forbids FMA contraction; fused_augment.cpp rounds as
# npp_tpu's native/Makefile builds it (-O3 -march=native, GCC's default
# contraction), so that one seed gives npp_tpu's fused-warp samples.
SOURCES = (
    (_CSRC_DIR / "imgproc.cpp",
     ("-O2", "-std=c++17", "-fPIC", "-ffp-contract=off")),
    (_CSRC_DIR / "fused_augment.cpp",
     ("-O3", "-march=native", "-std=c++17", "-fPIC")),
)
_LIBRARY: dict = {}  # the loaded ctypes library, once built
_LOCK = threading.Lock()
_ERRLEN = 512

_u8p = ctypes.POINTER(ctypes.c_uint8)


def _cxx() -> str:
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler (g++ or c++) on PATH: the readers' "
                       f"host library is built from {_CSRC_DIR}")


def _run(cmd: list) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def build_library() -> tuple[Path, str]:
    """Compile each source of ``SOURCES`` with its flags and link them
    into one shared library under ``BUILD_DIR`` (named by a hash of the
    sources, the compiler, the flags and the host's name, so an edit or
    another machine rebuilds). Returns
    (library path, compiler output; empty when the library was already
    built). Raises on a failed build."""
    cxx = _cxx()
    key = hashlib.sha256(f"{cxx} {platform.node()}".encode())
    for src, flags in SOURCES:
        key.update(src.read_bytes() + " ".join(flags).encode())
    out = BUILD_DIR / f"libimgproc_{key.hexdigest()[:16]}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"{out.name}.{os.getpid()}.{threading.get_ident()}"
    objs, log = [], ""
    try:
        for src, flags in SOURCES:
            obj = out.with_name(f"{stem}.{src.stem}.o")
            objs.append(obj)
            log += _run([cxx, *flags, "-c", "-o", str(obj), str(src)])
        tmp = out.with_name(f"{stem}.tmp")
        log += _run([cxx, "-shared", "-o", str(tmp), *map(str, objs)])
        os.replace(tmp, out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out, log


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
            # the fused warp (data/fast_aug.py)
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            geometry = [p, p, i, i, f, f, f, f, i, i, i]
            lib.npp_fused_augment.argtypes = geometry + [p, p, p, p, p]
            lib.npp_fused_augment_u8.argtypes = geometry + [p, p, p]
            lib.npp_transform_joints.argtypes = [p, i, i, i, f, f, f, f, i,
                                                 i]
            for fn in (lib.npp_fused_augment, lib.npp_fused_augment_u8,
                       lib.npp_transform_joints):
                fn.restype = None
            lib.npp_native_version.restype = i
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


_SHAPES = {"cubic": ((3,), "(H, W, 3)"), "nearest": ((2,), "(H, W)"),
           "linear": ((2, 3), "(H, W) or (H, W, 3)")}


def _check(im: np.ndarray, interpolation: str,
           allowed=("cubic", "nearest")) -> tuple[np.ndarray, int]:
    """The contiguous image and its channel count, or ValueError: cubic
    takes (H, W, 3) uint8, nearest (H, W) uint8, linear either."""
    if interpolation not in allowed:
        raise ValueError(f"interpolation must be one of {allowed}, got "
                         f"{interpolation!r}")
    ndims, shape = _SHAPES[interpolation]
    if im.dtype != np.uint8 or im.ndim not in ndims or (
            im.ndim == 3 and im.shape[2] != 3) or min(im.shape[:2]) < 1:
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


_INTERP = {"nearest": 0, "cubic": 1, "linear": 2}


def warp_affine(im: np.ndarray, m: np.ndarray, dsize: tuple[int, int],
                interpolation: str, border: int) -> np.ndarray:
    """``cv2.warpAffine(im, m, dsize=(w, h), flags=INTER_CUBIC,
    INTER_NEAREST or INTER_LINEAR, borderMode=BORDER_CONSTANT,
    borderValue=border)`` for the 2x3 forward matrix ``m``: 'nearest'
    (1-channel) and 'linear' (1- or 3-channel) equal to OpenCV 5's,
    'cubic' (3-channel) within one grey level of it."""
    src, cn = _check(im, interpolation, tuple(_INTERP))
    ow, oh = int(dsize[0]), int(dsize[1])
    if ow < 1 or oh < 1:
        raise ValueError(f"empty output size {dsize}")
    mat = np.ascontiguousarray(np.asarray(m, np.float64).reshape(6))
    out = np.empty((oh, ow) + src.shape[2:], np.uint8)
    if _library().npp_warp_affine_u8(
            _ptr(src), src.shape[0], src.shape[1], cn, _ptr(out), oh, ow,
            mat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            _INTERP[interpolation], int(border)):
        raise ValueError(f"the cubic warp takes 3 channels, not {cn}")
    return out


def _linear_taps(n_in: int, n_out: int, clamp: bool):
    """Source index and 11-bit weights (1 - f, f) of each output index:
    f32((d + 0.5) * (1 / (n_out / n_in)) - 0.5), split at its floor. The
    horizontal taps are clamped to the edge pixel with f = 0; the
    vertical ones are not (their rows are, when read)."""
    pos = ((np.arange(n_out) + 0.5) * (1.0 / (n_out / n_in)) - 0.5
           ).astype(np.float32)
    idx = np.floor(pos).astype(np.int64)
    frac = (pos - idx).astype(np.float32)
    if clamp:
        low, high = idx < 0, idx >= n_in - 1
        frac[low | high] = 0
        idx[low], idx[high] = 0, n_in - 1
    return (idx, np.rint((1 - frac) * 2048).astype(np.int64),
            np.rint(frac * 2048).astype(np.int64))


def resize_linear(plane: np.ndarray, dsize: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(plane, dsize=(w, h), interpolation=INTER_LINEAR)`` for
    an (H, W) uint8 plane, exactly (OpenCV's fixed-point rule): each row
    is blended along x in integers with 11-bit weights, then each output
    value is sum((row >> 4) * weight >> 16) over its two rows, plus 2,
    shifted right by 2 and saturated."""
    if plane.dtype != np.uint8 or plane.ndim != 2 or min(plane.shape) < 1:
        raise ValueError(f"resize_linear takes an (H, W) uint8 plane, got "
                         f"{plane.dtype} {plane.shape}")
    ow, oh = int(dsize[0]), int(dsize[1])
    if ow < 1 or oh < 1:
        raise ValueError(f"empty output size {dsize}")
    h, w = plane.shape
    sx, ax0, ax1 = _linear_taps(w, ow, clamp=True)
    sy, ay0, ay1 = _linear_taps(h, oh, clamp=False)
    src = plane.astype(np.int64)
    rows = src[:, sx] * ax0 + src[:, np.minimum(sx + 1, w - 1)] * ax1
    r0 = rows[np.clip(sy, 0, h - 1)] >> 4
    r1 = rows[np.clip(sy + 1, 0, h - 1)] >> 4
    v = ((r0 * ay0[:, None]) >> 16) + ((r1 * ay1[:, None]) >> 16)
    return np.clip((v + 2) >> 2, 0, 255).astype(np.uint8)
