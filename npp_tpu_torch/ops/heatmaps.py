"""Gaussian pose-heatmap renderer: a hand-written CUDA kernel and its plain
PyTorch version.

Port of the Pallas TPU kernel ``npp_tpu/ops/pallas_kernels.py:25-90``
(``render_heatmaps_pallas``). Both functions here take joints (B, J, 2)
and visibility (B, J) and return the main (sigma) and aux (2 sigma)
heatmaps as NHWC (B, grid_y, grid_x, J+1) float32 tensors, as the Pallas
wrapper does.

``render_heatmaps`` chooses by the tensors' device: on a CUDA tensor it
launches the kernel of ``csrc/render_heatmaps.cu`` (built with ``nvcc``
for ``sm_90a`` at its first launch, into ``npp_tpu_torch/_build/``, and
called through ctypes) with the tiles and grid of ``launch_geometry``,
and a failed build or launch raises; on a CPU tensor it returns the
plain version, ``render_heatmaps_reference``.
Importing this module builds nothing.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

TRUNC = 4.6052  # exponent cut-off (npp_tpu/data/targets.py:25)

_CSRC = Path(__file__).resolve().parent / "csrc" / "render_heatmaps.cu"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")
_LIBRARY: dict = {}  # the loaded ctypes library, once built

# Launch geometry of the kernel (see launch_geometry).
THREADS = 256                # threads per block (kThreads in the source)
TILE_PIXELS = 128            # pixels per tile, at most; a multiple of 4
TILE_BUFFER_BYTES = 48 * 1024  # a block's four output tile buffers, at most
SMEM_BLOCK_LIMIT = 232_448   # shared memory one block may use on Hopper
SMEM_PER_SM = 233_472        # shared memory of one SM (228 KB)
SMEM_RESERVED = 1024         # shared memory CUDA reserves for each block
THREADS_PER_SM = 2048        # threads resident on one SM, at most


def render_heatmaps_reference(joints: torch.Tensor, visibility: torch.Tensor,
                              *, stride: int = 4, grid_x: int = 96,
                              grid_y: int = 96, sigma: float = 3.0):
    """Plain PyTorch version, as broadcasts in the op order of
    ``npp_tpu/data/targets.py:79-96``. The divisor 2 sigma^2 is a tensor
    on the joints' device: a Python-scalar divisor would let PyTorch's
    CUDA division multiply by its reciprocal instead, a different
    rounding from the kernel's true division."""
    joints = joints.to(torch.float32)
    visibility = visibility.to(torch.float32)
    dev = joints.device
    start = stride / 2.0 - 0.5
    xs = start + torch.arange(grid_x, dtype=torch.float32, device=dev) * stride
    ys = start + torch.arange(grid_y, dtype=torch.float32, device=dev) * stride

    def render(sig: float):
        dx2 = (xs[None, None, None, :] - joints[:, :, 0, None, None]) ** 2
        dy2 = (ys[None, None, :, None] - joints[:, :, 1, None, None]) ** 2
        two_sig2 = torch.tensor(2.0 * sig * sig, dtype=torch.float32,
                                device=dev)
        expo = (dx2 + dy2) / two_sig2
        m = torch.where(expo > TRUNC, 0.0, torch.exp(-expo))
        m = m * visibility[:, :, None, None]
        bg = 1.0 - m.amax(dim=1, keepdim=True)
        m = torch.cat([m, bg], dim=1)  # (B, J+1, H, W)
        return m.permute(0, 2, 3, 1).contiguous()  # NHWC

    return render(float(sigma)), render(2.0 * float(sigma))


@dataclasses.dataclass(frozen=True)
class LaunchGeometry:
    tile_pixels: int  # P: pixels per tile, a multiple of 4
    num_tiles: int    # ceil(B*gy*gx / P)
    span: int         # rows of the joint table: batch elements a tile spans
    grid: int         # persistent blocks
    smem_bytes: int   # dynamic shared memory per block
    tail_bytes: int   # bytes of the last tile, in each output


def launch_geometry(batch: int, num_joints: int, grid_y: int, grid_x: int,
                    num_sms: int) -> LaunchGeometry:
    """Tiles, grid and shared memory of one launch on a card with
    ``num_sms`` SMs. P starts at ``TILE_PIXELS`` and halves (staying a
    multiple of 4) until a block's two buffers of both outputs,
    4 * P * (J+1) floats, fit ``TILE_BUFFER_BYTES``. A tile spans at most
    (P-1) // (gy*gx) + 2 batch elements, whose joints it keeps. The grid
    is as many blocks as fit on the card at once (by threads and by
    shared memory), and no more than there are tiles. Raises ValueError
    if one block would need more shared memory than Hopper gives it."""
    nc = num_joints + 1
    p = TILE_PIXELS
    while p > 4 and 4 * p * nc * 4 > TILE_BUFFER_BYTES:
        p //= 2
    hw = grid_y * grid_x
    n_pix = batch * hw
    num_tiles = -(-n_pix // p)
    span = min(batch, (p - 1) // hw + 2)
    # four tile buffers, cx/cy/v of span*J joints, xs/ys/row of P pixels
    smem = 4 * (4 * p * nc + 3 * span * num_joints + 3 * p)
    if smem > SMEM_BLOCK_LIMIT:
        raise ValueError(f"render_heatmaps: J={num_joints} needs {smem} B of "
                         f"shared memory per block, over Hopper's "
                         f"{SMEM_BLOCK_LIMIT}")
    per_sm = min(THREADS_PER_SM // THREADS,
                 SMEM_PER_SM // (smem + SMEM_RESERVED))
    return LaunchGeometry(
        tile_pixels=p, num_tiles=num_tiles, span=span,
        grid=min(num_tiles, num_sms * per_sm), smem_bytes=smem,
        tail_bytes=(n_pix - (num_tiles - 1) * p) * nc * 4)


def cut_threshold(two_sig2: float) -> float:
    """The kernel's early-out bound on d2 for the divisor float(2 sigma^2):
    the least float32 at or above c+ * float(2 sigma^2), where c+ is the
    float32 after 4 * float32(TRUNC). A pair with d2 above it has
    RN(d2 / 2 sigma^2) >= c+, so both its exponent and the aux one (a
    quarter of it, exactly) are over the cut: the kernel renders 0 there
    without dividing."""
    c_up = np.nextafter(np.float32(4) * np.float32(TRUNC), np.float32(np.inf))
    t = float(c_up) * float(np.float32(two_sig2))  # exact in double
    t_f = np.float32(t)
    if float(t_f) < t:
        t_f = np.nextafter(t_f, np.float32(np.inf))
    return float(t_f)


def _nvcc(source: Path) -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(f"nvcc not found: the kernel is built from {source} "
                       f"with the CUDA toolkit's nvcc")


def nvcc_build(source: Path, stem: str) -> tuple[Path, str]:
    """Compile the CUDA ``source`` into a shared library under
    ``BUILD_DIR``, ``<stem>_<hash>.so`` (the hash of the source and flags,
    so an edit rebuilds). Returns (library path, compiler output; empty
    when the library was already built). Raises on a failed build."""
    src = source.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"{stem}_{tag[:16]}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(source), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def build_kernels() -> tuple[Path, str]:
    """``csrc/render_heatmaps.cu`` through ``nvcc_build``."""
    return nvcc_build(_CSRC, "librender_heatmaps")


def _library() -> ctypes.CDLL:
    if "lib" not in _LIBRARY:
        path, _ = build_kernels()
        lib = ctypes.CDLL(str(path))
        fn = lib.npp_render_heatmaps
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_float] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIBRARY["lib"] = lib
    return _LIBRARY["lib"]


def render_heatmaps(joints: torch.Tensor, visibility: torch.Tensor, *,
                    stride: int = 4, grid_x: int = 96, grid_y: int = 96,
                    sigma: float = 3.0):
    """(B, J, 2) joints + (B, J) visibility -> NHWC (B, grid_y, grid_x, J+1)
    main and aux heatmaps. CUDA tensors go to the kernel, CPU tensors to
    ``render_heatmaps_reference``; any other device raises."""
    if joints.device.type == "cpu" and visibility.device.type == "cpu":
        return render_heatmaps_reference(joints, visibility, stride=stride,
                                         grid_x=grid_x, grid_y=grid_y,
                                         sigma=sigma)
    if joints.device.type != "cuda" or visibility.device != joints.device:
        raise ValueError(f"render_heatmaps: joints on {joints.device} and "
                         f"visibility on {visibility.device}; both must be "
                         f"on the CPU or on one CUDA device")
    if joints.ndim != 3 or joints.shape[2] != 2:
        raise ValueError(f"joints must be (B, J, 2), got {tuple(joints.shape)}")
    b, j = joints.shape[:2]
    if tuple(visibility.shape) != (b, j):
        raise ValueError(f"visibility must be ({b}, {j}), got "
                         f"{tuple(visibility.shape)}")
    if min(j, grid_x, grid_y, stride) <= 0:
        raise ValueError("J, grid_x, grid_y and stride must be positive")
    if b * grid_y * grid_x >= 2**31:
        raise ValueError("render_heatmaps: B * grid_y * grid_x must be "
                         "under 2^31")
    joints = joints.to(torch.float32).contiguous()
    visibility = visibility.to(torch.float32).contiguous()
    main = torch.empty((b, grid_y, grid_x, j + 1), dtype=torch.float32,
                       device=joints.device)
    aux = torch.empty_like(main)
    if b == 0:
        return main, aux
    if main.data_ptr() % 16 or aux.data_ptr() % 16:
        raise RuntimeError("render_heatmaps: the kernel's bulk stores need "
                           "16-byte aligned outputs")
    sms = torch.cuda.get_device_properties(joints.device).multi_processor_count
    geo = launch_geometry(b, j, grid_y, grid_x, sms)
    # 2 sigma^2 in double, as the plain version's divisor; float32 in C
    two_sig2 = 2.0 * float(sigma) * float(sigma)
    lib = _library()
    with torch.cuda.device(joints.device):
        stream = torch.cuda.current_stream(joints.device).cuda_stream
        err = lib.npp_render_heatmaps(
            joints.data_ptr(), visibility.data_ptr(), main.data_ptr(),
            aux.data_ptr(), b, j, grid_y, grid_x, int(stride), two_sig2,
            cut_threshold(two_sig2), geo.tile_pixels,
            geo.num_tiles, geo.span, geo.grid, geo.smem_bytes,
            geo.tail_bytes, stream)
    if err != 0:
        raise RuntimeError(f"render_heatmaps kernel launch failed: "
                           f"cudaError_t {err}")
    count_launch(render_heatmaps)
    return main, aux


def count_launch(wrapper) -> None:
    """Count one call of ``wrapper`` that reached its kernel:
    ``wrapper.launches`` where the kernel ran, ``wrapper.captured`` where
    the current stream was being captured into a CUDA graph (the kernel
    then runs at each replay, which launches it without the wrapper and
    counts nothing)."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        wrapper.captured += 1
    else:
        wrapper.launches += 1


render_heatmaps.launches = 0  # kernel launches, read by chip_smoke.py
render_heatmaps.captured = 0  # calls recorded into CUDA graphs
