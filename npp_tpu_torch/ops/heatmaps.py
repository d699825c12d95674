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
called through ctypes), and a failed build or launch raises; on a CPU
tensor it returns the plain version, ``render_heatmaps_reference``.
Importing this module builds nothing.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

TRUNC = 4.6052  # exponent cut-off (npp_tpu/data/targets.py:25)

_CSRC = Path(__file__).resolve().parent / "csrc" / "render_heatmaps.cu"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")
_LIBRARY: dict = {}  # the loaded ctypes library, once built


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


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the heatmap kernel is built from "
                       f"{_CSRC} with the CUDA toolkit's nvcc")


def build_kernels() -> tuple[Path, str]:
    """Compile ``csrc/render_heatmaps.cu`` into a shared library under
    ``BUILD_DIR`` (named by a hash of the source and flags, so an edit
    rebuilds). Returns (library path, compiler output; empty when the
    library was already built). Raises on a failed build."""
    src = _CSRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"librender_heatmaps_{tag[:16]}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def _library() -> ctypes.CDLL:
    if "lib" not in _LIBRARY:
        path, _ = build_kernels()
        lib = ctypes.CDLL(str(path))
        fn = lib.npp_render_heatmaps
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p]
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
    if min(grid_x, grid_y, stride) <= 0:
        raise ValueError("grid_x, grid_y and stride must be positive")
    joints = joints.to(torch.float32).contiguous()
    visibility = visibility.to(torch.float32).contiguous()
    main = torch.empty((b, grid_y, grid_x, j + 1), dtype=torch.float32,
                       device=joints.device)
    aux = torch.empty_like(main)
    if b == 0:
        return main, aux
    lib = _library()
    with torch.cuda.device(joints.device):
        stream = torch.cuda.current_stream(joints.device).cuda_stream
        err = lib.npp_render_heatmaps(
            joints.data_ptr(), visibility.data_ptr(), main.data_ptr(),
            aux.data_ptr(), b, j, grid_y, grid_x, int(stride), float(sigma),
            stream)
    if err != 0:
        raise RuntimeError(f"render_heatmaps kernel launch failed: "
                           f"cudaError_t {err}")
    render_heatmaps.launches += 1
    return main, aux


render_heatmaps.launches = 0  # kernel launches, read by chip_smoke.py
