"""On-card smoke run of the PyTorch port (npp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernel from the sources in this
checkout, checks it against its plain PyTorch version on the card, then
drives the flagship NPPNet flip-TTA evaluation (L=16, C=64, 384x384,
random weights from a seed, 16 synthetic images at batch 8) through the
port's loader -> heatmap kernel -> eval step -> validate, in fp32 and in
bf16 + channels_last. Any failure raises, so the exit code is non-zero;
without CUDA it exits non-zero before printing any result.

Phases: 1 device, 2 build, 3 kernel vs plain version (four shapes) and
the device time of both by many launches, beside the kernel's bound,
4 the slice in fp32, 5 the slice in bf16 + channels_last (timed).
Output: one line per phase, then a JSON line of the kernels, the
``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from npp_tpu_torch.data.synthetic import SyntheticDataset
from npp_tpu_torch.models.augment import build_nppnet
from npp_tpu_torch.ops import heatmaps
from npp_tpu_torch.tools import eval_lip

KERNEL_SHAPES = (  # (B, J, gy, gx, sigma); the first is timed
    (8, 16, 96, 96, 3.0),    # the eval slice's
    (3, 14, 96, 72, 2.0),    # a ragged one
    (1, 13, 25, 23, 2.5),    # its last tile holds 3,528 B, not a multiple of 16
    (16, 16, 96, 96, 3.0),   # the train slice's
)
KERNEL_ATOL = 1e-6  # the kernel and its plain version round alike
BF16_RTOL = 2e-2    # bf16 vs fp32 eval loss
N_IMAGES, BATCH, SEED = 16, 8, 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA's data sheet)
FP32_OPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
TIMED_CALLS = 200          # calls per timed run
COLD_RING = 8              # calls whose outputs stay referenced: 8 x 10 MB > 50 MB L2
TIMING = (f"CUDA events around {TIMED_CALLS} calls queued behind a "
          f"torch.cuda._sleep, over the count; the outputs of the last "
          f"{COLD_RING} calls kept referenced (cold L2)")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_us(fn) -> tuple[float, bool]:
    """Device time of one call of ``fn``, in us: a sleep kernel holds the
    stream while the host queues ``TIMED_CALLS`` calls behind it, and CUDA
    events around those calls give their time over the count. The outputs
    of the last ``COLD_RING`` calls stay referenced, so the caching
    allocator hands each call memory that is not hot in the L2. Also
    returns whether every call was queued before the device reached the
    first: a call that synchronises the host cannot be, and then the time
    holds host time too."""
    ring = collections.deque(maxlen=COLD_RING)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_CALLS):  # warm-up, and the host's enqueue time
        ring.append(fn())
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4e9 * host_s) + 10**6)  # > 2x that at <= 2 GHz
    start.record()
    for _ in range(TIMED_CALLS):
        ring.append(fn())
    end.record()
    queued = not start.query()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / TIMED_CALLS, queued


def bound_us(b: int, j: int, gy: int, gx: int) -> tuple[float, str]:
    """The least time the card could take to render one batch: the bytes
    (inputs read once, two outputs written once) over the memory rate,
    or the float32 operations over their peak rate, whichever is longer.
    Per (pixel, joint, sigma): 2 sub, 2 mul, add, div, exp, mul by the
    visibility and the max; per (pixel, sigma) the background's sub."""
    nbytes = 4 * (b * j * 3 + 2 * b * gy * gx * (j + 1))
    ops = 2 * b * gy * gx * (9 * j + 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e6
    t_ops = ops / FP32_OPS_PER_S * 1e6
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profiled_kernel_us(fn, calls: int = 20):
    """Device time per launch that ``torch.profiler`` lists for the
    kernel, or None if its ``key_averages()`` has no row for it."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if "render_heatmaps_kernel" in e.key]
    if not rows:
        return None
    total = sum(getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0) for e in rows)
    return total / sum(e.count for e in rows)


def check_kernel(tag: str) -> dict:
    """Phase 3: kernel vs plain version at every shape of KERNEL_SHAPES;
    device time of both, and the bound, at the first."""
    rng = np.random.default_rng(SEED)
    worst, timed = 0.0, None
    for b, j, gy, gx, sigma in KERNEL_SHAPES:
        joints = torch.tensor(rng.uniform(-20, 404, (b, j, 2)),
                              dtype=torch.float32, device="cuda")
        vis = torch.tensor(rng.random((b, j)) > 0.1, dtype=torch.float32,
                           device="cuda")
        kw = dict(stride=4, grid_x=gx, grid_y=gy, sigma=sigma)
        km, ka = heatmaps.render_heatmaps(joints, vis, **kw)
        pm, pa = heatmaps.render_heatmaps_reference(joints, vis, **kw)
        torch.cuda.synchronize()
        assert km.shape == pm.shape == (b, gy, gx, j + 1), km.shape
        err_m = (km - pm).abs().max().item()
        err_a = (ka - pa).abs().max().item()
        print(f"phase 3: kernel vs plain B={b} J={j} {gy}x{gx} sigma={sigma}: "
              f"max|diff| main={err_m:.3g} aux={err_a:.3g} "
              f"(atol {KERNEL_ATOL}) {tag}")
        if not (err_m <= KERNEL_ATOL and err_a <= KERNEL_ATOL):
            raise AssertionError("heatmap kernel disagrees with its plain "
                                 "version")
        worst = max(worst, err_m, err_a)
        if timed is None:
            kernel = lambda: heatmaps.render_heatmaps(joints, vis, **kw)
            plain = lambda: heatmaps.render_heatmaps_reference(joints, vis,
                                                               **kw)
            k_us, k_queued = device_us(kernel)
            p_us, p_queued = device_us(plain)
            if not k_queued:
                raise AssertionError("the timed kernel calls were not all "
                                     "queued behind the sleep")
            b_us, b_by = bound_us(b, j, gy, gx)
            prof_us = profiled_kernel_us(kernel)
            # Yardsticks by the same method: an empty launch, and a fill
            # of as many bytes as the kernel writes.
            empty_us, _ = device_us(lambda: torch.cuda._sleep(0))
            fill_us, _ = device_us(lambda: torch.zeros(
                2 * b * gy * gx * (j + 1), device="cuda"))
            timed = dict(device_us=k_us, plain_us=p_us, bound_us=b_us,
                         bound_by=b_by, share_of_bound=b_us / k_us,
                         plain_queued=p_queued, profiler_us=prof_us,
                         empty_launch_us=empty_us, fill_us=fill_us)
            print(f"phase 3: device time at B={b} J={j} {gy}x{gx}: kernel "
                  f"{k_us:.4f} us, plain version {p_us:.4f} us"
                  f"{'' if p_queued else ' (it synchronises: host time included)'}"
                  f"; bound {b_us:.4f} us ({b_by}); kernel at "
                  f"{b_us / k_us:.4f} of the bound; an empty launch "
                  f"{empty_us:.4f} us, a fill of the same bytes "
                  f"{fill_us:.4f} us; torch.profiler lists "
                  + ("no row for the kernel" if prof_us is None else
                     f"the kernel at {prof_us:.4f} us per launch")
                  + f" {tag}")
    return {"max_abs_err": worst, "ms": timed["device_us"] / 1e3,
            "plain_ms": timed["plain_us"] / 1e3,
            "bound_ms": timed["bound_us"] / 1e3, **timed,
            "timing": TIMING, "library_ms": None, "library": "none"}


def valid_pixels() -> int:
    ds = SyntheticDataset(length=N_IMAGES, crop_size=(384, 384),
                          num_joints=eval_lip.NUM_JOINTS,
                          num_classes=eval_lip.NUM_CLASSES, seed=SEED,
                          device_normalize=True)
    return int(sum((ds[i]["par"] != eval_lip.IGNORE).sum()
                   for i in range(N_IMAGES)))


def run_slice(model) -> dict:
    return eval_lip.evaluate_synthetic(
        model, n=N_IMAGES, batch=BATCH, crop_size=(384, 384), device="cuda",
        seed=SEED)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    # Phase 1: device.
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi()
    tag = f"[{smi}]"
    print(f"phase 1: {name}, compute capability {cap[0]}.{cap[1]}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"nvidia-smi: {smi}")

    # Phase 2: build the kernel from this checkout's sources.
    t0 = time.perf_counter()
    lib, log = heatmaps.build_kernels()
    print(f"phase 2: built {lib.name} in {time.perf_counter() - t0:.2f} s")
    for line in log.strip().splitlines():
        if "registers" in line or "spill" in line:
            print(f"phase 2: ptxas: {line.strip()}")

    # Phase 3: the kernel against its plain version on the card.
    kernel = check_kernel(tag)

    # Phase 4: the slice in fp32 (TF32 off: cuDNN would use it for fp32
    # convs by default).
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_nppnet(device="cuda", generator=torch.Generator()
                         .manual_seed(SEED), dtype=torch.float32,
                         **eval_lip.FLAGSHIP)
    model = model.to(memory_format=torch.channels_last)
    heatmaps.render_heatmaps.launches = 0
    res32 = run_slice(model)
    cm = res32["cm"]
    assert math.isfinite(res32["loss"]), res32["loss"]
    assert res32["pose_preds"].shape == (N_IMAGES, 16, 3), \
        res32["pose_preds"].shape
    assert np.isfinite(res32["pose_preds"]).all()
    assert cm.shape == (20, 20), cm.shape
    n_valid = valid_pixels()
    assert int(cm.sum()) == n_valid, (int(cm.sum()), n_valid)
    print(f"phase 4: fp32 flagship eval {eval_lip.result_line(res32)} "
          f"cm.sum={int(cm.sum())} == valid pixels {n_valid} {tag}")

    # Phase 5: bf16 + channels_last, same weights and data; then a timed
    # warm pass.
    model.dtype = torch.bfloat16
    torch.cuda.reset_peak_memory_stats()
    res16 = run_slice(model)
    rel = abs(res16["loss"] - res32["loss"]) / abs(res32["loss"])
    print(f"phase 5: bf16 flagship eval {eval_lip.result_line(res16)}; "
          f"|loss - fp32 loss| / fp32 loss = {rel:.3g} (<= {BF16_RTOL}) {tag}")
    if not rel <= BF16_RTOL:
        raise AssertionError(f"bf16 loss {res16['loss']} vs fp32 "
                             f"{res32['loss']}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_slice(model)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = heatmaps.render_heatmaps.launches
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 5: warm pass {N_IMAGES} images in {dt:.4f} s = "
          f"{N_IMAGES / dt:.2f} img/s (bf16, bs{BATCH}, flip-TTA, loader "
          f"and decode included); peak memory {peak / 2**30:.3f} GiB {tag}")
    if launches == 0:
        raise AssertionError("the main path never launched the heatmap "
                             "kernel")

    print(json.dumps({"kernels": [{
        "name": "render_heatmaps", "route": "cuda",
        "source": "npp_tpu_torch/ops/csrc/render_heatmaps.cu",
        "replaces": "npp_tpu/ops/pallas_kernels.py:71",
        "launches": launches, **kernel}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
