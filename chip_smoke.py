"""On-card smoke run of the PyTorch port (npp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernel from the sources in this
checkout, checks it against its plain PyTorch version on the card, then
drives the flagship NPPNet flip-TTA evaluation (L=16, C=64, 384x384,
random weights from a seed, 16 synthetic images at batch 8) through the
port's loader -> heatmap kernel -> eval step -> validate, in fp32 and in
bf16 + channels_last. Any failure raises, so the exit code is non-zero;
without CUDA it exits non-zero before printing any result.

Phases: 1 device, 2 build, 3 kernel vs plain version (two shapes),
4 the slice in fp32, 5 the slice in bf16 + channels_last (timed).
Output: one line per phase, then a JSON line of the kernels, the
``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

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

KERNEL_SHAPES = (  # (B, J, gy, gx, sigma): the slice's, then a ragged one
    (8, 16, 96, 96, 3.0),
    (3, 14, 96, 72, 2.0),
)
KERNEL_ATOL = 1e-6  # the kernel and its plain version round alike
BF16_RTOL = 2e-2    # bf16 vs fp32 eval loss
N_IMAGES, BATCH, SEED = 16, 8, 0


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_median_ms(fn, runs: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def check_kernel(tag: str) -> dict:
    """Phase 3: kernel vs plain version at the slice's and a ragged shape;
    timed at the slice's shape."""
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
            k_ms = cuda_median_ms(
                lambda: heatmaps.render_heatmaps(joints, vis, **kw))
            p_ms = cuda_median_ms(
                lambda: heatmaps.render_heatmaps_reference(joints, vis, **kw))
            timed = (k_ms, p_ms)
            print(f"phase 3: median of 50 at B={b} J={j} {gy}x{gx}: "
                  f"kernel {k_ms:.4f} ms, plain version {p_ms:.4f} ms {tag}")
    return {"max_abs_err": worst, "ms": timed[0], "plain_ms": timed[1]}


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
