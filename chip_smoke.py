"""On-card smoke run of the PyTorch port (npp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernel from the sources in this
checkout, checks it against its plain PyTorch version on the card, then
drives the port's three paths with random weights from a seed on
synthetic data: at the flagship's width (L=16, C=64, 384x384) the NPPNet
flip-TTA evaluation (16 images at batch 8, loader -> heatmap kernel ->
eval step -> validate, in fp32 and in bf16 + channels_last) and the
augment-phase training (batch 16, bf16 + channels_last: loader ->
heatmap kernel -> forward, dual-task loss, backward, Adam -> train_epoch
-> validate -> checkpoint save and restore, then the train CLI itself);
at the reference search scale (L=16, C=32, 384x384, batch 7, bf16 +
channels_last) the bi-level interaction search (loaders -> heatmap
kernel -> supernet weight and arch steps -> train_epoch warmup and
search_epoch -> genotype -> a fixed NPPNet built from it -> checkpoint
save and restore, then the search CLI itself). Any failure raises, so
the exit code is non-zero; without CUDA it exits non-zero before
printing any result.

Phases: 1 device, 2 build, 3 kernel vs plain version (five shapes) and
the device time of both by many launches, beside the kernel's bound, at
the eval, the train and the search shapes, 4 the eval slice in fp32, 5
the eval slice in bf16 + channels_last (timed), 6 the tiny train step on
the card against the CPU in fp32, 7 the flagship train slice in bf16 +
channels_last (checked, timed, profiled), 8 a tiny search pair (weight
step, arch step) on the card against the CPU in fp32, 9 the search slice
at the reference scale in bf16 + channels_last (checked, timed,
profiled).
Output: one line per phase, then a JSON line of the kernels, the
``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import copy
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from npp_tpu_torch import engine
from npp_tpu_torch.core import checkpoint
from npp_tpu_torch.core import evaluate as E
from npp_tpu_torch.core import search as S
from npp_tpu_torch.core import train as T
from npp_tpu_torch.core.criterion import LIP_CLASS_WEIGHTS
from npp_tpu_torch.data import loader as L
from npp_tpu_torch.data.synthetic import SyntheticDataset
from npp_tpu_torch.models import genotype_parse as GP
from npp_tpu_torch.models.augment import build_nppnet
from npp_tpu_torch.ops import heatmaps
from npp_tpu_torch.tools import augment_lip, eval_lip, search_lip

KERNEL_SHAPES = (  # (B, J, gy, gx, sigma)
    (8, 16, 96, 96, 3.0),    # the eval slice's
    (3, 14, 96, 72, 2.0),    # a ragged one
    (1, 13, 25, 23, 2.5),    # its last tile holds 3,528 B, not a multiple of 16
    (16, 16, 96, 96, 3.0),   # the train slice's
    (7, 16, 96, 96, 3.0),    # the search slice's
)
TIMED_SHAPES = {0: "eval", 3: "train", 4: "search"}  # index -> path
KERNEL_ATOL = 1e-6  # the kernel and its plain version round alike
BF16_RTOL = 2e-2    # bf16 vs fp32 eval loss, and first train-step loss
N_IMAGES, BATCH, SEED = 16, 8, 0
# Phase 6, the tiny train step on the card against the CPU (fp32, TF32
# off). The two devices sum in other orders, and the fp32 gradients of
# NPPNet in train mode keep few digits (BN subtracts a batch mean from
# gradients that are mostly that mean; tests/test_torch_train.py holds
# the same effect against fp64). Adam's first updates move each weight by
# about +-lr whatever its gradient's size, so a gradient near 0 that
# rounds to the other sign moves it by 2 lr, and the losses after step 1
# drift apart. Seen by this phase on an NVIDIA H100 80GB HBM3 (700 W)
# against the machine's CPU: losses 1.7e-7, 3.0e-4, 9.0e-4 to 9.2e-4 apart;
# step-1 gradients 0.091 at worst by the per-tensor rule below, 7.5e-3 in
# norm; running stats after step 1 2.9e-5 of max|ref|; lambdas equal.
TINY_LOSS_RTOL = (1e-4, 1e-2, 1e-2)  # per step
TINY_GRAD_TENSOR = 0.25  # x (max|g_cpu| of the tensor + 1e-4 x the model's)
TINY_GRAD_NORM = 3e-2    # ||g_cuda - g_cpu|| / ||g_cpu||, all tensors
TINY_STATS_RTOL = 1e-3   # x max|ref| per running mean / var, after step 1
TINY_LAMDA_ATOL = 1e-5   # after 3 steps
TRAIN_REPEAT = 8         # steps on one batch whose loss must fall
TRAIN_TIMED = 6          # timed steps; the first is dropped as warm-up
RESUME_RTOL = 1e-2       # second step after a restore (seen: 1.5e-4 to 3e-4)
# Phase 8, the tiny search pair on the card against the CPU (fp32, TF32
# off), with phase 6's tolerances where they carry over: the weight step's
# loss (a forward from equal weights) at TINY_LOSS_RTOL[0], the arch
# step's (after one Adam update of every weight) at TINY_LOSS_RTOL[1], the
# running stats after the weight step at TINY_STATS_RTOL x max|ref| plus
# STATS_ATOL (the extra BN after a pool normalises a BN's output, so its
# batch mean, and its running mean, is rounding noise near 0: 3.4 x
# max|ref| apart on the first run of this phase on an NVIDIA H100 80GB
# HBM3, 700 W). The entropy reads the architecture parameters, which the
# weight step leaves, so it is equal up to rounding. Adam's first update
# moves each architecture parameter by lr * g / (|g| + eps), about +-lr,
# so a gradient that changes sign moves it 2 lr apart. After the weight
# step the two devices' weights differ (Adam moves every weight by about
# +-lr whatever its gradient's size), and so do the arch gradients (0.38
# of max|g| in the worst tensor, 0.18 in norm on that first run): after
# the pair the architecture parameters are held only to 2 lr. The arch
# gradients themselves are held where the weights are equal, in an arch
# step from the seeded state, at TINY_GRAD_TENSOR and TINY_GRAD_NORM, and
# that step's update agrees (ARCH_ATOL) wherever |g| is at least ARCH_TIE
# of its tensor's max|g|.
ENTROPY_RTOL = 1e-6
STATS_ATOL = 1e-6
ARCH_TIE = 0.1
ARCH_ATOL = 1e-6
SEARCH_TIMED = 6         # timed bi-level pairs; the first is dropped as warm-up
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


def time_kernel(joints, vis, kw, tag) -> dict:
    """Device time of the kernel and of its plain version at one shape,
    beside the bound, the profiler's kernel time and two yardsticks: an
    empty launch, and a fill of as many bytes as the kernel writes."""
    b, j = joints.shape[:2]
    gy, gx = kw["grid_y"], kw["grid_x"]
    kernel = lambda: heatmaps.render_heatmaps(joints, vis, **kw)
    plain = lambda: heatmaps.render_heatmaps_reference(joints, vis, **kw)
    k_us, k_queued = device_us(kernel)
    p_us, p_queued = device_us(plain)
    if not k_queued:
        raise AssertionError("the timed kernel calls were not all queued "
                             "behind the sleep")
    b_us, b_by = bound_us(b, j, gy, gx)
    prof_us = profiled_kernel_us(kernel)
    empty_us, _ = device_us(lambda: torch.cuda._sleep(0))
    fill_us, _ = device_us(lambda: torch.zeros(
        2 * b * gy * gx * (j + 1), device="cuda"))
    print(f"phase 3: device time at B={b} J={j} {gy}x{gx}: kernel "
          f"{k_us:.4f} us, plain version {p_us:.4f} us"
          f"{'' if p_queued else ' (it synchronises: host time included)'}"
          f"; bound {b_us:.4f} us ({b_by}); kernel at "
          f"{b_us / k_us:.4f} of the bound; an empty launch "
          f"{empty_us:.4f} us, a fill of the same bytes "
          f"{fill_us:.4f} us; torch.profiler lists "
          + ("no row for the kernel" if prof_us is None else
             f"the kernel at {prof_us:.4f} us per launch") + f" {tag}")
    return dict(shape=[b, j, gy, gx], device_us=k_us, plain_us=p_us,
                bound_us=b_us, bound_by=b_by, share_of_bound=b_us / k_us,
                plain_queued=p_queued, profiler_us=prof_us,
                empty_launch_us=empty_us, fill_us=fill_us)


def check_kernel(tag: str) -> dict:
    """Phase 3: kernel vs plain version at every shape of KERNEL_SHAPES;
    device time of both, and the bound, at the eval and train shapes."""
    rng = np.random.default_rng(SEED)
    worst, timed = 0.0, {}
    for i, (b, j, gy, gx, sigma) in enumerate(KERNEL_SHAPES):
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
        if i in TIMED_SHAPES:
            timed[TIMED_SHAPES[i]] = time_kernel(joints, vis, kw, tag)
    ev = timed["eval"]
    shapes = {}
    for path in ("train", "search"):
        sh = {k: timed[path][k] for k in (
            "shape", "device_us", "plain_us", "bound_us", "bound_by",
            "share_of_bound", "profiler_us")}
        sh.update(ms=sh["device_us"] / 1e3, plain_ms=sh["plain_us"] / 1e3,
                  bound_ms=sh["bound_us"] / 1e3)
        shapes[f"{path}_shape"] = sh
    return {"max_abs_err": worst, "ms": ev["device_us"] / 1e3,
            "plain_ms": ev["plain_us"] / 1e3,
            "bound_ms": ev["bound_us"] / 1e3, **ev, **shapes,
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


def tiny_batch(device, n: int = augment_lip.TINY_TRAIN["batch_size"],
               seed: int = SEED) -> dict:
    """Phase 6's batch (and with ``n``, ``seed`` phase 8's): ``n``
    synthetic 128x128 images, one brightness each (noise images alone
    average out to nearly equal deep features, and a train-mode BN over
    such a batch amplifies rounding), rendered on ``device``: by the
    heatmap kernel on the card, by its plain version on the CPU."""
    ds = SyntheticDataset(length=n, crop_size=augment_lip.TINY_TRAIN["crop"],
                          seed=seed, device_normalize=True)
    host = L.collate([ds[i] for i in range(n)])
    gain = np.linspace(0.25, 1.0, n, dtype=np.float32)
    host["image"] = (host["image"] * gain[:, None, None, None]).astype(
        np.uint8)
    keys = ("image", "par", "joints", "visibility")
    batch = {k: torch.from_numpy(host[k]).to(device) for k in keys}
    renderer = L.make_target_renderer(stride=4, sigma=eval_lip.SIGMA,
                                      num_joints=eval_lip.NUM_JOINTS,
                                      ignore=eval_lip.IGNORE,
                                      normalize_images=True)
    batch.update(renderer(*(batch[k] for k in keys)))
    return batch


def tiny_run(device, batch) -> dict:
    """Three train steps of the tiny configuration in fp32 on ``device``
    from the seeded weights, on one batch."""
    hp = augment_lip.TINY_TRAIN
    state = augment_lip.init_state(eval_lip.TINY, hp, device=device,
                                   dtype=torch.float32, seed=SEED,
                                   steps_per_epoch=1)
    step = augment_lip.make_train_step(hp)
    losses, grads, stats = [], None, None
    for i in range(3):
        losses.append(step(state, batch)["loss"].item())
        if i == 0:
            grads = {n: p.grad.detach().double().cpu()
                     for n, p in state.model.named_parameters()}
            stats = {n: t.detach().double().cpu() for n, t in
                     state.model.state_dict().items() if "running" in n}
    lamdas = {k: p.detach().double().cpu() for k, p in state.lamdas.items()}
    return dict(losses=losses, grads=grads, stats=stats, lamdas=lamdas)


def check_tiny_train(tag: str) -> dict:
    """Phase 6: the tiny train step on the card against the CPU."""
    on_card, on_cpu = tiny_batch("cuda"), tiny_batch("cpu")
    # The card's expf and the CPU's exp may round a value apart.
    t_err = max((on_card[k].cpu() - on_cpu[k]).abs().max().item()
                for k in ("pose", "pose_aux"))
    if not t_err <= KERNEL_ATOL:
        raise AssertionError(f"phase 6: the kernel's targets differ from "
                             f"the CPU plain version's by {t_err}")
    card, cpu = tiny_run("cuda", on_card), tiny_run("cpu", on_cpu)
    rel = [abs(a - b) / abs(b) for a, b in zip(card["losses"], cpu["losses"])]
    model_max = max(g.abs().max().item() for g in cpu["grads"].values())
    worst_t, worst_name, sq_d, sq_r = 0.0, "", 0.0, 0.0
    for n, ref in cpu["grads"].items():
        d = card["grads"][n] - ref
        ratio = d.abs().max().item() / (ref.abs().max().item()
                                        + 1e-4 * model_max)
        if ratio > worst_t:
            worst_t, worst_name = ratio, n
        sq_d += float((d * d).sum())
        sq_r += float((ref * ref).sum())
    g_norm = (sq_d / sq_r) ** 0.5
    s_err = max((card["stats"][n] - r).abs().max().item()
                / max(r.abs().max().item(), 1e-30)
                for n, r in cpu["stats"].items())
    l_err = max((card["lamdas"][k] - r).abs().max().item()
                for k, r in cpu["lamdas"].items())
    print(f"phase 6: tiny train step (L=8, C=8, 128x128, bs4, fp32, TF32 "
          f"off), card vs CPU: heatmap targets (kernel vs CPU plain "
          f"version) max|diff| {t_err:.3g} (<= {KERNEL_ATOL}); losses "
          f"{['%.6f' % x for x in card['losses']]} vs "
          f"{['%.6f' % x for x in cpu['losses']]}, relative "
          f"{['%.3g' % x for x in rel]} (<= {TINY_LOSS_RTOL}); step-1 "
          f"gradients: worst tensor {worst_t:.3g} of (max|g| + 1e-4 model "
          f"max) ({worst_name}; <= {TINY_GRAD_TENSOR}), norm {g_norm:.3g} "
          f"(<= {TINY_GRAD_NORM}); running stats after step 1 {s_err:.3g} "
          f"of max|ref| (<= {TINY_STATS_RTOL}); lambdas after 3 steps "
          f"{l_err:.3g} (<= {TINY_LAMDA_ATOL}) {tag}")
    if not all(r <= t for r, t in zip(rel, TINY_LOSS_RTOL)):
        raise AssertionError(f"phase 6: losses {card['losses']} vs "
                             f"{cpu['losses']}")
    if not (worst_t <= TINY_GRAD_TENSOR and g_norm <= TINY_GRAD_NORM):
        raise AssertionError("phase 6: gradients disagree")
    if not (s_err <= TINY_STATS_RTOL and l_err <= TINY_LAMDA_ATOL):
        raise AssertionError("phase 6: running stats or lambdas disagree")
    return dict(target_err=t_err, loss_rel=rel, grad_worst=worst_t,
                grad_norm=g_norm,
                stats_rel=s_err, lamda_abs=l_err)


def same_values(a, b) -> bool:
    """Whether two nested state dicts hold equal tensors and values."""
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_values(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(same_values, a, b))
    return a == b


def take(loader, n: int) -> list:
    """The first ``n`` batches of an epoch of ``loader``."""
    it = iter(loader)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


def profile_step(step, state, batch) -> dict:
    """Device operations (kernels, copies, fills) and device busy time of
    one step (``torch.profiler``, device activity only; busy = the union
    of their spans), with the eight largest by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    # Kernels and memory operations; not the ranges that user annotations
    # (such as the optimizer's step) draw on the device's timeline.
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and not e.name.startswith("Optimizer.")]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        by_name[e.name][0] += e.time_range.end - e.time_range.start
        by_name[e.name][1] += 1
    top = sorted(((t, n, k) for k, (t, n) in by_name.items()),
                 reverse=True)[:8]
    if not spans:
        raise AssertionError("torch.profiler recorded no device operation")
    return dict(kernels=len(spans), busy_ms=busy / 1e3,
                top=[(k[:70], n, round(t / 1e3, 3)) for t, n, k in top])


def fp32_loss(state, batch, hp) -> float:
    """The dual-task loss of a float32 copy of the state's model (train
    mode, no gradients) on ``batch``; the state stays untouched."""
    ref = copy.deepcopy(state.model)
    ref.dtype = torch.float32
    with torch.no_grad():
        loss = T.compute_losses(ref, state.lamdas, batch,
                                class_weights=LIP_CLASS_WEIGHTS,
                                ignore_index=eval_lip.IGNORE,
                                ohem_thres=hp["ohem_thres"],
                                ohem_keep=hp["ohem_keep"])[0].item()
    del ref
    return loss


def flagship_train(tag: str) -> dict:
    """Phase 7: the flagship train slice at batch 16, bf16 +
    channels_last, through the train CLI's functions; then the CLI."""
    hp = augment_lip.FLAGSHIP_TRAIN
    bs = hp["batch_size"]
    train_loader, val_loader = augment_lip.build_loaders(hp, "cuda")
    state = augment_lip.init_state(eval_lip.FLAGSHIP, hp, device="cuda",
                                   dtype=torch.bfloat16, seed=SEED,
                                   steps_per_epoch=len(train_loader))
    n_params = sum(p.numel() for p in state.model.parameters())
    assert n_params == 76_968_332, n_params
    step = augment_lip.make_train_step(hp)
    batches = take(train_loader, 2)

    # bf16 first-step loss against fp32 on the same weights and batch.
    loss32 = fp32_loss(state, batches[0], hp)
    lam0 = {k: p.detach().clone() for k, p in state.lamdas.items()}
    stats0 = {n: t.clone() for n, t in state.model.state_dict().items()
              if "running" in n}

    losses = [step(state, batches[0])["loss"] for _ in range(TRAIN_REPEAT)]
    losses = [x.item() for x in losses]
    rel = abs(losses[0] - loss32) / abs(loss32)
    print(f"phase 7: flagship train step (bs{bs}, 384x384, bf16, "
          f"channels_last, {n_params:,} parameters): first loss "
          f"{losses[0]:.6f} vs fp32 {loss32:.6f}, relative {rel:.3g} (<= "
          f"{BF16_RTOL}); {TRAIN_REPEAT} steps on one batch: "
          f"{['%.4f' % x for x in losses]} {tag}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"phase 7: non-finite loss {losses}")
    if not rel <= BF16_RTOL:
        raise AssertionError(f"phase 7: bf16 loss {losses[0]} vs fp32 "
                             f"{loss32}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"phase 7: the loss did not fall: {losses}")
    moved = {k: (p.detach() - lam0[k]).abs().max().item()
             for k, p in state.lamdas.items()}
    n_moved = sum(not torch.equal(t, stats0[n]) for n, t in
                  state.model.state_dict().items() if "running" in n)
    print(f"phase 7: lambdas moved by {moved}; {n_moved} of {len(stats0)} "
          f"running stats changed {tag}")
    if not (min(moved.values()) > 0 and n_moved > 0):
        raise AssertionError("phase 7: lambdas or running stats did not "
                             "move")

    # One epoch through the engine, then the flip-TTA validation.
    train_loader.set_epoch(1)
    avg, _ = engine.train_epoch(step, state, train_loader, epoch=1,
                                print_freq=hp["print_freq"])
    eval_step = E.make_eval_step(
        state.model, num_classes=eval_lip.NUM_CLASSES,
        class_weights=LIP_CLASS_WEIGHTS, flip_test=True,
        ignore_index=eval_lip.IGNORE, decode_hw=(384, 384))
    res = augment_lip.validate(state, eval_step, val_loader)
    n_val = len(val_loader.dataset)
    print(f"phase 7: train_epoch over {len(train_loader)} batches: mean "
          f"loss {avg:.6f}; validate: {eval_lip.result_line(res)} {tag}")
    if not (math.isfinite(avg) and math.isfinite(res["loss"])):
        raise AssertionError("phase 7: non-finite epoch or val loss")
    if int(res["cm"].sum()) == 0 or res["pose_preds"].shape != (n_val, 16, 3):
        raise AssertionError("phase 7: validation produced no results")

    # Timed steps (host clock after synchronize), peak memory, a profile.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(TRAIN_TIMED):
        t0 = time.perf_counter()
        step(state, batches[i % 2])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_s = statistics.median(times[1:])
    peak = torch.cuda.max_memory_allocated()
    prof = profile_step(step, state, batches[0])
    idle = 1.0 - prof["busy_ms"] / (step_s * 1e3)
    print(f"phase 7: train step bs{bs}: median {step_s * 1e3:.3f} ms over "
          f"{TRAIN_TIMED - 1} warm steps ({['%.1f' % (t * 1e3) for t in times]}"
          f" ms) = {bs / step_s:.2f} img/s; peak memory "
          f"{peak / 2**30:.3f} GiB; one profiled step: {prof['kernels']} "
          f"device operations, device busy {prof['busy_ms']:.3f} ms, idle share "
          f"of the median step {idle:.3f}; top by device time "
          f"{prof['top']} {tag}")

    # Checkpoint save and restore: the restored state equals the saved
    # one (model, lambdas and their accumulated gradients, Adam's moments,
    # the schedule, the count) and takes the same next step. The first
    # loss after it is a forward from equal weights: equal. The second
    # follows an update from gradients that differ in the last bits (the
    # backward's atomics): within RESUME_RTOL.
    with tempfile.TemporaryDirectory() as tmp:
        mgr = checkpoint.CheckpointManager(tmp)
        mgr.save(0, state, metrics={"mean_iou": res["mean_iou"]})
        resumed = augment_lip.init_state(
            eval_lip.FLAGSHIP, hp, device="cuda", dtype=torch.bfloat16,
            seed=SEED + 1, steps_per_epoch=len(train_loader))
        mgr.restore(resumed)
        same = same_values(checkpoint.state_dict(state),
                           checkpoint.state_dict(resumed))
        a = [step(state, x)["loss"].item() for x in batches]
        b = [step(resumed, x)["loss"].item() for x in batches]
        del resumed
    print(f"phase 7: checkpoint restore: every saved value identical "
          f"{same}; next losses uninterrupted {a} vs restored {b} (the "
          f"second within {RESUME_RTOL}) {tag}")
    if not (same and a[0] == b[0] and math.isclose(a[1], b[1],
                                                    rel_tol=RESUME_RTOL)):
        raise AssertionError("phase 7: the restored state does not resume "
                             "the run")

    # The train CLI itself, two steps and one epoch.
    with tempfile.TemporaryDirectory() as tmp:
        out = augment_lip.main(["--synthetic", "--steps", "2", "--epochs",
                                "1", "--out", tmp])
        if not math.isfinite(out["train_loss"]):
            raise AssertionError("phase 7: the CLI's loss is not finite")
    print(f"phase 7: python -m npp_tpu_torch.tools.augment_lip --synthetic "
          f"--steps 2 --epochs 1: train loss {out['train_loss']:.6f}, "
          f"{eval_lip.result_line(out['result'])} {tag}")
    return dict(step_ms=step_s * 1e3, img_per_s=bs / step_s,
                peak_gib=peak / 2**30, idle_share=idle, **prof)


def tiny_search_run(device, batches) -> dict:
    """On ``device`` in fp32 from the seeded tiny search state: one weight
    step then one arch step (entropy on), and, from a second seeded state,
    one arch step alone."""
    hp = search_lip.TINY_SEARCH

    def fresh():
        return search_lip.init_state(search_lip.TINY_SEARCH_MODEL, hp,
                                     device=device, dtype=torch.float32,
                                     seed=SEED, steps_per_epoch=1)

    weight_step, arch_step = search_lip.make_search_steps(hp)
    state = fresh()
    arch = state.model.arch_parameters()
    rest = {**{n: p for n, p in state.model.named_parameters()
               if n not in arch}, **state.lamdas}
    arch0 = {k: p.detach().clone() for k, p in arch.items()}
    m1 = weight_step(state, batches[0])
    arch_kept = all(torch.equal(arch[k], arch0[k]) for k in arch)
    stats = {n: t.detach().double().cpu() for n, t in
             state.model.state_dict().items() if "running" in n}
    rest0 = {k: p.detach().clone() for k, p in rest.items()}
    m2 = arch_step(state, batches[1], 1.0)
    rest_kept = all(torch.equal(rest[k], rest0[k]) for k in rest)
    pair_arch = {k: p.detach().double().cpu() for k, p in arch.items()}

    alone = fresh()
    arch_step(alone, batches[1], 1.0)
    grads = {k: (p.grad + S.ALPHA_WEIGHT_DECAY * arch0[k]).double().cpu()
             for k, p in alone.model.arch_parameters().items()}
    return dict(losses=[m1["loss"].item(), m2["loss"].item()],
                entropy=m2["entropy"].item(), stats=stats,
                pair_arch=pair_arch, grads=grads,
                arch={k: p.detach().double().cpu()
                      for k, p in alone.model.arch_parameters().items()},
                kept=(arch_kept, rest_kept), lr=hp["alpha_lr"])


def check_tiny_search(tag: str) -> dict:
    """Phase 8: the tiny search pair on the card against the CPU."""
    n = search_lip.TINY_SEARCH["batch_size"]
    on_card = [tiny_batch("cuda", n, SEED + i) for i in range(2)]
    on_cpu = [tiny_batch("cpu", n, SEED + i) for i in range(2)]
    card, cpu = (tiny_search_run("cuda", on_card),
                 tiny_search_run("cpu", on_cpu))
    two_lr = 2 * cpu["lr"] + ARCH_ATOL
    rel = [abs(a - b) / abs(b) for a, b in zip(card["losses"], cpu["losses"])]
    ent = abs(card["entropy"] - cpu["entropy"]) / abs(cpu["entropy"])
    s_err = max((card["stats"][k] - r).abs().max().item()
                / (TINY_STATS_RTOL * r.abs().max().item() + STATS_ATOL)
                for k, r in cpu["stats"].items())
    pair_err = max((card["pair_arch"][k] - r).abs().max().item()
                   for k, r in cpu["pair_arch"].items())
    pair_apart = sum(int(((card["pair_arch"][k] - r).abs() > ARCH_ATOL).sum())
                     for k, r in cpu["pair_arch"].items())
    g_max = max(g.abs().max().item() for g in cpu["grads"].values())
    worst_g, sq_d, sq_r = 0.0, 0.0, 0.0
    a_err, a_tie_err, ties, flips = 0.0, 0.0, 0, 0
    for k, ref in cpu["grads"].items():
        d = card["grads"][k] - ref
        worst_g = max(worst_g, d.abs().max().item()
                      / (ref.abs().max().item() + 1e-4 * g_max))
        sq_d += float((d * d).sum())
        sq_r += float((ref * ref).sum())
        tie = ref.abs() < ARCH_TIE * ref.abs().max()
        dp = (card["arch"][k] - cpu["arch"][k]).abs()
        ties += int(tie.sum())
        flips += int((tie & (dp > ARCH_ATOL)).sum())
        if (~tie).any():
            a_err = max(a_err, dp[~tie].max().item())
        if tie.any():
            a_tie_err = max(a_tie_err, dp[tie].max().item())
    g_norm = (sq_d / sq_r) ** 0.5
    n_arch = sum(r.numel() for r in cpu["grads"].values())
    print(f"phase 8: tiny search pair (L=8, C=8, 128x128, bs{n}, fp32, "
          f"TF32 off), card vs CPU: losses (weight step, arch step) "
          f"{['%.6f' % x for x in card['losses']]} vs "
          f"{['%.6f' % x for x in cpu['losses']]}, relative "
          f"{['%.3g' % x for x in rel]} (<= {TINY_LOSS_RTOL[:2]}); entropy "
          f"{card['entropy']:.8f} vs {cpu['entropy']:.8f}, relative "
          f"{ent:.3g} (<= {ENTROPY_RTOL}); running stats after the weight "
          f"step {s_err:.3g} of ({TINY_STATS_RTOL} max|ref| + {STATS_ATOL}) "
          f"(<= 1); arch parameters after the pair {pair_err:.3g} apart at "
          f"most (<= 2 lr), {pair_apart} of {n_arch} elements apart; weight "
          f"step kept the arch parameters, arch step kept the weights and "
          f"lambdas: card {card['kept']}, CPU {cpu['kept']}. Arch step from "
          f"the seeded state: gradients (+ weight decay) worst tensor "
          f"{worst_g:.3g} of (max|g| + 1e-4 max) (<= {TINY_GRAD_TENSOR}), "
          f"norm {g_norm:.3g} (<= {TINY_GRAD_NORM}); updated parameters "
          f"{a_err:.3g} apart where |g| >= {ARCH_TIE} max|g| (<= "
          f"{ARCH_ATOL}), {flips} of {ties} nearer-tie elements apart, by "
          f"{a_tie_err:.3g} at most (<= 2 lr) {tag}")
    if not (rel[0] <= TINY_LOSS_RTOL[0] and rel[1] <= TINY_LOSS_RTOL[1]
            and ent <= ENTROPY_RTOL):
        raise AssertionError(f"phase 8: losses {card['losses']} vs "
                             f"{cpu['losses']} or entropy disagree")
    if not (s_err <= 1.0 and pair_err <= two_lr):
        raise AssertionError("phase 8: running stats or arch parameters "
                             "after the pair disagree")
    if not (worst_g <= TINY_GRAD_TENSOR and g_norm <= TINY_GRAD_NORM
            and a_err <= ARCH_ATOL and a_tie_err <= two_lr):
        raise AssertionError("phase 8: arch gradients or the arch update "
                             "from equal weights disagree")
    if not all(card["kept"] + cpu["kept"]):
        raise AssertionError("phase 8: a step changed what it must keep")
    return dict(loss_rel=rel, entropy_rel=ent, stats_share=s_err,
                pair_arch_abs=pair_err, pair_arch_apart=pair_apart,
                arch_grad_worst=worst_g, arch_grad_norm=g_norm,
                arch_abs=a_err, near_ties=ties, near_ties_apart=flips)


def flagship_search(tag: str) -> dict:
    """Phase 9: the search slice at the reference scale (L=16, C=32, batch
    7, 384x384, bf16 + channels_last) through the search CLI's functions;
    then the CLI."""
    hp = search_lip.FLAGSHIP_SEARCH
    bs = hp["batch_size"]
    train_loader, mini_loader, _ = search_lip.build_loaders(hp, "cuda")
    state = search_lip.init_state(search_lip.FLAGSHIP_SEARCH_MODEL, hp,
                                  device="cuda", dtype=torch.bfloat16,
                                  seed=SEED,
                                  steps_per_epoch=len(train_loader))
    n_params = sum(p.numel() for p in state.model.parameters())
    weight_step, arch_step = search_lip.make_search_steps(hp)
    tb, mb = take(train_loader, 2), take(mini_loader, 2)
    arch = state.model.arch_parameters()
    rest = {**{n: p for n, p in state.model.named_parameters()
               if n not in arch}, **state.lamdas}

    # The first pair, each step's bf16 loss against fp32 on the same
    # weights and batch, with the steps' invariants.
    loss32 = [fp32_loss(state, tb[0], hp)]
    arch0 = {k: p.detach().clone() for k, p in arch.items()}
    m1 = weight_step(state, tb[0])
    arch_kept = all(torch.equal(arch[k], arch0[k]) for k in arch)
    loss32.append(fp32_loss(state, mb[0], hp))
    rest0 = {k: p.detach().clone() for k, p in rest.items()}
    m2 = arch_step(state, mb[0], 1.0)
    rest_kept = all(torch.equal(rest[k], rest0[k]) for k in rest)
    n_moved = sum(not torch.equal(arch[k], arch0[k]) for k in arch)
    losses = [m1["loss"].item(), m2["loss"].item()]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, loss32)]
    del rest0
    print(f"phase 9: search pair (L=16, C=32, bs{bs}, 384x384, bf16, "
          f"channels_last, {n_params:,} parameters): losses (weight step, "
          f"arch step) {['%.6f' % x for x in losses]} vs fp32 "
          f"{['%.6f' % x for x in loss32]}, relative "
          f"{['%.3g' % x for x in rel]} (<= {BF16_RTOL}); entropy "
          f"{m2['entropy'].item():.6f}; weight step kept the arch "
          f"parameters {arch_kept}, arch step kept the weights and lambdas "
          f"{rest_kept}; {n_moved} of {len(arch)} arch tensors moved {tag}")
    if not all(math.isfinite(x) for x in losses + loss32):
        raise AssertionError(f"phase 9: non-finite loss {losses} {loss32}")
    if not all(r <= BF16_RTOL for r in rel):
        raise AssertionError(f"phase 9: bf16 losses {losses} vs fp32 "
                             f"{loss32}")
    if not (arch_kept and rest_kept and n_moved == len(arch)):
        raise AssertionError("phase 9: a step changed what it must keep, "
                             "or an arch tensor did not move")

    # Warmup weight steps, then bi-level pairs through the engine.
    train_loader.set_epoch(0)
    avg_w, _ = engine.train_epoch(
        weight_step, state, augment_lip.LimitedLoader(train_loader, 2),
        epoch=0, print_freq=hp["print_freq"])
    train_loader.set_epoch(1)
    mini_loader.set_epoch(1)
    avg_s, _ = engine.search_epoch(
        weight_step, arch_step, state,
        augment_lip.LimitedLoader(train_loader, 2),
        augment_lip.LimitedLoader(mini_loader, 2), epoch=1,
        entropy_epoch=hp["entropy_epoch"], print_freq=hp["print_freq"])
    print(f"phase 9: train_epoch warmup (2 weight steps) mean loss "
          f"{avg_w:.6f}; search_epoch (2 pairs) mean weight-step loss "
          f"{avg_s:.6f} {tag}")
    if not (math.isfinite(avg_w) and math.isfinite(avg_s)):
        raise AssertionError("phase 9: non-finite epoch loss")

    # Timed pairs (host clock after synchronize), peak memory, a profile.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_w, t_a = [], []
    for i in range(SEARCH_TIMED):
        t0 = time.perf_counter()
        weight_step(state, tb[i % 2])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        arch_step(state, mb[i % 2], 1.0)
        torch.cuda.synchronize()
        t_w.append(t1 - t0)
        t_a.append(time.perf_counter() - t1)
    w_s, a_s = statistics.median(t_w[1:]), statistics.median(t_a[1:])
    pair_s = statistics.median([a + b for a, b in zip(t_w, t_a)][1:])
    peak = torch.cuda.max_memory_allocated()

    def pair(st, batches):
        weight_step(st, batches[0])
        arch_step(st, batches[1], 1.0)

    prof = profile_step(pair, state, (tb[0], mb[0]))
    idle = 1.0 - prof["busy_ms"] / (pair_s * 1e3)
    print(f"phase 9: bi-level pair bs{bs}: median {pair_s * 1e3:.3f} ms "
          f"(weight step {w_s * 1e3:.3f} ms, arch step {a_s * 1e3:.3f} ms) "
          f"over {SEARCH_TIMED - 1} warm pairs "
          f"({['%.1f+%.1f' % (a * 1e3, b * 1e3) for a, b in zip(t_w, t_a)]}"
          f" ms) = {bs / pair_s:.3f} train img/s; peak memory "
          f"{peak / 2**30:.3f} GiB; one profiled pair: {prof['kernels']} "
          f"device operations, device busy {prof['busy_ms']:.3f} ms, idle "
          f"share of the median pair {idle:.3f}; top by device time "
          f"{prof['top']} {tag}")

    # The genotype, and a fixed NPPNet built from it at the flagship width.
    inter, fuse = GP.extract_genotype(S.get_arch_params(state))
    net = build_nppnet(device="cuda", generator=torch.Generator()
                       .manual_seed(SEED), dtype=torch.bfloat16, inter=inter,
                       fusion=fuse, **eval_lip.FLAGSHIP)
    net = net.to(memory_format=torch.channels_last)
    with torch.no_grad():
        pose_list, par_list = net(tb[0]["image"])
    heads = [t for stage in (*pose_list, *par_list) for t in stage]
    shapes = [tuple(t.shape) for t in heads]
    finite = all(bool(torch.isfinite(t).all()) for t in heads)
    del net, pose_list, par_list, heads
    print(f"phase 9: genotype {inter} {fuse}; NPPNet built from it (C=64, "
          f"L=16) forward on the batch: output shapes {shapes}, finite "
          f"{finite} {tag}")
    if not (finite and shapes[0] == (bs, 16, 96, 96)
            and shapes[4] == (bs, 20, 96, 96)):
        raise AssertionError("phase 9: the searched NPPNet's forward failed")

    # Checkpoint save and restore: every saved value identical, and the
    # next weight step's loss (a forward from equal weights) equal.
    with tempfile.TemporaryDirectory() as tmp:
        mgr = checkpoint.CheckpointManager(tmp)
        mgr.save(0, state, metrics={"best_iou": 0.0})
        resumed = search_lip.init_state(
            search_lip.FLAGSHIP_SEARCH_MODEL, hp, device="cuda",
            dtype=torch.bfloat16, seed=SEED + 1,
            steps_per_epoch=len(train_loader))
        mgr.restore(resumed)
        same = same_values(checkpoint.state_dict(state),
                           checkpoint.state_dict(resumed))
        a = weight_step(state, tb[0])["loss"].item()
        b = weight_step(resumed, tb[0])["loss"].item()
        del resumed
    print(f"phase 9: search checkpoint restore: every saved value identical "
          f"{same}; next weight-step loss uninterrupted {a} vs restored {b} "
          f"{tag}")
    if not (same and a == b):
        raise AssertionError("phase 9: the restored search state does not "
                             "resume the run")
    del state, tb, mb
    torch.cuda.empty_cache()

    # The search CLI itself: a warmup epoch and a search epoch of 2 steps.
    with tempfile.TemporaryDirectory() as tmp:
        out = search_lip.main(["--synthetic", "--steps", "2", "--epochs",
                               "2", "--warmup-epochs", "1", "--out", tmp])
        wrote = os.path.isfile(os.path.join(out["out_dir"],
                                            "best_genotype.json"))
    print(f"phase 9: python -m npp_tpu_torch.tools.search_lip --synthetic "
          f"--steps 2 --epochs 2 --warmup-epochs 1: train loss "
          f"{out['train_loss']:.6f}, {eval_lip.result_line(out['result'])}, "
          f"best_genotype.json written {wrote} {tag}")
    if not (wrote and math.isfinite(out["train_loss"])):
        raise AssertionError("phase 9: the search CLI wrote no "
                             "best_genotype.json or its loss is not finite")
    return dict(pair_ms=pair_s * 1e3, weight_step_ms=w_s * 1e3,
                arch_step_ms=a_s * 1e3, img_per_s=bs / pair_s,
                peak_gib=peak / 2**30, idle_share=idle, params=n_params,
                loss_rel_bf16=rel, **prof)


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
    heatmaps.render_heatmaps.launches = 0  # the eval path's count
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
    launches = {"eval": heatmaps.render_heatmaps.launches}
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 5: warm pass {N_IMAGES} images in {dt:.4f} s = "
          f"{N_IMAGES / dt:.2f} img/s (bf16, bs{BATCH}, flip-TTA, loader "
          f"and decode included); peak memory {peak / 2**30:.3f} GiB {tag}")
    del model

    # Phase 6: the tiny train step, card against CPU (fp32, TF32 off).
    tiny = check_tiny_train(tag)

    # Phase 7: the flagship train slice in bf16 + channels_last.
    heatmaps.render_heatmaps.launches = 0  # the train path's count
    train = flagship_train(tag)
    launches["train"] = heatmaps.render_heatmaps.launches

    # Phase 8: the tiny search pair, card against CPU (fp32, TF32 off).
    tiny_search = check_tiny_search(tag)

    # Phase 9: the search slice at the reference scale.
    heatmaps.render_heatmaps.launches = 0  # the search path's count
    search = flagship_search(tag)
    launches["search"] = heatmaps.render_heatmaps.launches
    print(f"phase 9: heatmap kernel launches on the main paths: {launches}; "
          f"summary {json.dumps({'tiny_train': tiny, 'train_step': train, 'tiny_search': tiny_search, 'search_pair': search})}")
    for path, n in launches.items():
        if n == 0:
            raise AssertionError(f"the {path} path never launched the "
                                 f"heatmap kernel")

    print(json.dumps({"kernels": [{
        "name": "render_heatmaps", "route": "cuda",
        "source": "npp_tpu_torch/ops/csrc/render_heatmaps.cu",
        "replaces": "npp_tpu/ops/pallas_kernels.py:71",
        "launches": sum(launches.values()), "launches_by_path": launches,
        **kernel}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
