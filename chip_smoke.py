"""On-card smoke run of the PyTorch port (npp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernel from the sources in this
checkout, checks it against its plain PyTorch version on the card, then
drives the port's two paths at the flagship's width (L=16, C=64,
384x384, random weights from a seed, synthetic data): the NPPNet flip-TTA
evaluation (16 images at batch 8, loader -> heatmap kernel -> eval step
-> validate, in fp32 and in bf16 + channels_last) and the augment-phase
training (batch 16, bf16 + channels_last: loader -> heatmap kernel ->
forward, dual-task loss, backward, Adam -> train_epoch -> validate ->
checkpoint save and restore, then the train CLI itself). Any failure
raises, so the exit code is non-zero; without CUDA it exits non-zero
before printing any result.

Phases: 1 device, 2 build, 3 kernel vs plain version (four shapes) and
the device time of both by many launches, beside the kernel's bound, at
the eval and the train shapes, 4 the eval slice in fp32, 5 the eval
slice in bf16 + channels_last (timed), 6 the tiny train step on the card
against the CPU in fp32, 7 the flagship train slice in bf16 +
channels_last (checked, timed, profiled).
Output: one line per phase, then a JSON line of the kernels, the
``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import copy
import json
import math
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
from npp_tpu_torch.core import train as T
from npp_tpu_torch.core.criterion import LIP_CLASS_WEIGHTS
from npp_tpu_torch.data import loader as L
from npp_tpu_torch.data.synthetic import SyntheticDataset
from npp_tpu_torch.models.augment import build_nppnet
from npp_tpu_torch.ops import heatmaps
from npp_tpu_torch.tools import augment_lip, eval_lip

KERNEL_SHAPES = (  # (B, J, gy, gx, sigma)
    (8, 16, 96, 96, 3.0),    # the eval slice's
    (3, 14, 96, 72, 2.0),    # a ragged one
    (1, 13, 25, 23, 2.5),    # its last tile holds 3,528 B, not a multiple of 16
    (16, 16, 96, 96, 3.0),   # the train slice's
)
TIMED_SHAPES = {0: "eval", 3: "train"}  # KERNEL_SHAPES index -> path
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
    train_shape = {k: timed["train"][k] for k in (
        "shape", "device_us", "plain_us", "bound_us", "bound_by",
        "share_of_bound", "profiler_us")}
    train_shape.update(ms=train_shape["device_us"] / 1e3,
                       plain_ms=train_shape["plain_us"] / 1e3,
                       bound_ms=train_shape["bound_us"] / 1e3)
    return {"max_abs_err": worst, "ms": ev["device_us"] / 1e3,
            "plain_ms": ev["plain_us"] / 1e3,
            "bound_ms": ev["bound_us"] / 1e3, **ev,
            "train_shape": train_shape,
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


def tiny_batch(device) -> dict:
    """Phase 6's batch: 4 synthetic 128x128 images, one brightness each
    (noise images alone average out to nearly equal deep features, and a
    train-mode BN over such a batch amplifies rounding), rendered on
    ``device``: by the heatmap kernel on the card, by its plain version
    on the CPU."""
    hp = augment_lip.TINY_TRAIN
    n = hp["batch_size"]
    ds = SyntheticDataset(length=n, crop_size=hp["crop"], seed=SEED,
                          device_normalize=True)
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
    one train step (``torch.profiler``; busy = the union of their
    spans), with the eight largest by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
    return dict(kernels=len(spans), busy_ms=busy / 1e3,
                top=[(k[:70], n, round(t / 1e3, 3)) for t, n, k in top])


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

    # bf16 first-step loss against fp32 on the same weights and batch (a
    # copy of the model, forward only, so the state stays untouched).
    ref = copy.deepcopy(state.model)
    ref.dtype = torch.float32
    with torch.no_grad():
        loss32 = T.compute_losses(ref, state.lamdas, batches[0],
                                  class_weights=LIP_CLASS_WEIGHTS,
                                  ignore_index=eval_lip.IGNORE,
                                  ohem_thres=hp["ohem_thres"],
                                  ohem_keep=hp["ohem_keep"])[0].item()
    del ref
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
    print(f"phase 7: heatmap kernel launches on the main path: {launches}; "
          f"summary {json.dumps({'tiny_train': tiny, 'train_step': train})}")
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
