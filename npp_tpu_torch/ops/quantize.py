"""int8 serving of the dense convolutions: weights symmetric per output
channel, activations symmetric per tensor, int32 accumulation.

Port of ``npp_tpu/ops/quantize.py``. npp_tpu switches its convs at trace
time with a global flag (``quantized_convs``) and keeps the int8 weights
and the calibrated scales in flax collections (``qconst``,
``act_scales``). Here the state is explicit and per module:
``prepare_int8(model)`` replaces every dense conv (``nn.Conv2d`` with
groups 1) by an ``Int8Conv2d`` that holds the same parameter tensors and,
as buffers that are not parameters and not in the ``state_dict``, its
int8 weights ``qweight`` ((Cout, kh * kw * Cin), the kernel's
(Cout, kh, kw, Cin) order) with their scales ``wscale``, and an optional
static activation scale ``act_scale`` (``calibrate_acts``). The
``state_dict`` stays the fp model's, so an fp checkpoint serves int8
unchanged. Grouped and depthwise convs stay floating point, as in
npp_tpu. Serving only: nothing here has a backward.

Two hand-written kernels serve a CUDA tensor, each built with ``nvcc``
for ``sm_90a`` at its first launch into ``npp_tpu_torch/_build/`` and
called through ctypes (a failed build or launch raises); a CPU tensor
gets each one's plain version, and any other device raises:

- ``quantize_weight``: max(max|w|, 1e-8) / 127 per output channel over
  dims (1, 2, 3) of OIHW, then round half to even (``torch.round``, as
  ``jnp.round``). Plain torch: it runs once per prepared model.
- ``quantize_act`` (``csrc/int8_quantize.cu``; plain version
  ``quantize_act_reference``): with ``relu``, torch.relu of x first; then
  dynamic, max(max|x|, 1e-8) / 127 over the tensor and q = round(x /
  scale), in one launch that reads x once and leaves the scale on the
  device; or static, with q clipped to +-127, in one launch of a plain
  grid-stride loop. q comes out
  NHWC-contiguous (an NCHW view of it), as the conv reads it. Each
  launch's variant, grid and shared memory come from ``_quant_plan``, a
  plain function of the input's size, layout and the card's SM count.
  ``act_absmax`` (the absmax alone, one launch, the ReLU folded in too)
  serves ``calibrate_acts`` and the dynamic scale on a grid of ranks.
- ``conv_s8`` (``csrc/int8_conv.cu``; plain version
  ``conv_s8_reference``): the int8 conv of quantized operands with the
  fp32 epilogue float(acc) * (a_scale * w_scale) + bias, in that order.
  Each launch's tile variant, tile width, ring depth and K split come
  from ``_conv_plan``, a plain function of the shapes.
- ``int8_conv(x, conv)`` = ``quantize_act`` + ``conv_s8``;
  ``int8_conv_reference`` = ``quantize_act_reference`` +
  ``conv_s8_reference``. ``relu_conv(conv, x)`` is ``conv(F.relu(x))``,
  which a prepared conv computes with the ReLU folded into its quantize
  (``int8_conv(x, conv, relu=True)``): the call sites of the model's
  ReLU -> dense conv pairs use it, so the int8 forward runs no separate
  ReLU pass there, and the fp forward runs exactly what it ran.

On a grid of ranks (``prepare_int8(model, grid)``, after
``parallel.spatial.convert_spatial`` where the grid splits rows) each
rank holds a shard of the batch and of the rows, where npp_tpu's one
program holds the global activation. npp_tpu's dynamic scale is the max
over that whole activation, one scale for the global batch and every
device of its mesh, so a prepared conv takes it so (``grid_quantize``):
``act_absmax`` of its own input, one MAX all-reduce over the grid
(``mesh.all_max``), then the static quantize with that scale, which
gives the int8 values and the scale that the one-device dynamic quantize
gives on the gathered tensor, bit for bit. A calibrated scale is one
number on every rank and needs no collective; the calibration records
the grid's max.

The output dtype follows npp_tpu's ``out_dtype = self.dtype or x.dtype``:
the autocast dtype where autocast is on (bf16 in the serving forward),
else the input's (float32 for the heads' last convs, which run with
autocast off). Importing this module builds nothing.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
from pathlib import Path

import torch
import torch.nn as nn
import torch.nn.functional as F

from npp_tpu_torch.ops.heatmaps import count_launch, nvcc_build
from npp_tpu_torch.parallel.mesh import all_max, multi_rank

_CSRC = Path(__file__).resolve().parent / "csrc" / "int8_conv.cu"
_QSRC = Path(__file__).resolve().parent / "csrc" / "int8_quantize.cu"
_LIBRARY: dict = {}  # the loaded ctypes libraries, once built
_COUNTERS: dict = {}  # per device: the kernels' zeroed arrival counters
_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_ACT_DTYPE = {torch.float32: 0, torch.bfloat16: 1}

# The conv's launch plan (see _conv_plan and csrc/int8_conv.cu).
TILE_M = 128                # output pixels per block tile
PATCH_H, PATCH_W = 8, 16    # a patch tile's output rows and columns
STAGE_K = 128               # bytes of K per ring stage
TINY_M = 64                 # at most this many rows: the tiny-M variant
RING_MAX = 5                # ring stages, at most
SMEM_BLOCK_LIMIT = 232_448  # shared memory one block may use on Hopper
SMS = 132                   # the H100 SXM's SMs (the plan's default)
STAGING_BYTES = 2 * 64 * (256 + 16)  # the epilogue's staging (kStagingBytes)
TABLE_BYTES = 2 * 2 * 256 * 4  # its column scales and biases (kTableBytes)
VARIANT_CODE = {"wgmma": 0, "packed": 1, "tiny_m": 2, "wgmma_tma": 3}
# The quantize's launches (see _quant_plan and csrc/int8_quantize.cu).
QUANT_THREADS = 512         # threads of a channels_last or dynamic block
LOOP_THREADS = 256          # of a plain grid-stride loop (kLoopThreads)
QUANT_CHUNK = 16_384        # bytes of x per bulk copy (kChunk)
QUANT_RING = 4              # ring chunks of a slice above the stash
QUANT_PAIR = 2              # 16-byte vectors a loop thread an iteration
QUANT_UNIT = 16             # elements: a block slice's granularity (kUnit)
QUANT_MAX_STASH = 14        # stash chunks of a block, at most (kMaxStash)
QUANT_BARRIER_BYTES = 512   # the mbarriers' shared memory (kBarrierBytes)
TINY_QUANT_BYTES = 32_768   # at most this much x: one block, no barrier
QUANT_MIN_SLICE = 4_096     # bytes of x a block slice, at least
ABSMAX_BLOCKS = 1024        # blocks (partial maxima) of an absmax launch
QUANT_BLOCKS = 8192         # blocks of a plain quantize loop, at most
QUANT_VARIANT_CODE = {"tiny": 0, "cooperative": 1, "flat": 2, "nchw": 3,
                      "nchw_static": 4}


def quantize_weight(weight: torch.Tensor):
    """OIHW float weight -> (int8 OIHW, float32 scale (Cout,)) with
    q * scale ~= weight."""
    wf = weight.detach().to(torch.float32)
    w_scale = torch.clamp(wf.abs().amax(dim=(1, 2, 3)), min=1e-8) / 127.0
    q = torch.round(wf / w_scale[:, None, None, None]).to(torch.int8)
    return q, w_scale


def quantize_act_reference(x: torch.Tensor,
                           act_scale: torch.Tensor | None = None, *,
                           relu: bool = False):
    """Plain version of ``quantize_act``: (int8 x in x's layout, its
    float32 0-d scale). ``relu`` quantizes ``F.relu(x)``. ``act_scale``
    None is the dynamic scale; a static one clips to +-127. The divisor is
    a tensor: a Python-scalar divisor would let PyTorch's CUDA division
    multiply by its reciprocal, another rounding than npp_tpu's."""
    if relu:
        x = F.relu(x)
    xf = x.to(torch.float32)
    if act_scale is None:
        a_scale = torch.clamp(xf.abs().amax(), min=1e-8) / 127.0
        q = torch.round(xf / a_scale)
    else:
        a_scale = act_scale.to(torch.float32)
        q = torch.clamp(torch.round(xf / a_scale), -127.0, 127.0)
    return q.to(torch.int8), a_scale


def act_absmax_reference(x: torch.Tensor, *, relu: bool = False
                         ) -> torch.Tensor:
    """Plain version of ``act_absmax``: [max|x|, the dynamic scale] (of
    ``F.relu(x)`` with ``relu``), as ``quantize_act_reference`` computes
    them."""
    if relu:
        x = F.relu(x)
    amax = x.to(torch.float32).abs().amax()
    return torch.stack([amax, torch.clamp(amax, min=1e-8) / 127.0])


def _check_act(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: input on {x.device}")
    if x.dtype not in _ACT_DTYPE:
        raise ValueError(f"{name}: {x.dtype} input; the kernel takes "
                         f"float32 or bfloat16")
    if x.ndim != 4:
        raise ValueError(f"{name}: a 4-D (N, C, H, W) input, got "
                         f"{tuple(x.shape)}")
    if x.numel() >= 2**31:
        raise ValueError(f"{name}: tensors over 2^31 elements")


def _quant_library() -> ctypes.CDLL:
    if "quant" not in _LIBRARY:
        path, _ = build_quantize()
        lib = ctypes.CDLL(str(path))
        lib.npp_act_absmax.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p]
        lib.npp_act_absmax.restype = ctypes.c_int
        lib.npp_quantize_act.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.npp_quantize_act.restype = ctypes.c_int
        _LIBRARY["quant"] = lib
    return _LIBRARY["quant"]


@dataclasses.dataclass(frozen=True)
class QuantPlan:
    """One launch of the quantize kernel (see ``_quant_plan``)."""
    variant: str      # "tiny", "cooperative", "flat", "nchw", "nchw_static"
    grid: int         # blocks
    threads: int      # threads a block
    numel: int        # elements of x
    elem_size: int    # bytes an element (4 float32, 2 bfloat16)
    stash_chunks: int  # QUANT_CHUNK-byte chunks of x a block keeps on chip
    ring: int         # ring chunks of a streamed slice (0: none)
    smem_bytes: int   # dynamic shared memory of a block
    reread: int       # elements read from device memory (or the L2) twice

    @property
    def cooperative(self) -> bool:
        """Launched cooperatively: a dynamic scale over more than one
        block meets at a grid barrier."""
        return self.variant in ("cooperative", "nchw") and self.grid > 1

    @property
    def units(self) -> int:
        """QUANT_UNIT-element units of x that the blocks' slices cover (a
        dynamic channels_last variant; the rest, the tail, is the last
        block's)."""
        return self.numel // QUANT_UNIT

    def block_slice(self, b: int) -> tuple[int, int]:
        """The elements [begin, end) of block ``b``'s slice, as the kernel
        takes them (dynamic channels_last variants)."""
        return (self.units * b // self.grid * QUANT_UNIT,
                self.units * (b + 1) // self.grid * QUANT_UNIT)

    def stashed(self, b: int) -> int:
        """Elements of block ``b``'s slice that its stash keeps on chip."""
        begin, end = self.block_slice(b)
        return min(end - begin,
                   self.stash_chunks * QUANT_CHUNK // self.elem_size)


def _quant_smem(stash_chunks: int, ring: int) -> int:
    """A channels_last block's dynamic shared memory: the mbarriers, the
    stash and the ring."""
    return QUANT_BARRIER_BYTES + (stash_chunks + ring) * QUANT_CHUNK


def _quant_plan(numel: int, elem_size: int, layout: str, dynamic: bool,
                sms: int = SMS) -> QuantPlan:
    """The launch plan of ``quantize_act``'s kernel for an input of
    ``numel`` elements of ``elem_size`` bytes in ``layout``
    ("channels_last" or "nchw"), with a dynamic or a static scale, on a
    card of ``sms`` SMs:

    - channels_last, dynamic: ``tiny`` (at most TINY_QUANT_BYTES: one
      block, no grid barrier) or ``cooperative``: one block an SM at most,
      each a contiguous slice of whole QUANT_UNIT-element units of at
      least QUANT_MIN_SLICE bytes. A slice of up to QUANT_MAX_STASH
      chunks is kept whole on chip; a larger one keeps what fits beside a
      ring of QUANT_RING chunks and streams the rest, which pass 2 reads
      again (``reread``, with the tail of fewer than QUANT_UNIT elements,
      which the last block reads twice from device memory).
    - channels_last, static: ``flat``, a plain grid-stride loop of
      LOOP_THREADS-thread blocks over x's 16-byte vectors, QUANT_PAIR a
      thread an iteration, at most QUANT_BLOCKS blocks (nothing is read
      twice).
    - NCHW-contiguous: ``nchw`` (dynamic: a flat max, the grid barrier,
      the quantize, at most one block an SM; x read twice) or
      ``nchw_static`` (a plain grid-stride loop over the pixels)."""
    if layout not in ("channels_last", "nchw") or elem_size not in (2, 4):
        raise ValueError(f"_quant_plan: layout {layout!r}, {elem_size}-byte "
                         f"elements")
    nbytes = numel * elem_size
    body_bytes = numel // QUANT_UNIT * QUANT_UNIT * elem_size
    if layout == "nchw":
        if dynamic:
            grid = min(sms, max(1, -(-numel // QUANT_THREADS)))
            return QuantPlan("nchw", grid, QUANT_THREADS, numel, elem_size, 0,
                             0, 0, numel)
        grid = min(QUANT_BLOCKS, max(1, -(-numel // LOOP_THREADS)))
        return QuantPlan("nchw_static", grid, LOOP_THREADS, numel, elem_size,
                         0, 0, 0, 0)
    if not dynamic:
        vectors = max(1, nbytes // 16)
        grid = min(QUANT_BLOCKS, -(-vectors // (LOOP_THREADS * QUANT_PAIR)))
        return QuantPlan("flat", grid, LOOP_THREADS, numel, elem_size, 0, 0,
                         0, 0)
    if nbytes <= TINY_QUANT_BYTES:
        grid = 1
    else:
        grid = min(sms, -(-body_bytes // QUANT_MIN_SLICE))
    units = numel // QUANT_UNIT
    widest = -(-units // grid) * QUANT_UNIT * elem_size  # bytes of a slice
    need = -(-widest // QUANT_CHUNK)  # its chunks
    stash, ring = need, 0
    if stash > QUANT_MAX_STASH:
        ring = QUANT_RING
        stash = 0
        while _quant_smem(stash + 1, ring) <= _quant_smem(QUANT_MAX_STASH, 0):
            stash += 1
    stash_elems = stash * QUANT_CHUNK // elem_size
    reread = numel - units * QUANT_UNIT + sum(
        max(0, (units * (b + 1) // grid - units * b // grid) * QUANT_UNIT
            - stash_elems) for b in range(grid))
    return QuantPlan("tiny" if grid == 1 else "cooperative", grid,
                     QUANT_THREADS, numel, elem_size, stash, ring,
                     _quant_smem(stash, ring), reread)


COUNTER_WORDS = 4096  # the least length of a kernel's counter buffer


def _counters(device: torch.device, n: int, kernel: str) -> torch.Tensor:
    """At least ``n`` int32 arrival counters of ``kernel`` on ``device``,
    zero between launches (the last block of a launch resets what it
    counted, and the quantize's grid barrier leaves its generation word
    ready for the next launch). One buffer per kernel and device, for the
    launches of one stream at a time, kept for the process's life: a CUDA
    graph replays its launches on the buffer it was captured with, so a
    buffer is never made or regrown while a stream is being captured
    (``prepare_capture`` makes them before)."""
    key = (kernel, str(device))
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        if (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing()):
            raise RuntimeError(
                f"{kernel}: its counter buffer on {device} would be made "
                f"inside a CUDA graph capture; call prepare_capture first")
        buf = torch.zeros(max(n, COUNTER_WORDS), dtype=torch.int32,
                          device=device)
        _COUNTERS[key] = buf
    return buf


def prepare_capture(device) -> None:
    """Make the kernels' counter buffers on ``device`` before a CUDA graph
    is captured there (``_counters``). A conv that splits K over more
    tiles than COUNTER_WORDS would still need a larger one: the capture
    then raises."""
    for kernel in ("quantize", "absmax", "conv"):
        _counters(torch.device(device), 1, kernel)


def act_absmax(x: torch.Tensor, *, relu: bool = False) -> torch.Tensor:
    """(2,) float32 on x's device: [max|x|, max(max|x|, 1e-8) / 127], the
    dynamic scale's two numbers (of ``F.relu(x)`` with ``relu``). A CUDA
    tensor (float32 or bfloat16, 4-D, dense) takes one launch of the
    kernel and no host synchronisation; a CPU tensor gets
    ``act_absmax_reference``. ``calibrate_acts`` and ``grid_quantize``
    read it; one-device serving does not (``quantize_act`` finds the
    dynamic scale in its own launch)."""
    if x.device.type == "cpu":
        return act_absmax_reference(x, relu=relu)
    _check_act(x, "act_absmax")
    lib = _quant_library()
    if not (x.is_contiguous()
            or x.is_contiguous(memory_format=torch.channels_last)):
        x = x.contiguous(memory_format=torch.channels_last)
    n = x.numel()
    per = 16 // x.element_size()
    blocks = max(1, min(ABSMAX_BLOCKS,
                        -(-max(n // per, 1) // LOOP_THREADS)))
    stats = torch.empty(2, dtype=torch.float32, device=x.device)
    partials = torch.empty(blocks, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.npp_act_absmax(
            x.data_ptr(), _ACT_DTYPE[x.dtype], n, int(x.data_ptr() % 16 == 0),
            int(relu), partials.data_ptr(),
            _counters(x.device, 1, "absmax").data_ptr(), stats.data_ptr(),
            blocks, stream)
    if err != 0:
        raise RuntimeError(f"act_absmax kernel launch failed: cudaError_t "
                           f"{err}")
    count_launch(act_absmax)
    return stats


act_absmax.launches = 0  # kernel launches, read by chip_smoke.py
act_absmax.captured = 0  # calls recorded into CUDA graphs


def quantize_act(x: torch.Tensor, act_scale: torch.Tensor | None = None, *,
                 relu: bool = False):
    """(int8 x, NHWC-contiguous under an NCHW view; its float32 0-d scale
    on x's device). ``relu`` quantizes ``F.relu(x)``. ``act_scale`` None
    is the dynamic scale; a static one clips to +-127. A CUDA tensor
    (float32 or bfloat16, 4-D) takes one launch of the kernel, in
    ``_quant_plan``'s variant, with no host synchronisation (an unaligned
    or non-dense x is copied first); a CPU tensor gets
    ``quantize_act_reference``; any other device raises."""
    if x.device.type == "cpu":
        q, a_scale = quantize_act_reference(x, act_scale, relu=relu)
        if q.ndim == 4:
            q = q.contiguous(memory_format=torch.channels_last)
        return q, a_scale
    _check_act(x, "quantize_act")
    if x.numel() == 0:
        raise ValueError("quantize_act: an empty input")
    lib = _quant_library()  # builds (or raises) before any device work
    if x.is_contiguous(memory_format=torch.channels_last):
        layout = "channels_last"
    elif x.is_contiguous():
        layout = "nchw"
    else:
        x, layout = x.contiguous(memory_format=torch.channels_last), \
            "channels_last"
    if x.data_ptr() % 16:  # the kernel's 16-byte loads and bulk copies
        x = x.clone(memory_format=torch.channels_last
                    if layout == "channels_last" else torch.contiguous_format)
    n, c, h, w = x.shape
    dev = x.device
    plan = _quant_plan(x.numel(), x.element_size(), layout,
                       act_scale is None, sms=_sm_count(dev))
    if act_scale is None:
        a_scale = torch.empty((), dtype=torch.float32, device=dev)
    else:
        a_scale = act_scale.to(device=dev, dtype=torch.float32).reshape(())
    q = torch.empty((n, h, w, c), dtype=torch.int8, device=dev)
    sync = _counters(dev, 5, "quantize") if plan.cooperative else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.npp_quantize_act(
            x.data_ptr(), _ACT_DTYPE[x.dtype], QUANT_VARIANT_CODE[plan.variant],
            x.numel(), c, h * w, int(relu), a_scale.data_ptr(), q.data_ptr(),
            None if sync is None else sync.data_ptr(), plan.grid,
            plan.stash_chunks, plan.ring, plan.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(f"quantize_act kernel launch failed "
                           f"({plan.variant}, grid {plan.grid}): cudaError_t "
                           f"{err}")
    count_launch(quantize_act)
    return q.permute(0, 3, 1, 2), a_scale


quantize_act.launches = 0  # kernel launches, read by chip_smoke.py
quantize_act.captured = 0  # calls recorded into CUDA graphs


def grid_quantize(x: torch.Tensor, group, *, relu: bool = False):
    """``quantize_act`` with the dynamic scale of the whole activation of
    which ``x`` is this rank's part (a data shard, a row window): the
    absmax of x (``act_absmax``, one launch on a card), its max over the
    ranks of ``group`` (one MAX all-reduce, ``mesh.all_max``), then the
    static quantize with that scale (one launch). Returns what
    ``quantize_act(X, relu=relu)`` returns for the gathered X, restricted
    to x, bit for bit:

    - the scale. The all-reduce takes the max of both numbers of
      ``act_absmax``, [max|x|, max(max|x|, 1e-8) / 127], and the second
      is a nondecreasing function of the first (a clamp and a division
      by a positive constant, each rounded to nearest, which keeps
      order), so the max of the ranks' scales is the scale of the
      grid's max, formed by the same arithmetic as the one-device
      dynamic scale (on a card its multiply by RN(1/127), on the CPU
      its division; ``quantize_act_reference``);
    - the int8 values. The static variant divides by that scale and
      rounds as the dynamic one does, and then clips to +-127, which
      cannot bite here: every |x| is at most the grid's max A, and
      A / RN(A / 127) stays within a few units in the last place of 127,
      far below 127.5 (below the 1e-8 floor, |x| / scale < 127).

    Rows that a window shares with a neighbour (halos) are the
    neighbour's values, and the image's padding is zeros, so neither
    moves the max."""
    return quantize_act(x, grid_absmax(x, group, relu=relu)[1], relu=relu)


def grid_absmax(x: torch.Tensor, group, *, relu: bool = False
                ) -> torch.Tensor:
    """``act_absmax`` of ``x``, and with a ``group`` its max over the
    group's ranks (one MAX all-reduce): the two numbers of the dynamic
    scale of the whole activation (``grid_quantize``)."""
    stats = act_absmax(x, relu=relu)
    return stats if group is None else all_max(stats, group)


def _out_size(size: int, k: int, stride: int, pad: int, dil: int) -> int:
    return (size + 2 * pad - dil * (k - 1) - 1) // stride + 1


def conv_s8_reference(q_x, qweight, w_scale, a_scale, bias, *, kernel_size,
                      stride=(1, 1), padding=(0, 0), dilation=(1, 1),
                      out_dtype=torch.float32):
    """Plain version of ``conv_s8``. The int8 values go through
    ``F.conv2d`` in float64, which is exact (|sum| <= K * 127^2, far
    below 2^53), and are cast to int32; with ``out_dtype`` int32 that is
    the result, else the fp32 epilogue follows, op by op as npp_tpu's."""
    kh, kw = kernel_size
    cout = qweight.shape[0]
    w = qweight.reshape(cout, kh, kw, -1).permute(0, 3, 1, 2)
    with torch.autocast(q_x.device.type, enabled=False):
        acc = F.conv2d(q_x.to(torch.float64), w.to(torch.float64), None,
                       stride, padding, dilation).to(torch.int32)
    if out_dtype == torch.int32:
        return acc
    out = acc.to(torch.float32) * (a_scale * w_scale)[None, :, None, None]
    if bias is not None:
        out = out + bias.to(torch.float32)[None, :, None, None]
    return out.to(out_dtype)


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """One launch of the int8 conv kernel (see ``_conv_plan``)."""
    variant: str      # "wgmma", "wgmma_tma", "packed" or "tiny_m"
    bn: int           # output channels per block tile (wgmma's N)
    stages: int       # ring depth (stages of STAGE_K bytes of K)
    splits: int       # K splits, each a run of whole stages
    m: int            # output pixels, N * Ho * Wo
    k: int            # kh * kw * Cin
    m_tiles: int
    n_tiles: int
    k_stages: int     # ceil(K / STAGE_K)
    units: int        # work units: m_tiles * n_tiles * splits
    grid: tuple       # the launch's blocks (persistent: at most one an SM)
    smem_bytes: int   # dynamic shared memory of a block

    @property
    def name(self) -> str:
        """The variant, with its split: e.g. "wgmma/128", "wgmma/64x4k"."""
        if self.variant == "tiny_m":
            return "tiny_m"
        split = f"x{self.splits}k" if self.splits > 1 else ""
        return f"{self.variant}/{self.bn}{split}"

    def split_range(self, s: int) -> tuple[int, int]:
        """The K stages [begin, end) of split ``s``, as the kernel takes
        them."""
        return (s * self.k_stages // self.splits,
                (s + 1) * self.k_stages // self.splits)


def _smem_bytes(bn: int, stages: int) -> int:
    """A block's dynamic shared memory: the ring, the epilogue's staging
    and column table, the full and empty barriers and a flag, and the
    slack that aligns the ring to 1,024 bytes."""
    return (stages * (TILE_M + bn) * STAGE_K + STAGING_BYTES + TABLE_BYTES
            + 16 * stages + 1040)


# The plan's cost model, in us, rough times fit to chip_smoke.py phase
# 20a's per-class times on an H100 SXM (PERF.md): a ring stage of 128
# bytes of K for a tile of each width, a work unit's fixed cost (its
# first load, its epilogue), and a split unit's partial-tile exchange,
# which grows with the partials the last unit reads.
STAGE_US = {64: 0.7, 128: 0.85, 256: 1.3}
UNIT_US = 1.5
SPLIT_US = 1.5
SPLIT_READ_US = 0.3


def _plan_cost(units: int, stages_a_unit: int, bn: int, splits: int,
               sms: int) -> float:
    rounds = -(-units // sms)
    split = SPLIT_US + SPLIT_READ_US * splits * bn / 128 if splits > 1 else 0
    return rounds * (stages_a_unit * STAGE_US[bn] + UNIT_US + split)


def _conv_plan(n: int, h: int, w: int, cin: int, cout: int,
               kernel_size=(1, 1), stride=(1, 1), padding=(0, 0),
               dilation=(1, 1), sms: int = SMS) -> ConvPlan:
    """The launch plan of ``conv_s8``'s kernel for one conv, from its
    shapes and the card's SM count:

    - ``tiny_m`` for at most TINY_M output pixels of a 1x1, stride-1,
      unpadded conv with Cin a multiple of 4 (a warp per output channel);
    - ``packed`` where Cin is not a multiple of 16 (K packed as (r, s, c),
      a 64-wide tile, K unsplit);
    - else ``wgmma``, or ``wgmma_tma`` where A too can come by TMA as B
      does (a 1x1, stride-1, unpadded conv, whose A is x itself as an
      (M, Cin) matrix; or a stride-1 conv with Cin a multiple of STAGE_K
      whose output tiles into PATCH_H x PATCH_W patches, a 4-D box of x
      for each tap), with the tile width (64, 128, or 256 where Cout is a
      multiple of 256) and the K split that ``_plan_cost`` puts lowest:
      the rounds of at most ``sms`` work units, each its K stages and
      fixed costs. The split is the small levels' tool: only where a
      width's tiles are fewer than the SMs does it split K, to fill the
      card, and a split that would need a second round costs more than it
      saves.
    The grid is persistent: min(units, sms) blocks, each walking units
    sms apart. The ring holds up to RING_MAX stages within the shared
    memory a block may use."""
    (kh, kw), (sh, sw), (ph, pw), (dh, dw) = (kernel_size, stride, padding,
                                              dilation)
    ho = _out_size(h, kh, sh, ph, dh)
    wo = _out_size(w, kw, sw, pw, dw)
    m, k = n * ho * wo, kh * kw * cin
    k_stages = -(-k // STAGE_K)
    m_tiles = -(-m // TILE_M)
    if (m <= TINY_M and (kh, kw) == (1, 1) and (sh, sw) == (1, 1)
            and (ph, pw) == (0, 0) and cin % 4 == 0):
        blocks = -(-cout // 8)
        return ConvPlan("tiny_m", 8, 0, 1, m, k, 1, blocks, k_stages, blocks,
                        (blocks, 1, 1), 0)
    packed = cin % 16 != 0
    widths = [64]
    if not packed and cout > 64:
        widths.append(128)
        if cout % 256 == 0:
            widths.append(256)
    best = None
    for bn in widths:
        tiles = m_tiles * -(-cout // bn)
        top = 1 if packed or tiles >= sms else min(k_stages, 32)
        for splits in range(1, top + 1):
            cost = _plan_cost(tiles * splits, -(-k_stages // splits), bn,
                              splits, sms)
            if best is None or cost < best[0] - 1e-9:
                best = (cost, bn, splits)
    _, bn, splits = best
    stages = RING_MAX
    while _smem_bytes(bn, stages) > SMEM_BLOCK_LIMIT:
        stages -= 1
    n_tiles = -(-cout // bn)
    units = m_tiles * n_tiles * splits
    direct = (kh, kw) == (1, 1) and (sh, sw) == (1, 1) and (ph, pw) == (0, 0)
    patches = (cin % STAGE_K == 0 and (sh, sw) == (1, 1)
               and ho % PATCH_H == 0 and wo % PATCH_W == 0)
    variant = ("packed" if packed else
               "wgmma_tma" if direct or patches else "wgmma")
    return ConvPlan(variant, bn, stages, splits, m, k,
                    m_tiles, n_tiles, k_stages, units,
                    (min(units, sms), 1, 1), _smem_bytes(bn, stages))


def build_conv() -> tuple[Path, str]:
    """``csrc/int8_conv.cu`` through ``heatmaps.nvcc_build``."""
    return nvcc_build(_CSRC, "libint8_conv")


def build_quantize() -> tuple[Path, str]:
    """``csrc/int8_quantize.cu`` through ``heatmaps.nvcc_build``."""
    return nvcc_build(_QSRC, "libint8_quantize")


def _library() -> ctypes.CDLL:
    if "conv" not in _LIBRARY:
        path, _ = build_conv()
        lib = ctypes.CDLL(str(path))
        fn = lib.npp_int8_conv
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 22 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIBRARY["conv"] = lib
    return _LIBRARY["conv"]


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def conv_s8(q_x, qweight, w_scale, a_scale, bias, *, kernel_size,
            stride=(1, 1), padding=(0, 0), dilation=(1, 1),
            out_dtype=torch.float32):
    """int8 (N, Cin, H, W) input and int8 (Cout, kh * kw * Cin) weights ->
    (N, Cout, Ho, Wo) ``out_dtype`` (float32, bfloat16, or int32 for the
    raw accumulators), channels_last. CUDA tensors go to the kernel, in
    ``_conv_plan``'s launch, CPU tensors to ``conv_s8_reference``; any
    other device raises."""
    kw_ = dict(kernel_size=kernel_size, stride=stride, padding=padding,
               dilation=dilation, out_dtype=out_dtype)
    if q_x.device.type == "cpu":
        return conv_s8_reference(q_x, qweight, w_scale, a_scale, bias, **kw_)
    if q_x.device.type != "cuda":
        raise ValueError(f"conv_s8: input on {q_x.device}")
    if q_x.dtype != torch.int8 or qweight.dtype != torch.int8:
        raise ValueError("conv_s8: int8 input and weights")
    if out_dtype not in _OUT_KIND:
        raise ValueError(f"conv_s8: out_dtype {out_dtype}")
    n, cin, h, w = q_x.shape
    kh, kw = kernel_size
    cout = qweight.shape[0]
    if tuple(qweight.shape) != (cout, kh * kw * cin):
        raise ValueError(f"conv_s8: weights {tuple(qweight.shape)} for "
                         f"Cin={cin} and a {kh}x{kw} kernel")
    ho = _out_size(h, kh, stride[0], padding[0], dilation[0])
    wo = _out_size(w, kw, stride[1], padding[1], dilation[1])
    if min(ho, wo) <= 0:
        raise ValueError("conv_s8: empty output")
    if max(q_x.numel(), n * ho * wo * cout) >= 2**31:
        raise ValueError("conv_s8: tensors over 2^31 elements")
    lib = _library()
    dev = q_x.device
    x_nhwc = q_x.permute(0, 2, 3, 1).contiguous()  # a view if channels_last
    qweight = qweight.contiguous()
    w_scale = w_scale.to(device=dev, dtype=torch.float32).contiguous()
    a_scale = a_scale.to(device=dev, dtype=torch.float32).reshape(1)
    if bias is not None:
        bias = bias.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty((n, ho, wo, cout), dtype=out_dtype, device=dev)
    if x_nhwc.data_ptr() % 16 or qweight.data_ptr() % 16:
        raise RuntimeError("conv_s8: the kernel's vector loads need "
                           "16-byte aligned operands")
    plan = _conv_plan(n, h, w, cin, cout, kernel_size, stride, padding,
                      dilation, sms=_sm_count(dev))
    partial = counters = None
    if plan.splits > 1:
        tiles = plan.m_tiles * plan.n_tiles
        partial = torch.empty(tiles * plan.splits * TILE_M * plan.bn,
                              dtype=torch.int32, device=dev)
        counters = _counters(dev, tiles, "conv")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.npp_int8_conv(
            x_nhwc.data_ptr(), qweight.data_ptr(), w_scale.data_ptr(),
            a_scale.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), None if partial is None else partial.data_ptr(),
            None if counters is None else counters.data_ptr(),
            n, h, w, cin, cout, ho, wo, kh, kw, stride[0],
            stride[1], padding[0], padding[1], dilation[0], dilation[1],
            _OUT_KIND[out_dtype], VARIANT_CODE[plan.variant], plan.bn,
            plan.stages, plan.splits, plan.smem_bytes, plan.grid[0], stream)
    if err != 0:
        raise RuntimeError(f"int8_conv kernel launch failed ({plan.name}): "
                           f"error {err}")
    count_launch(conv_s8)
    return out.permute(0, 3, 1, 2)


conv_s8.launches = 0  # kernel launches, read by chip_smoke.py
conv_s8.captured = 0  # calls recorded into CUDA graphs


class Int8Conv2d(nn.Conv2d):
    """A dense ``nn.Conv2d`` served through ``int8_conv``, with the same
    parameter tensors and ``state_dict``. ``prepare_int8`` makes these;
    ``calibrating`` (set by ``calibrate_acts``) records the running
    absmax of the inputs in ``act_absmax``. ``forward(x, relu=True)``
    (and ``_conv_forward(..., relu=True)``, the conv alone) is the conv of
    ``F.relu(x)`` with the ReLU folded into the quantize (``relu_conv``).
    ``scale_group``: the ranks over which a dynamic scale is taken (None:
    this process alone; module docstring)."""

    calibrating = False
    scale_group = None

    def forward(self, x, relu=False):
        return self._conv_forward(x, self.weight, self.bias, relu=relu)

    def _tracing(self) -> bool:
        """Whether this call belongs to a split model's plan trace (whose
        outputs are thrown away: it takes no collective and records no
        calibration)."""
        return False

    def _conv_forward(self, x, weight, bias, relu=False, seen=None):
        """``seen``: the rank's part of what the dynamic scale is the max
        of, where that is not ``x`` (``FactorizedReduce``'s shifted branch
        on a row window)."""
        if self.act_scale is not None and not self.calibrating:
            return int8_conv(x, self, act_scale=self.act_scale, relu=relu)
        tracing = self._tracing()
        group = None if tracing else self.scale_group
        record = self.calibrating and not tracing
        if group is None and not record:
            return int8_conv(x, self, relu=relu)
        stats = grid_absmax((x if seen is None else seen).detach(), group,
                            relu=relu)
        if record:
            self.act_absmax = torch.maximum(self.act_absmax, stats[0])
        # The static quantize with the dynamic scale: grid_quantize's
        # arithmetic, equal to the dynamic quantize's bit for bit.
        return int8_conv(x, self, act_scale=stats[1], relu=relu)


# The int8 class that ``prepare_int8`` gives each dense conv class
# (``parallel/spatial.py`` adds its row-window conv's).
INT8_CONVS: dict[type, type] = {nn.Conv2d: Int8Conv2d}


def folds_relu(conv: nn.Module) -> bool:
    """Whether ``conv`` folds a ReLU on its input into its activation
    quantize (``conv._conv_forward(x, weight, bias, relu=True)``): a
    prepared ``Int8Conv2d``."""
    return isinstance(conv, Int8Conv2d)


def relu_conv(conv: nn.Module, x: torch.Tensor, *,
              weight_dtype: bool = False) -> torch.Tensor:
    """``conv(F.relu(x))``; with ``weight_dtype``, in the conv's weights'
    dtype with autocast off (the heads' last convs). A prepared
    ``Int8Conv2d`` takes x as it is and folds the ReLU into its activation
    quantize (one pass over x on the card; the ReLU commutes with the
    cast); any other conv runs ``F.relu`` and itself, as before."""
    fold = folds_relu(conv)
    if not fold:
        x = F.relu(x)
    with (torch.autocast(device_type=x.device.type, enabled=False)
          if weight_dtype else contextlib.nullcontext()):
        if weight_dtype:
            x = x.to(conv.weight.dtype)
        return conv(x, relu=True) if fold else conv(x)


def _out_dtype(x: torch.Tensor) -> torch.dtype:
    t = x.device.type
    if torch.is_autocast_enabled(t):
        return torch.get_autocast_dtype(t)
    return x.dtype


def _s8_args(conv: nn.Conv2d, x: torch.Tensor) -> dict:
    return dict(kernel_size=conv.kernel_size, stride=conv.stride,
                padding=conv.padding, dilation=conv.dilation,
                out_dtype=_out_dtype(x))


def _bias(conv: nn.Conv2d):
    return None if conv.bias is None else conv.bias.detach()


def int8_conv(x, conv: Int8Conv2d, *, act_scale=None, relu=False):
    """The conv of ``x`` (of ``F.relu(x)`` with ``relu``) by the prepared
    ``conv`` in int8: the kernels on a CUDA tensor, the plain versions on
    a CPU one. No gradient flows."""
    q_x, a_scale = quantize_act(x, act_scale, relu=relu)
    return conv_s8(q_x, conv.qweight, conv.wscale, a_scale, _bias(conv),
                   **_s8_args(conv, x))


def int8_conv_reference(x, conv: Int8Conv2d, *, act_scale=None,
                        relu=False):
    """``int8_conv`` through the plain versions on any device."""
    q_x, a_scale = quantize_act_reference(x, act_scale, relu=relu)
    return conv_s8_reference(q_x, conv.qweight, conv.wscale, a_scale,
                             _bias(conv), **_s8_args(conv, x))


def _set_qweight(conv: Int8Conv2d) -> None:
    q, w_scale = quantize_weight(conv.weight)
    conv.register_buffer("qweight", q.permute(0, 2, 3, 1).reshape(
        q.shape[0], -1).contiguous(), persistent=False)
    conv.register_buffer("wscale", w_scale, persistent=False)


def is_int8(model: nn.Module) -> bool:
    return any(isinstance(m, Int8Conv2d) for m in model.modules())


def prepare_int8(model: nn.Module, grid=None) -> nn.Module:
    """Serve ``model``'s dense convs in int8, in place: each dense conv
    (groups 1) becomes its ``INT8_CONVS`` class on the same parameters
    (an ``nn.Conv2d`` an ``Int8Conv2d``; the ``ShardedConv2d`` of a model
    that ``parallel.spatial.convert_spatial`` split over rows a
    ``ShardedInt8Conv2d``), with its weights quantized now (again, for
    one that is already prepared: after the weights change, call it
    again). Activation scales start dynamic, taken over the ranks of
    ``grid`` (a ``mesh.make_grid`` grid; None: this process alone; module
    docstring). A model split over rows needs the grid it was split over.
    A model split over a model axis (``parallel.tensor``) is refused:
    npp_tpu has no such int8 path."""
    if getattr(model, "_tp", None) is not None or (
            grid is not None and grid.n_model > 1):
        raise ValueError("int8 serving runs on one device or a data x "
                         "space grid; this model is split over a grid's "
                         "model axis (tensor parallel)")
    sharding = getattr(model, "_sharding", None)
    if sharding is not None and sharding.grid is not grid:
        raise ValueError("prepare_int8: the model is split over rows; pass "
                         "the grid it was converted for")
    group = None if grid is None else multi_rank(grid.world)

    def convert(module):
        for name, child in module.named_children():
            if type(child) in INT8_CONVS and child.groups == 1:
                child.__class__ = INT8_CONVS[type(child)]
                child.register_buffer("act_scale", None, persistent=False)
            convert(child)

    convert(model)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Int8Conv2d):
                _set_qweight(m)
                m.scale_group = group
    return model


@torch.inference_mode()
def calibrate_acts(model: nn.Module, batches) -> nn.Module:
    """Static activation scales for a prepared ``model``: its int8 forward
    (dynamic scales) over ``batches`` (model inputs) records each dense
    conv input's running absmax (of ``F.relu(x)`` where the conv folds
    the ReLU in: what it quantizes); each conv's ``act_scale`` becomes
    max(absmax, 1e-8) / 127. On a grid every rank runs its part of each
    batch, and each call's absmax is the grid's (the dynamic scale's
    all-reduce), so every rank ends with the same scales, npp_tpu's one
    replicated tree. Returns ``model``."""
    convs = [m for m in model.modules() if isinstance(m, Int8Conv2d)]
    if not convs:
        raise ValueError("calibrate_acts needs a model prepared by "
                         "prepare_int8")
    for m in convs:
        m.calibrating = True
        m.act_absmax = torch.zeros((), dtype=torch.float32,
                                   device=m.weight.device)
    seen = 0
    try:
        for x in batches:
            model(x)
            seen += 1
    finally:
        for m in convs:
            m.calibrating = False
    if not seen:
        raise ValueError("calibrate_acts needs at least one batch")
    for m in convs:
        m.act_scale = torch.clamp(m.act_absmax, min=1e-8) / 127.0
        del m.act_absmax
    return model
