"""One-dispatch programs on a card: a function of a batch of tensors
captured once as a CUDA graph and replayed.

npp_tpu runs K train steps (``lax.scan`` in ``make_train_step_scanned``)
or a whole eval epoch (``make_eval_epoch``) as one XLA program, one
dispatch for many steps. The port's analog is a ``torch.cuda.CUDAGraph``
over static input buffers: ``Program(fn, inputs)`` warms ``fn`` up on a
side stream, captures one call of it on the static buffers, and each
call of the program copies its inputs into those buffers and replays the
graph. Only a CUDA device captures: the callers run the same body
eagerly on the CPU (the plain version), and a failed capture raises; it
never falls back to eager.

What a captured function must keep (the capture rules):

- no host synchronisation and no copy from pageable host memory: the
  constants it needs on the device are made before the capture and kept
  (``constant``);
- every tensor that outlives a replay and that the graph updates (the
  weights, Adam's moments and counts, the BN statistics, the lambdas'
  gradient sum) exists before the capture and is updated in place;
- every buffer a hand-written kernel keeps across launches exists before
  the capture (``ops/quantize.prepare_capture``);
- a value that changes from dispatch to dispatch (the learning rate) is
  an input, not a Python number baked in at capture.

The hand-written kernels count their launches where they launch
(``ops/heatmaps.count_launch``); a call recorded into a graph is counted
as ``captured`` instead. A replay launches the recorded kernels without
their wrappers and counts nothing: its launches are read from the
device's own record (``chip_smoke.py`` counts them by kernel name in a
profiled replay and holds them against ``Program.captured``).
"""
from __future__ import annotations

import time

import torch

from npp_tpu_torch.ops import heatmaps, quantize
from npp_tpu_torch.parallel import mesh

# The wrappers of the hand-written kernels whose launches are counted.
KERNELS = (heatmaps.render_heatmaps, quantize.conv_s8, quantize.quantize_act,
           quantize.act_absmax)

_CONSTANTS: dict = {}


def one_process(what: str, missing: str) -> None:
    """Raise where a process group is up: ``what`` runs in one process
    only, and ``missing`` names npp_tpu's path for a group, which is not
    ported (gloo's collectives cannot be captured into a CUDA graph)."""
    if mesh.data_group() is not None:
        raise ValueError(
            f"{what} runs in one process; under a process group (DDP, "
            f"--zero, a grid) it is not ported ({missing}): gloo's "
            f"collectives cannot be captured into a CUDA graph")


def constant(values, dtype, device) -> torch.Tensor:
    """``torch.as_tensor(values, dtype=dtype, device=device)``, made once
    per (values, dtype, device) and kept: a graph that uses it captures
    no copy from the host. ``values`` is a number or a (nested) tuple."""
    key = (values, dtype, str(device))
    t = _CONSTANTS.get(key)
    if t is None:
        t = torch.as_tensor(values, dtype=dtype, device=device)
        _CONSTANTS[key] = t
    return t


def stack(tensors) -> torch.Tensor:
    """``torch.stack`` on a new leading axis that keeps each tensor's
    layout: the slices of a stack of channels_last 4-D tensors are
    channels_last, so a step reads a stacked image as it reads the
    loader's (the convs' arithmetic follows the layout)."""
    t = tensors[0]
    if (t.dim() == 4 and not t.is_contiguous()
            and t.is_contiguous(memory_format=torch.channels_last)):
        return torch.stack([x.permute(0, 2, 3, 1) for x in tensors]
                           ).permute(0, 1, 4, 2, 3)
    return torch.stack(list(tensors))


class Program:
    """``fn(inputs) -> outputs`` (dicts of CUDA tensors) captured as one
    CUDA graph on static copies of ``inputs``.

    Before the capture: the kernels' counter buffers are made
    (``quantize.prepare_capture``), then ``warmup(static inputs)`` (by
    default ``fn`` itself) runs once on a side stream, which initialises
    the libraries' handles and workspaces and builds any kernel; the
    tensors in ``restore`` are copied back to what they held before it,
    so a warm-up that trains leaves no trace. ``capture_s`` and
    ``instantiate_s`` are the host seconds of the capture and of the
    graph's instantiation; ``captured`` holds each counted kernel's calls
    recorded into the graph (``KERNELS``), the launches of one replay."""

    def __init__(self, fn, inputs: dict, *, warmup=None, restore=()):
        device = next(iter(inputs.values())).device
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph captures CUDA tensors; the "
                             f"inputs are on {device}")
        self.inputs = {k: torch.empty_like(v) for k, v in inputs.items()}
        self.fill(inputs)
        quantize.prepare_capture(device)
        saved = [t.detach().clone() for t in restore]
        stream = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            (warmup or fn)(self.inputs)
        stream.wait_stream(side)
        with torch.no_grad():
            for t, s in zip(restore, saved):
                t.copy_(s)
        del saved
        torch.cuda.synchronize(device)
        before = [k.captured for k in KERNELS]
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        tic = time.perf_counter()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.outputs = fn(self.inputs)
        self.capture_s = time.perf_counter() - tic
        tic = time.perf_counter()
        self.graph.instantiate()
        torch.cuda.synchronize(device)
        self.instantiate_s = time.perf_counter() - tic
        self.captured = [k.captured - b for k, b in zip(KERNELS, before)]

    def fill(self, inputs: dict) -> None:
        """Copy ``inputs`` (the same keys and shapes) into the static
        buffers."""
        if inputs.keys() != self.inputs.keys():
            raise KeyError(f"inputs {sorted(inputs)} for a program of "
                           f"{sorted(self.inputs)}")
        for k, v in inputs.items():
            self.inputs[k].copy_(v, non_blocking=True)

    def __call__(self, inputs: dict) -> dict:
        """One dispatch: the inputs copied in, one replay. The outputs are
        the program's static tensors, overwritten by the next replay."""
        self.fill(inputs)
        self.graph.replay()
        return self.outputs
