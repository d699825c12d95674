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

- ``quantize_weight``: max(max|w|, 1e-8) / 127 per output channel over
  dims (1, 2, 3) of OIHW, then round half to even (``torch.round``, as
  ``jnp.round``).
- ``quantize_act``: dynamic, max(max|x|, 1e-8) / 127 over the tensor; or
  static, with the product clipped to +-127.
- ``conv_s8`` (the hand-written kernel ``csrc/int8_conv.cu`` on a CUDA
  tensor, built with ``nvcc`` for ``sm_90a`` at its first launch into
  ``npp_tpu_torch/_build/`` and called through ctypes; a failed build or
  launch raises) and ``conv_s8_reference`` (its plain version, which a
  CPU tensor gets): the int8 conv of quantized operands with the fp32
  epilogue float(acc) * (a_scale * w_scale) + bias, in that order.
- ``int8_conv(x, conv)`` = ``quantize_act`` + ``conv_s8``;
  ``int8_conv_reference`` = ``quantize_act`` + ``conv_s8_reference``.

The output dtype follows npp_tpu's ``out_dtype = self.dtype or x.dtype``:
the autocast dtype where autocast is on (bf16 in the serving forward),
else the input's (float32 for the heads' last convs, which run with
autocast off). Importing this module builds nothing.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch
import torch.nn as nn
import torch.nn.functional as F

from npp_tpu_torch.ops.heatmaps import nvcc_build

_CSRC = Path(__file__).resolve().parent / "csrc" / "int8_conv.cu"
_LIBRARY: dict = {}  # the loaded ctypes library, once built
_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}


def quantize_weight(weight: torch.Tensor):
    """OIHW float weight -> (int8 OIHW, float32 scale (Cout,)) with
    q * scale ~= weight."""
    wf = weight.detach().to(torch.float32)
    w_scale = torch.clamp(wf.abs().amax(dim=(1, 2, 3)), min=1e-8) / 127.0
    q = torch.round(wf / w_scale[:, None, None, None]).to(torch.int8)
    return q, w_scale


def quantize_act(x: torch.Tensor, act_scale: torch.Tensor | None = None):
    """(int8 x in x's layout, its float32 0-d scale). ``act_scale`` None
    is the dynamic scale; a static one clips to +-127. The divisor is a
    tensor: a Python-scalar divisor would let PyTorch's CUDA division
    multiply by its reciprocal, another rounding than npp_tpu's."""
    xf = x.to(torch.float32)
    if act_scale is None:
        a_scale = torch.clamp(xf.abs().amax(), min=1e-8) / 127.0
        q = torch.round(xf / a_scale)
    else:
        a_scale = act_scale.to(torch.float32)
        q = torch.clamp(torch.round(xf / a_scale), -127.0, 127.0)
    return q.to(torch.int8), a_scale


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


def build_kernels() -> tuple[Path, str]:
    """``csrc/int8_conv.cu`` through ``heatmaps.nvcc_build``."""
    return nvcc_build(_CSRC, "libint8_conv")


def _library() -> ctypes.CDLL:
    if "lib" not in _LIBRARY:
        path, _ = build_kernels()
        lib = ctypes.CDLL(str(path))
        fn = lib.npp_int8_conv
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 16 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIBRARY["lib"] = lib
    return _LIBRARY["lib"]


def conv_s8(q_x, qweight, w_scale, a_scale, bias, *, kernel_size,
            stride=(1, 1), padding=(0, 0), dilation=(1, 1),
            out_dtype=torch.float32):
    """int8 (N, Cin, H, W) input and int8 (Cout, kh * kw * Cin) weights ->
    (N, Cout, Ho, Wo) ``out_dtype`` (float32, bfloat16, or int32 for the
    raw accumulators), channels_last. CUDA tensors go to the kernel, CPU
    tensors to ``conv_s8_reference``; any other device raises."""
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
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.npp_int8_conv(
            x_nhwc.data_ptr(), qweight.data_ptr(), w_scale.data_ptr(),
            a_scale.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), n, h, w, cin, cout, ho, wo, kh, kw, stride[0],
            stride[1], padding[0], padding[1], dilation[0], dilation[1],
            _OUT_KIND[out_dtype], stream)
    if err != 0:
        raise RuntimeError(f"int8_conv kernel launch failed: cudaError_t "
                           f"{err}")
    conv_s8.launches += 1
    return out.permute(0, 3, 1, 2)


conv_s8.launches = 0  # kernel launches, read by chip_smoke.py


class Int8Conv2d(nn.Conv2d):
    """A dense ``nn.Conv2d`` served through ``int8_conv``, with the same
    parameter tensors and ``state_dict``. ``prepare_int8`` makes these;
    ``calibrating`` (set by ``calibrate_acts``) records the running
    absmax of the inputs in ``act_absmax``."""

    calibrating = False

    def _conv_forward(self, x, weight, bias):
        if self.calibrating:
            self.act_absmax = torch.maximum(
                self.act_absmax, x.detach().to(torch.float32).abs().amax())
            return int8_conv(x, self)
        return int8_conv(x, self, act_scale=self.act_scale)


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


def int8_conv(x, conv: Int8Conv2d, *, act_scale=None):
    """The conv of ``x`` by the prepared ``conv`` in int8: the kernel on a
    CUDA tensor, the plain version on a CPU one. No gradient flows."""
    q_x, a_scale = quantize_act(x, act_scale)
    return conv_s8(q_x, conv.qweight, conv.wscale, a_scale, _bias(conv),
                   **_s8_args(conv, x))


def int8_conv_reference(x, conv: Int8Conv2d, *, act_scale=None):
    """``int8_conv`` through the plain version on any device."""
    q_x, a_scale = quantize_act(x, act_scale)
    return conv_s8_reference(q_x, conv.qweight, conv.wscale, a_scale,
                             _bias(conv), **_s8_args(conv, x))


def _set_qweight(conv: Int8Conv2d) -> None:
    q, w_scale = quantize_weight(conv.weight)
    conv.register_buffer("qweight", q.permute(0, 2, 3, 1).reshape(
        q.shape[0], -1).contiguous(), persistent=False)
    conv.register_buffer("wscale", w_scale, persistent=False)


def is_int8(model: nn.Module) -> bool:
    return any(isinstance(m, Int8Conv2d) for m in model.modules())


def prepare_int8(model: nn.Module) -> nn.Module:
    """Serve ``model``'s dense convs in int8, in place: each ``nn.Conv2d``
    with groups 1 becomes an ``Int8Conv2d`` on the same parameters, with
    its weights quantized now (again, for one that is already prepared:
    after the weights change, call it again). Activation scales start
    dynamic. A model split over a grid (``parallel.spatial`` /
    ``parallel.tensor``) is refused."""
    if (getattr(model, "_sharding", None) is not None
            or getattr(model, "_tp", None) is not None):
        raise ValueError("int8 serving runs an unsharded model; this one is "
                         "split over a grid (spatial or tensor parallel)")

    def convert(module):
        for name, child in module.named_children():
            if type(child) is nn.Conv2d and child.groups == 1:
                child.__class__ = Int8Conv2d
                child.register_buffer("act_scale", None, persistent=False)
            convert(child)

    convert(model)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Int8Conv2d):
                _set_qweight(m)
    return model


@torch.inference_mode()
def calibrate_acts(model: nn.Module, batches) -> nn.Module:
    """Static activation scales for a prepared ``model``: its int8 forward
    (dynamic scales) over ``batches`` (model inputs) records each dense
    conv input's running absmax; each conv's ``act_scale`` becomes
    max(absmax, 1e-8) / 127. Returns ``model``."""
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
