"""Model cost summary: the parameter count and the FLOPs of a call.

Port of ``npp_tpu/utils/summary.py``. ``count_parameters`` counts the
elements of the model's parameters (``nn.Parameter``; buffers such as
BN's running statistics are not parameters, as they are not in flax's
``params``); ``count_parameters_in_mb`` is that count / 2^20, as
npp_tpu keeps it (elements, not bytes).

``model_flops(fn, *args)`` runs ``fn(*args)`` once under
``torch.utils.flop_counter.FlopCounterMode`` and returns its count. That
count holds the convolutions and matrix products only (their forward and,
where ``fn`` runs one, their backward), at 2 FLOPs a multiply-add, and a
conv counts its full window at every output (padding included). npp_tpu
reads XLA's cost analysis of the compiled program instead, which also
counts the elementwise ops, reductions and resizes and counts a padded
conv's window as XLA lowers it. The two differ by a few percent on
NPPNet; on a plain matrix product both are 2 * m * n * k.
"""
from __future__ import annotations

import torch
import torch.nn as nn
from torch.utils.flop_counter import FlopCounterMode


def count_parameters(model: nn.Module) -> int:
    """Elements in the model's parameters."""
    return int(sum(p.numel() for p in model.parameters()))


def count_parameters_in_mb(model: nn.Module) -> float:
    """The parameter count / 2^20 (elements, not bytes)."""
    return count_parameters(model) / (1024 * 1024)


def model_flops(fn, *args) -> float:
    """FLOPs of one call ``fn(*args)``: its convolutions and matrix
    products, 2 a multiply-add (see the module docstring)."""
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args)
    return float(counter.get_total_flops())


def get_model_summary(model: nn.Module, sample_input: torch.Tensor,
                      train: bool = False) -> dict:
    """npp_tpu's summary dict of ``model`` on ``sample_input``: ``params``,
    ``params_mb``, ``flops`` and ``gflops`` of one forward (in train or
    eval mode, without gradients; the model's mode is restored) and
    ``input_shape``."""
    was_training = model.training
    model.train(train)
    try:
        with torch.no_grad():
            flops = model_flops(model, sample_input)
    finally:
        model.train(was_training)
    return {
        "params": count_parameters(model),
        "params_mb": count_parameters_in_mb(model),
        "flops": flops,
        "gflops": flops / 1e9,
        "input_shape": tuple(sample_input.shape),
    }
