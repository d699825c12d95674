"""Run logging: per-run directories, a file + console logger, a metric
stream.

A jax-free copy of ``npp_tpu/utils/logging_utils.py:18-83``, with
``create_logger`` taking the directories and names it reads instead of
the JAX package's config object. The output tree is
``<output_dir>/<dataset>/<phase>/<cfg_name>/`` and
``<log_dir>/<dataset>/<phase>/<cfg_name>/<time>/``; metrics stream to
JSONL, and to TensorBoard when ``tensorboardX`` is importable. Under a
process group both are quiet off rank 0: the log file, the console lines
and the metric stream are rank 0's.
"""
from __future__ import annotations

import json
import logging
import os
import time
from pathlib import Path

from npp_tpu_torch.parallel import mesh


def create_logger(output_dir: str, log_dir: str, dataset: str,
                  cfg_name: str, phase: str = "train"):
    """Returns (logger, final_output_dir, tb_log_dir). Off rank 0 the
    logger has no handler and writes nothing, and the directories are
    not made."""
    cfg_stem = os.path.basename(cfg_name).split(".")[0]
    final_output_dir = Path(output_dir) / dataset / phase / cfg_stem
    time_str = time.strftime("%Y-%m-%d-%H-%M")
    tb_log_dir = Path(log_dir) / dataset / phase / cfg_stem / time_str
    logger = logging.getLogger(f"npp_tpu_torch.{phase}")
    logger.setLevel(logging.INFO)
    close_logger(logger)
    if not mesh.is_primary():
        logger.addHandler(logging.NullHandler())
        logger.propagate = False
        return logger, str(final_output_dir), str(tb_log_dir)
    final_output_dir.mkdir(parents=True, exist_ok=True)
    log_file = final_output_dir / f"{cfg_stem}_{time_str}_{phase}.log"
    fh = logging.FileHandler(log_file)
    fh.setFormatter(logging.Formatter("%(asctime)-15s %(message)s"))
    logger.addHandler(fh)
    ch = logging.StreamHandler()
    ch.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(ch)
    tb_log_dir.mkdir(parents=True, exist_ok=True)
    return logger, str(final_output_dir), str(tb_log_dir)


def close_logger(logger: logging.Logger) -> None:
    """Close and remove the logger's handlers (the log file's above all)."""
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()


class MetricWriter:
    """JSONL scalar stream (+ optional TensorBoard); off rank 0 it opens
    nothing and drops every scalar."""

    def __init__(self, log_dir: str):
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._f = self._tb = None
        if not mesh.is_primary():
            return
        self._f = open(self.path, "a")
        try:
            from tensorboardX import SummaryWriter  # optional
        except ImportError:
            return
        self._tb = SummaryWriter(log_dir)

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._f is None:
            return
        self._f.write(json.dumps({"tag": tag, "value": float(value),
                                  "step": int(step),
                                  "time": time.time()}) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
        if self._tb is not None:
            self._tb.close()


class AverageMeter:
    """Weighted running average (utils/utils.py:292-326 in the reference)."""

    def __init__(self):
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.sum += val * n
        self.count += n

    def average(self) -> float:
        return self.sum / self.count if self.count else 0.0
