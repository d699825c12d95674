"""On-card smoke run of the PyTorch port (npp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from the sources in this
checkout (one nvcc each, side by side), checks the heatmap kernel
against its plain PyTorch version on the card (the int8 conv and the
activation quantize are checked in phase 20, on the activations of the
flagship forward), then
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
save and restore, then the search CLI itself); and at the flagship's
width the serving slice (raw images of 200-1280 px -> host preprocess in
the prefetch thread -> Predictor: two forwards, fusion, decode ->
postprocess; its latency at batch 1; the multi-scale parsing test; the
predict CLI serving the train CLI's checkpoint and the search CLI's
genotype, and the test CLI); the Pascal-Person-Part configuration (7
classes, 14 joints) at the flagship width (loader -> heatmap kernel ->
train step at batch 2 -> the PPP eval step and validate_ppp with its
heatmap PCK; the train and search CLIs with ``--dataset ppp``; the OKS
mAP CLI on .mat fixtures); and the chain on the port's own artifacts:
the train CLI builds the search CLI's genotype and merges its checkpoint
(``--genotype``, ``--pretrained-encoder``), and the eval CLI scores the
result (``--ckpt``); and the LIP reader (the host library's JPEG decoder
and cv2-rule warps, built with the host C++ compiler) on a LIP tree
written from the committed JPEG fixtures (``tests/fixtures/torch_lip``):
the reader alone, the flagship train step fed from the tree, and the
train, eval, test, search and predict CLIs reading it; and the rest of
the data package: the Pascal-Person-Part reader on a PPP tree written
from the same JPEGs and the grey part labels of ``tests/fixtures/
torch_ppp`` (the reader alone, the PPP flagship train step and
validate_ppp fed from the tree, the train CLI reading it) and the
``--fast-aug`` fused warp on the LIP tree (the reader alone, against the
parity reader, the flagship train step fed by it, the train CLI with
``--fast-aug``). Any failure raises, so the exit code is non-zero;
without CUDA it exits non-zero before printing any result.

Phases: 1 device, 2 build the three kernel libraries (the heatmap
kernel, the int8 conv, the activation quantize; each build's seconds),
3 the heatmap kernel vs its
plain version (twelve shapes) and
the device time of both by many launches, beside the kernel's bound, at
the eval, the train, the search, the PPP train and the PPP search
shapes, 4 the eval slice in fp32, 5
the eval slice in bf16 + channels_last (timed), 6 the tiny train step on
the card against the CPU in fp32, 7 the flagship train slice in bf16 +
channels_last (checked, timed, profiled), 8 a tiny search pair (weight
step, arch step) on the card against the CPU in fp32, 9 the search slice
at the reference scale in bf16 + channels_last (checked, timed,
profiled), 10 the tiny Predictor on the card against the CPU in fp32
(single scale, pose scales, DARK), 11 the serving slice at the flagship
width in bf16 + channels_last (stream at batch 8, latency at batch 1,
profiled; bf16 vs fp32 maps; multi-scale testval; the CLIs), 12 the tiny
PPP eval and the pretrained merge on the card against the CPU in fp32,
13 the PPP path at the flagship width in bf16 + channels_last (train
step checked, timed, profiled; validate_ppp; the PPP train and search
CLIs; a PPP search pair timed and profiled; eval_ppp_map), 14 the search
-> train -> eval chain at the LIP flagship width, 15 the LIP reader
(fixture decodes against their recorded SHA-256, samples/s with 8
threads and 1, ms per stage, the flagship bs16 bf16 train step from the
tree with the loop's wait on the loader, the CLIs on the tree), 16 the
PPP reader and the fused warp (build_ppp_db's count against the tree's,
samples/s of each reader with 8 threads and 1, the PPP bs2 and the fused
LIP bs16 bf16 train steps fed from disk with the loop's wait, the bf16
vs fp32 PPP loss, validate_ppp on the val tree, the fused reader against
the parity one and its uint8 path against its float32 one, the train CLI
with ``--dataset ppp`` and with ``--fast-aug``), 17 data parallelism:
17a two gloo ranks sharing the card (spawned processes, the tiny
configuration in fp32 at batch 2 a rank) against one process at batch 4
fed the ranks' batches in rank order (two DDP train steps, ZeRO-1
against plain DDP, a search pair, the arch step alone, the gathered
validate and validate_ppp over a set the ranks do not divide), then
each rank's flagship bf16 train step at bs8 timed and profiled, 17b
NCCL at world size 1 (the flagship bs16 bf16 DDP step timed and
profiled with find_unused_parameters off and on, beside phase 7's
unwrapped step; the
train CLI with and without ``--zero``, the search CLI with ``--tiny
--zero`` and the eval CLI on the train CLI's checkpoint, each under
``python -m torch.distributed.run``; ``chip_smoke.py --cli MODULE JSON
ARGS`` is the rank those launches run), 18 spatial partitioning, two
gloo ranks sharing the card: 18a a 1x2 space grid at the flagship width
(the fp32 forward of each rank's 192 rows against one process's, the
bf16 forward timed, profiled and its all-reduces counted,
``Predictor(mesh=)`` with pose scales against the unsharded one), 18b a
2x1 data grid (multi-scale ``testval(mesh=)``) and ``test_lip --mesh``
under ``python -m torch.distributed.run``, then npp_tpu's serving layouts
on both grids (fused necks + cells, int8 with dynamic scales and
calibrated, fused + int8) against one process's Predictor of each, a
rank's windowed int8 convs against their plain version and the
grid-scale quantize (the absmax kernel, one MAX all-reduce over the
grid, the static quantize) against the one-device dynamic quantize of
the whole activation, both bit for bit, each layout's int8 launches and
all-reduces a batch counted, 18c the
1x2 grid training (a tiny fp32 step against one process's, the flagship
bf16 step at bs2 timed and profiled), 19 tensor parallelism, four gloo
ranks sharing the card: 19c the hybrid ZeRO x TP layout on a 2x1x2 grid
(tiny fp32; its consolidated moments against the TP step's without
ZeRO), then on 1x1x2 grids 19a the tiny fp32 TP train and flip-TTA eval
steps against one process's and 19b the flagship bf16 channels_last TP
train step at bs2 (gathers and copies, all-reduces, device operations,
busy time and idle share, peak memory, and the parameter and Adam-moment
bytes a rank holds beside the unconverted model's), 20 (run right after
11, on its model and images) npp_tpu's serving layouts: 20a the int8
conv kernel against its plain version (int32 accumulators and outputs,
max |diff| 0.0) at every dense-conv shape class of the unfused and fused
int8 flagship forwards at bs8, each class's plan variant named (every
variant run at least once), each class timed beside its bound, the
``torch._int_mm`` yardstick and the bf16 cuDNN conv; and the activation
quantize kernel against its plain version (q and the scale, bit for
bit, with and without the folded ReLU, dynamic and static) and the
calibration's absmax kernel against its own (on x and on F.relu(x), bit
for bit) on each class's real input, timed beside its bytes bound,
``torch.quantize_per_tensor`` and, where the forward folds the ReLU in,
``F.relu`` (the pass the fold removed); the same bit-for-bit checks on
the largest input (above the on-chip stash), a tiny one, NCHW copies, a
misaligned view and inputs with NaN, inf, -0.0 and negatives; the int8
forwards' ReLU count (the convs fold every ReLU they own); 20b the
Predictor unfused and with fused necks + cells (in turns), int8 dynamic
and int8 calibrated: img/s, device operations, busy, idle, peak, fused
against unfused labels in fp32 (>= 0.999) and int8 against bf16 (no
bar); 20c the predict CLI with its fused defaults and ``--int8``, and
``eval_lip --synthetic --int8``; the int8 kernels' launches by path: on
the int8 paths one quantize launch per conv launch, dynamic or static,
and no absmax launch; one absmax launch per conv under calibration;
none of the three on any fp path; 21 npp_tpu's optimizer state into the
port and back (21a right after 7 on its flagship bs16 train state, 21b
right after 9 on its reference-scale search state): the state as
npp_tpu's flat tree (``utils/convert.jax_state_tree``, a search in
npp_tpu's default vmapped layout) in an ``.npz``, loaded into a state of
another seed (``load_jax_state``): every value of the checkpoint blob
bit for bit and each moment in its parameter's strides; then one step
(a search: a weight step, then an arch step from the loaded state's
weights and lambdas) from one batch that the heatmap kernel renders, on
the loaded state, on EXCHANGE_TWINS twins given its values and on the
original: the twins' largest difference from the loaded state is the
card's run-to-run spread of a step, and the original against the loaded
state must stay within it; 22 the library around the model (right after 5, on its model
and phase 4/5's first batch): 22a the five context heads
(``ops/heads.py``) at npp_tpu's default widths on (8, 256, 96, 96), each
in fp32 (TF32 off) and in bf16 + channels_last, eval and train mode with
one bf16 backward, bf16 against fp32 by the norm rule, the card's fp32
against the CPU's at batch 1, the forwards' device times; 22b the
flagship's parameter count and ``utils/summary.model_flops`` of the bs8
eval forward, of one flip-TTA serving batch and (right after 21a, on
phase 7's state) of the bs16 train step; 22c the host helpers without
cv2: ``get_final_preds`` on the model's heatmaps, ``crop`` of the batch's
images (the identity box equal to the image), the drawings on phase 5's
predictions and labels, ``save_debug_batch`` read back with
``read_png``, and ``zipreader.imread`` / ``xmlread`` on a zip of the LIP
fixtures equal to the readers, each in ms an image; 23 npp_tpu's
one-dispatch programs as CUDA graphs (``core/graphs.py``): 23a (right
after 22b) the tiny fp32 train of 8 updates as captured dispatches of 3,
3 (across the schedule's boundary) and a tail of 2 against three eager
runs with the same capturable Adam (the state's norms within 2x the
eager twins' spread, each lambda's gradient sum within 1% of its norm,
the first loss, counts and learning rates equal),
then on phase 7's flagship bs16 state one dispatch of 4 captured steps
(ms a step, device operations, busy, idle, peak, capture and
instantiation seconds) beside phase 7's eager step, and capturable
against plain Adam; 23b (right after 20, on phase 11's model) the tiny
eval epoch with a tail batch against ``validate`` and the flagship bs8
flip-TTA eval per batch against ``--scanned``, fp and int8 with dynamic
scales, every output bit for bit, the int8 kernels of a replay counted
by name on the device's record and held against the calls the capture
recorded; 23c ``augment_lip --synthetic --steps-per-dispatch 4`` over two
epochs of 4 steps (a finite, falling loss), ``eval_lip --synthetic
--scanned`` and ``--scanned --int8``.
Order: 1-5, 22, 7, 21a, 22b, 23a (flagship), 9, 21b, 11, 20, 23b, 23c
(eval CLIs), 13, 15, 16, 17b's DDP step, then the ranks: one spawned
pair of gloo ranks runs 17a and then 18, 19's four ranks are spawned as
18 begins; what keeps no times runs beside their tiny work in this
process (6, 8, 10, 12, 23a's tiny check and 17b's torchrun CLIs beside
17a; 14 and 23c's train CLI beside 18's untimed work), and each rank's
timed flagship step, and 18's timed bf16 forward, wait for this
process's word that the card is quiet.
Output: one line per phase and its seconds, each line that begins with
"phase" ending with the script's cumulative seconds (``[t=... s]``, the
spawned ranks' too; stdout and stderr are line-buffered, so a run cut
at its limit keeps what it printed), then a JSON line of the kernels,
the ``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import copy
import hashlib
import importlib
import itertools
import json
import math
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import weakref
import zipfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.nn.parallel import DistributedDataParallel

from npp_tpu_torch import engine
from npp_tpu_torch.config import LIP, PPP
from npp_tpu_torch.core import checkpoint
from npp_tpu_torch.core import evaluate as E
from npp_tpu_torch.core import graphs
from npp_tpu_torch.core import inference as I
from npp_tpu_torch.core import test_seg
from npp_tpu_torch.core import search as S
from npp_tpu_torch.core import train as T
from npp_tpu_torch.core.criterion import (LIP_CLASS_WEIGHTS,
                                          init_criterion_params)
from npp_tpu_torch.core.predictor import Predictor
from npp_tpu_torch.data import augmentation as A
from npp_tpu_torch.data import imgproc
from npp_tpu_torch.data import lip
from npp_tpu_torch.data import loader as L
from npp_tpu_torch.data import pascal
from npp_tpu_torch.data import targets as TG
from npp_tpu_torch.data.synthetic import (IMAGENET_MEAN, IMAGENET_STD,
                                          SyntheticDataset)
from npp_tpu_torch.genotypes import load_genotypes
from npp_tpu_torch.models import genotype_parse as GP
from npp_tpu_torch.models.augment import NPPNet, build_nppnet
from npp_tpu_torch.ops import heatmaps
from npp_tpu_torch.ops import quantize as Q
from npp_tpu_torch.parallel import mesh, spatial, tensor, zero
from npp_tpu_torch.tools import (augment_lip, eval_lip, eval_ppp_map,
                                 predict, search_lip, test_lip)
from npp_tpu_torch.ops import heads as H
from npp_tpu_torch.utils import convert
from npp_tpu_torch.utils import metrics as M
from npp_tpu_torch.utils import summary as SM
from npp_tpu_torch.utils import transforms as TR
from npp_tpu_torch.utils import vis
from npp_tpu_torch.utils import zipreader

# The script's start (``time.time()``), inherited by the processes it
# spawns, so that every phase line, theirs too, carries the script's
# cumulative seconds.
T0 = float(os.environ.setdefault("CHIP_SMOKE_T0", repr(time.time())))
_print = print


def print(*args, **kw):  # noqa: A001 - the module's own print
    """``print``, with the script's cumulative seconds (``[t=... s]``)
    after every line that begins with "phase"."""
    if args and isinstance(args[0], str) and args[0].startswith("phase "):
        args = (*args, f"[t={time.time() - T0:.1f} s]")
    _print(*args, **kw)


def line_buffered() -> None:
    """Flush stdout and stderr at each line, so that a run cut at its time
    limit keeps every phase line it printed (under a pipe Python buffers
    them by blocks)."""
    sys.stdout.reconfigure(line_buffering=True)
    sys.stderr.reconfigure(line_buffering=True)

KERNEL_SHAPES = (  # (B, J, gy, gx, sigma)
    (8, 16, 96, 96, 3.0),    # the eval slice's
    (3, 14, 96, 72, 2.0),    # a ragged one
    (1, 13, 25, 23, 2.5),    # its last tile holds 3,528 B, not a multiple of 16
    (16, 16, 96, 96, 3.0),   # the train slice's
    (7, 16, 96, 96, 3.0),    # the search slice's
    (2, 14, 96, 96, 3.0),    # the PPP train slice's
    (7, 14, 96, 96, 3.0),    # the PPP search slice's
    (2, 16, 32, 32, 3.0),    # phase 17's tiny shards, train and search
    (1, 16, 32, 32, 3.0),    # 17a's validate at bs1 a rank
    (1, 14, 32, 32, 3.0),    # 17a's validate_ppp at bs1 a rank
    (4, 16, 32, 32, 3.0),    # phase 6's and 18c's tiny batch (18c: each
                             # rank renders it at full height)
    (2, 16, 96, 96, 3.0),    # 18c's flagship bs2 sp step, full height
)
TIMED_SHAPES = {0: "eval", 3: "train", 4: "search", 5: "ppp_train",
                6: "ppp_search"}
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
TRAIN_TIMED = 4          # timed steps; the first is dropped as warm-up (6
                         # before phase 22 came)
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
EPOCH_STEPS = 1          # phase 9's warmup steps and search-epoch pairs (2
                         # before phase 22 came)
SEARCH_TIMED = 2         # timed bi-level pairs; the first is dropped as warm-up
                         # (2 since phase 22 came, 3 before, 6 at first: the
                         # script's time limit)
# Phase 10, the tiny Predictor on the card against the CPU (fp32, TF32
# off): labels agree on LABEL_SHARE of the pixels (an argmax whose top two
# logits are within rounding may part), keypoints to KP_ATOL px wherever
# the blurred heatmap's peak is unique (its top two values more than
# UNIQUE_GAP x the peak apart).
LABEL_SHARE = 0.999
KP_ATOL = 1e-3
UNIQUE_GAP = 1e-4
SERVE_SIZES = ((200, 160), (150, 300), (128, 128), (97, 61), (400, 250),
               (90, 333))
# Phase 11, the serving slice at the flagship width.
SERVE_IMAGES, SERVE_BATCH = 32, 8  # 64 images before phase 22 came
# Phase 12, the tiny PPP eval on the card against the CPU (fp32, TF32 off,
# the same weights and the same rendered batches): the fused heatmaps to
# PPP_HM_RTOL x max|ref| (fp32 convs summed in other orders), the losses
# at TINY_LOSS_RTOL[0]; the confusion matrices, parsing labels and PCK
# vectors equal.
PPP_HM_RTOL = 1e-4
LATENCY_CALLS = 10  # 20 before phase 22 came
BF16_MAP_RTOL = 5e-2   # ||bf16 - fp32|| / ||fp32|| of the fused logits / heatmaps
# Phase 15: the LIP reader on a tree built from the committed JPEG
# fixtures (tests/fixtures/make_torch_lip.py writes them).
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "fixtures", "torch_lip")
LIP_TRAIN, LIP_VAL = 64, 16  # entries of the tree's train and val sets
# Phase 16: a Pascal-Person-Part tree from the same JPEGs and the grey
# part labels of tests/fixtures/make_torch_ppp.py.
PPP_FIXTURES = os.path.join(os.path.dirname(FIXTURES), "torch_ppp")
PPP_TRAIN, PPP_VAL = 32, 8   # ids of the PPP tree's train and val lists
PPP_STEPS = 6                # PPP train steps from the tree (the first is warm-up;
                             # 8 before phase 22 came)
LIP_EPOCHS = 2               # train epochs of the in-process loop (8 steps)
STAGE_SAMPLES = 16           # samples timed stage by stage
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA's data sheet)
FP32_OPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
TIMED_CALLS = 200          # calls per timed run
COLD_RING = 8              # calls whose outputs stay referenced: 8 x 10 MB > 50 MB L2
# Phase 21: npp_tpu's optimizer state into the port and back. The
# original and a loaded twin hold the same values, so their next step may
# differ only as two runs of one step do on the card (the backward's
# atomics); the twins' differences from the loaded state measure that
# spread, and the original against the loaded state must stay within
# SPREAD_MARGIN times the largest of them: in each step's loss (a forward
# from equal values: the spread is 0, so equal), in the norm of the
# updated weights' difference (a norm over tens of millions of rounding
# differences varies far less between two runs than their maximum:
# original against loaded came out 0.90-1.16 of one twin's norm in the
# phase's first eight runs, on an NVIDIA H100 80GB HBM3 at 700 W) and,
# for a search pair, in that of the architecture parameters after the arch
# step, which the arch Adam's carried moments decide. A search pair's arch
# step starts from the loaded state's weights and lambdas after its weight
# step, so that its loss too is a forward from equal values. Left to
# follow each state's own weight step, that loss is a scalar after updates
# that differ by the spread, which the OHEM loss's pixel selection
# magnifies: two twins came out 0.0326 apart in one run and 0.000121 in
# another, and one such run failed the phase. From equal values those
# losses came out equal and the norms 0.91-1.23 of the largest of three
# twins' (four runs on that card). Two twins, so that one run's small
# spread does not set the bound alone.
SPREAD_MARGIN = 2.0
EXCHANGE_TWINS = 2

# Phase 20: npp_tpu's serving layouts at the flagship width.
INT8_CALLS = 20          # timed calls per shape class (cold L2 ring as phase 3;
                         # 40 before phase 22 came)
INT8_PLAIN_CALLS = 5     # the plain version's (its float64 conv is slow; 10)
INT8_LIB_CALLS = 10      # a yardstick's: _int_mm, cuDNN, quantize_per_tensor (20)
# One unfused flagship int8 forward at bs8 through the int8 conv's first
# design (mma.sync, 128 x 64 tiles, one shared stage), NVIDIA H100 80GB
# HBM3 at 700 W: the sum that phase 20a prints the redesign's beside.
MMA_SYNC_FORWARD_MS = "21.09-21.16"
# Each variant of the conv's plan runs at least once in phase 20a.
INT8_VARIANTS = ("wgmma", "wgmma_tma", "wgmma split-K", "packed", "tiny_m")
COLD_BYTES = 64 * 2**20  # input copies cycled per class: > the 50 MB L2
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core rate (data sheet)
CALIB_IMAGES = 16        # images of the int8 calibration
# The int8 convs that read a ReLU's output whose other readers need it
# too, so that the ReLU cannot fold into their quantize: stem2 and stem5
# read stem1's and stem4's outputs, which are also cell states.
SHARED_RELU_CONVS = ("stem2.Conv_0", "stem5.Conv_0")
FUSED_LABEL_SHARE = 0.999  # fused vs unfused labels, fp32, TF32 off
LAYOUT_IMAGES = 16       # images of the layout comparisons
LAYOUT_STREAM = 32       # images of each 20b stream
TIMING = (f"CUDA events around {TIMED_CALLS} calls queued behind a "
          f"torch.cuda._sleep, over the count; the outputs of the last "
          f"{COLD_RING} calls kept referenced (cold L2)")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_us(fn, calls: int = TIMED_CALLS) -> tuple[float, bool]:
    """Device time of one call of ``fn``, in us: a sleep kernel holds the
    stream while the host queues ``calls`` calls behind it, and CUDA
    events around those calls give their time over the count. The outputs
    of the last ``COLD_RING`` calls stay referenced, so the caching
    allocator hands each call memory that is not hot in the L2. Also
    returns whether every call was queued before the device reached the
    first: a call that synchronises the host cannot be, and then the time
    holds host time too."""
    ring = collections.deque(maxlen=COLD_RING)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):  # warm-up, and the host's enqueue time
        ring.append(fn())
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # > 2x that at <= 2 GHz, and 5 ms more against a slower second loop
    torch.cuda._sleep(int(4e9 * host_s) + 10**7)
    start.record()
    for _ in range(calls):
        ring.append(fn())
    end.record()
    queued = not start.query()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / calls, queued


def queued_device_us(fn, calls: int, what: str) -> float:
    """``device_us`` of a kernel's calls, which must all be queued behind
    the sleep (else host time is in the number): up to three tries, since
    a host that stalls once (the machine's other processes) can overrun
    the sleep."""
    for _ in range(3):
        us, queued = device_us(fn, calls)
        if queued:
            return us
    raise AssertionError(f"phase 20a: the timed {what} calls were not all "
                         f"queued behind the sleep in three tries")


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
    for path in ("train", "search", "ppp_train", "ppp_search"):
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


def profile_step(step, state, batch, counted=None) -> dict:
    """Device operations (kernels, copies, fills) and device busy time of
    one step (``torch.profiler``, device activity only; busy = the union
    of their spans), with the eight largest by device time; with
    ``counted`` ({key: regex}), ``counted`` in the result holds the
    number of device operations whose name each regex finds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    # Kernels and memory operations; not the ranges that user annotations
    # (such as the optimizer's step) draw on the device's timeline. Read
    # from the profiler's raw results: ``prof.events()`` would build a
    # Python event for each first, ~60 us apiece (seconds for the 115,000
    # operations of a search pair; before phase 23 came it did).
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA
              and not e.is_user_annotation() and not e.is_hidden_event()
              and not e.name().startswith("Optimizer.")]
    spans = sorted((e.start_ns() / 1e3, e.end_ns() / 1e3) for e in events)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        by_name[e.name()][0] += e.duration_ns() / 1e3
        by_name[e.name()][1] += 1
    top = sorted(((t, n, k) for k, (t, n) in by_name.items()),
                 reverse=True)[:8]
    if not spans:
        raise AssertionError("torch.profiler recorded no device operation")
    out = dict(kernels=len(spans), busy_ms=busy / 1e3,
               top=[(k[:70], n, round(t / 1e3, 3)) for t, n, k in top])
    if counted:
        out["counted"] = {key: sum(n for k, (_, n) in by_name.items()
                                   if re.search(rx, k))
                          for key, rx in counted.items()}
    return out


def fp32_loss(state, batch, hp, class_weights=LIP_CLASS_WEIGHTS) -> float:
    """The dual-task loss of a float32 copy of the state's model (train
    mode, no gradients) on ``batch``; the state stays untouched."""
    ref = copy.deepcopy(state.model)
    ref.dtype = torch.float32
    with torch.no_grad():
        loss = T.compute_losses(ref, state.lamdas, batch,
                                class_weights=class_weights,
                                ignore_index=eval_lip.IGNORE,
                                ohem_thres=hp["ohem_thres"],
                                ohem_keep=hp["ohem_keep"])[0].item()
    del ref
    return loss


def flagship_train(tag: str, out_root: str) -> tuple[dict, dict]:
    """Phase 7: the flagship train slice at batch 16, bf16 +
    channels_last, through the train CLI's functions; then the CLI, whose
    run directory goes under ``out_root``. Returns its numbers and what
    phase 21a takes on: the state, its loader, its step and how to build
    a fresh state."""
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
    out = augment_lip.main(["--synthetic", "--steps", "2", "--epochs", "1",
                            "--out", out_root])
    if not math.isfinite(out["train_loss"]):
        raise AssertionError("phase 7: the CLI's loss is not finite")
    print(f"phase 7: python -m npp_tpu_torch.tools.augment_lip --synthetic "
          f"--steps 2 --epochs 1: train loss {out['train_loss']:.6f}, "
          f"{eval_lip.result_line(out['result'])} {tag}")
    ctx = dict(state=state, loaders=(train_loader,),
               steps=lambda st, b: step(st, b[0]),
               make=lambda seed: augment_lip.init_state(
                   eval_lip.FLAGSHIP, hp, device="cuda",
                   dtype=torch.bfloat16, seed=seed,
                   steps_per_epoch=len(train_loader)))
    return dict(step_ms=step_s * 1e3, img_per_s=bs / step_s,
                peak_gib=peak / 2**30, idle_share=idle,
                checkpoints=out["checkpoints"], **prof), ctx


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


def flagship_search(tag: str, out_root: str) -> tuple[dict, dict]:
    """Phase 9: the search slice at the reference scale (L=16, C=32, batch
    7, 384x384, bf16 + channels_last) through the search CLI's functions;
    then the CLI, whose run directory goes under ``out_root``. Returns its
    numbers and what phase 21b takes on (as ``flagship_train``)."""
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
        weight_step, state,
        augment_lip.LimitedLoader(train_loader, EPOCH_STEPS),
        epoch=0, print_freq=hp["print_freq"])
    train_loader.set_epoch(1)
    mini_loader.set_epoch(1)
    avg_s, _ = engine.search_epoch(
        weight_step, arch_step, state,
        augment_lip.LimitedLoader(train_loader, EPOCH_STEPS),
        augment_lip.LimitedLoader(mini_loader, EPOCH_STEPS), epoch=1,
        entropy_epoch=hp["entropy_epoch"], print_freq=hp["print_freq"])
    print(f"phase 9: train_epoch warmup ({EPOCH_STEPS} weight step) mean "
          f"loss {avg_w:.6f}; search_epoch ({EPOCH_STEPS} pair) mean "
          f"weight-step loss "
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

    ctx = dict(state=state, loaders=(train_loader, mini_loader),
               steps=lambda st, b: weight_step(st, b[0]),
               arch_step=lambda st, b: arch_step(st, b[1], 1.0),
               make=lambda seed: search_lip.init_state(
                   search_lip.FLAGSHIP_SEARCH_MODEL, hp, device="cuda",
                   dtype=torch.bfloat16, seed=seed,
                   steps_per_epoch=len(train_loader)))
    del state, tb, mb
    torch.cuda.empty_cache()

    # The search CLI itself: a warmup epoch and a search epoch of 1 step
    # (2 before phase 23 came; its genotype and checkpoint feed phase 14's
    # chain).
    out = search_lip.main(["--synthetic", "--steps", "1", "--epochs", "2",
                           "--warmup-epochs", "1", "--out", out_root])
    genotype = os.path.join(out["out_dir"], "best_genotype.json")
    wrote = os.path.isfile(genotype)
    print(f"phase 9: python -m npp_tpu_torch.tools.search_lip --synthetic "
          f"--steps 1 --epochs 2 --warmup-epochs 1: train loss "
          f"{out['train_loss']:.6f}, {eval_lip.result_line(out['result'])}, "
          f"best_genotype.json written {wrote} {tag}")
    if not (wrote and math.isfinite(out["train_loss"])):
        raise AssertionError("phase 9: the search CLI wrote no "
                             "best_genotype.json or its loss is not finite")
    return dict(pair_ms=pair_s * 1e3, weight_step_ms=w_s * 1e3,
                arch_step_ms=a_s * 1e3, img_per_s=bs / pair_s,
                peak_gib=peak / 2**30, idle_share=idle, params=n_params,
                loss_rel_bf16=rel, genotype=genotype,
                search_checkpoints=out["checkpoints"], **prof), ctx


def moments_in_param_strides(state) -> bool:
    """Whether every Adam moment of ``state``'s optimizers has its
    parameter's shape and strides."""
    opts = [getattr(state, k) for k in ("optimizer", "w_optimizer",
                                        "a_optimizer") if hasattr(state, k)]
    return all(v.shape == p.shape and v.stride() == p.stride()
               for o in opts for p, entry in o.state.items()
               for k, v in entry.items() if k.startswith("exp_avg"))


def exchange_step(ctx: dict, st, batches, ref: dict | None = None) -> dict:
    """Phase 21's step of ``st`` on ``batches``: the losses, and copies of
    the weights and lambdas after the train or weight step and (a search,
    whose ``ctx`` has ``arch_step``) of the architecture parameters after
    the arch step. The arch step starts from ``ref``'s weights and lambdas
    (a result of this function), where given."""
    out = dict(loss=ctx["steps"](st, batches)["loss"].item())
    arch = st.model.arch_parameters() if "arch_step" in ctx else {}
    tensors = [*st.model.named_parameters(), *st.lamdas.items()]
    out["weights"] = {k: p.detach().clone() for k, p in tensors
                      if k not in arch}
    if arch:
        if ref is not None:
            with torch.no_grad():
                for k, p in tensors:
                    if k not in arch:
                        p.copy_(ref["weights"][k])
        out["arch_loss"] = ctx["arch_step"](st, batches)["loss"].item()
        out["arch"] = {k: p.detach().clone() for k, p in arch.items()}
    return out


def step_apart(a: dict, b: dict) -> dict:
    """Two ``exchange_step`` results apart: |loss a - loss b| (and of the
    arch step's), the max and norm of the weights' and lambdas'
    difference, and the norm of the architecture parameters'."""
    def diff(x, y):
        d = [(x[k] - y[k]).float() for k in x]
        return (max(float(t.abs().max()) for t in d),
                sum(float((t * t).sum()) for t in d) ** 0.5)

    top, norm = diff(a["weights"], b["weights"])
    out = {k: abs(a[k] - b[k]) for k in ("loss", "arch_loss") if k in a}
    out.update(max=top, norm=norm)
    if "arch" in a:
        out["arch_norm"] = diff(a["arch"], b["arch"])[1]
    return out


def state_exchange(tag: str, phase: str, ctx: dict) -> dict:
    """Phase 21a / 21b: the state in ``ctx`` as npp_tpu's flat tree in an
    ``.npz`` (``convert.jax_state_tree``) and back into a state built from
    another seed (``convert.load_jax_state``), bit for bit; then one step
    (``exchange_step``) from one batch rendered here by the heatmap
    kernel, on the loaded state, on EXCHANGE_TWINS twins (a third state
    given the loaded one's values anew for each) and on the original
    (module docstring)."""
    state = ctx["state"]
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        t0 = time.perf_counter()
        tree = convert.jax_state_tree(state)
        np.savez(path, **tree)
        export_s = time.perf_counter() - t0
        n_leaves, npz_bytes = len(tree), os.path.getsize(path)
        del tree
        loaded = ctx["make"](SEED + 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with np.load(path) as f:
            convert.load_jax_state(loaded, {k: f[k] for k in f.files})
        torch.cuda.synchronize()
        import_s = time.perf_counter() - t0
    same = same_values(checkpoint.state_dict(state),
                       checkpoint.state_dict(loaded))
    # The spread's twins: the loaded state again, through the port's own
    # checkpoint blob (copied: a loaded optimizer would share its tensors),
    # into a third state, loaded anew for each twin and held to the blob.
    blob = copy.deepcopy(checkpoint.state_dict(loaded))
    strides = moments_in_param_strides(loaded)
    launched = heatmaps.render_heatmaps.launches
    batches = [take(loader, 1)[0] for loader in ctx["loaders"]]
    launched = heatmaps.render_heatmaps.launches - launched
    m_loaded = exchange_step(ctx, loaded, batches)
    del loaded
    twin, twins = ctx["make"](SEED + 3), []
    for _ in range(EXCHANGE_TWINS):
        checkpoint.load_state_dict(twin, copy.deepcopy(blob))
        same = same and same_values(checkpoint.state_dict(twin), blob)
        strides = strides and moments_in_param_strides(twin)
        twins.append(step_apart(exchange_step(ctx, twin, batches, m_loaded),
                                m_loaded))
    del twin, blob
    m_orig = exchange_step(ctx, state, batches, m_loaded)
    torch.cuda.synchronize()
    spread = {k: max(t[k] for t in twins) for k in twins[0]}
    resumed = step_apart(m_orig, m_loaded)
    del m_loaded
    torch.cuda.empty_cache()

    def fmt(d):
        return ", ".join(f"{k} {v:.3g}" for k, v in d.items())

    gated = [k for k in ("loss", "arch_loss", "norm", "arch_norm")
             if k in resumed]
    print(f"phase {phase}: npp_tpu state exchange: {n_leaves:,} leaves, "
          f".npz {npz_bytes:,} bytes, export {export_s:.3f} s, import "
          f"{import_s:.3f} s; every value of the "
          f"checkpoint blob identical {same}, moments in their parameters' "
          f"strides {strides}; heatmap launches rendering the resumed "
          f"steps' batches {launched}; one step, the loss "
          f"{m_orig['loss']:.6f}"
          + (f", the arch step's {m_orig['arch_loss']:.6f}"
             if "arch_loss" in m_orig else "")
          + f": {EXCHANGE_TWINS} twins apart from the loaded state "
          f"{'; '.join(fmt(t) for t in twins)}; original vs loaded "
          f"{fmt(resumed)} ({', '.join(gated)} <= {SPREAD_MARGIN} x the "
          f"twins' largest) {tag}")
    if not (same and strides):
        raise AssertionError(f"phase {phase}: the loaded state differs from "
                             f"the exported one")
    if launched != len(batches):
        raise AssertionError(f"phase {phase}: {launched} heatmap launches "
                             f"for {len(batches)} batches")
    over = {k: (resumed[k], SPREAD_MARGIN * spread[k]) for k in gated
            if resumed[k] > SPREAD_MARGIN * spread[k]}
    if over or not math.isfinite(m_orig["loss"]):
        raise AssertionError(f"phase {phase}: the resumed step leaves the "
                             f"card's run-to-run spread (value, bound): "
                             f"{over}, loss {m_orig['loss']}")
    return dict(leaves=n_leaves, npz_bytes=npz_bytes, export_s=export_s,
                import_s=import_s, launches=launched, spread=spread,
                resumed=resumed)


def serve_images(n: int, sizes=None, seed: int = SEED) -> list:
    """``n`` uint8 RGB images: random noise under a bright blob; sizes
    from ``sizes`` or drawn from 200-1280 px per side (both
    orientations)."""
    rng = np.random.default_rng(seed)
    ims = []
    for i in range(n):
        h, w = sizes[i % len(sizes)] if sizes else rng.integers(200, 1281, 2)
        im = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        cy, cx, r = h * rng.uniform(0.3, 0.7), w * rng.uniform(0.3, 0.7), \
            0.2 * min(h, w)
        im[max(int(cy - r), 0):int(cy + r), max(int(cx - r), 0):int(cx + r)] \
            //= 4
        ims.append(im)
    return ims


def peak_is_unique(pred: Predictor, ims, gap: float = UNIQUE_GAP
                   ) -> np.ndarray:
    """(B, J) bool on the CPU predictor: whether each blurred fused
    heatmap's maximum exceeds its second value by more than ``gap`` x
    the maximum."""
    pres = [[pred.preprocess(im, m) for im in ims] for m in pred.pose_scales]
    flat = np.stack([[p[0] for p in row] for row in pres], 1)
    flat = torch.from_numpy(flat.reshape((-1,) + flat.shape[2:]))
    cps = torch.from_numpy(np.stack([[p[1] for p in row] for row in pres]))
    _, hm = pred.fuse(flat.to(pred.device), cps.to(pred.device))
    hm = I.gaussian_blur(hm, pred.blur_sigma)
    top = hm.flatten(2).topk(2, dim=2).values
    return ((top[..., 0] - top[..., 1])
            > gap * top[..., 0].abs()).cpu().numpy()


def check_tiny_serve(tag: str) -> dict:
    """Phase 10: the tiny fp32 Predictor (L=8, C=8, 128x128) on the card
    against the CPU, same weights and images: single-scale flip TTA,
    scale-list pose TTA and the DARK decode."""
    cpu_model = build_nppnet(device="cpu", generator=torch.Generator()
                             .manual_seed(SEED), dtype=torch.float32,
                             **eval_lip.TINY)
    card_model = copy.deepcopy(cpu_model).to("cuda").to(
        memory_format=torch.channels_last)
    ims = serve_images(len(SERVE_SIZES), SERVE_SIZES)
    out = {}
    for variant, kw in (("single", {}),
                        ("pose_scales", dict(pose_scales=(0.8, 1.0, 1.2))),
                        ("dark", dict(dark_decode=True))):
        card = Predictor(card_model, crop_size=(128, 128), **kw)
        cpu = Predictor(cpu_model, crop_size=(128, 128), **kw)
        a, b = card.predict_batch(ims), cpu.predict_batch(ims)
        crop_share = np.mean([np.mean(x["parsing_crop"] == y["parsing_crop"])
                              for x, y in zip(a, b)])
        full_share = (sum(int((x["parsing"] == y["parsing"]).sum())
                          for x, y in zip(a, b))
                      / sum(x["parsing"].size for x in b))
        unique = peak_is_unique(cpu, ims)
        kp_err = np.stack([np.abs(x["keypoints"][:, :2] - y["keypoints"][:, :2])
                           .max(axis=1) for x, y in zip(a, b)])
        worst = float(kp_err[unique].max())
        score = max(float(np.abs(x["keypoints"][:, 2] - y["keypoints"][:, 2])
                          .max()) for x, y in zip(a, b))
        print(f"phase 10: tiny Predictor ({variant}, L=8, C=8, 128x128, fp32, "
              f"TF32 off), card vs CPU on {len(ims)} images "
              f"{[im.shape[:2] for im in ims]}: crop labels agree on "
              f"{crop_share:.6f}, image labels on {full_share:.6f} (>= "
              f"{LABEL_SHARE}); keypoints max|diff| {worst:.3g} px over the "
              f"{int(unique.sum())} of {unique.size} joints with a unique "
              f"peak (<= {KP_ATOL}); peak scores max|diff| {score:.3g} {tag}")
        if not (crop_share >= LABEL_SHARE and full_share >= LABEL_SHARE):
            raise AssertionError(f"phase 10: {variant} labels disagree")
        if not worst <= KP_ATOL:
            raise AssertionError(f"phase 10: {variant} keypoints disagree")
        out[variant] = dict(crop_label_share=crop_share,
                            label_share=full_share, kp_abs=worst,
                            unique_peaks=int(unique.sum()), joints=unique.size)
    return out


def flagship_serve(tag: str, train_ckpt: str, genotype: str) -> tuple:
    """Phase 11: the serving slice at the flagship width (L=16, C=64,
    384x384, bf16 + channels_last, flip TTA): the Predictor's stream at
    batch 8 and its latency at batch 1, bf16 against fp32, the pose-scale
    identity, the multi-scale parsing test, and the predict and test_lip
    CLIs (with the train CLI's checkpoint and the search CLI's genotype).
    Returns (its numbers, what phase 20 reuses: the model, the unfused
    Predictor, the images and the stream's results)."""
    model = build_nppnet(device="cuda", generator=torch.Generator()
                         .manual_seed(SEED), dtype=torch.bfloat16,
                         **eval_lip.FLAGSHIP)
    model = model.to(memory_format=torch.channels_last)
    pred = Predictor(model, crop_size=(384, 384))
    ims = serve_images(SERVE_IMAGES)
    pred.predict_batch(ims[:SERVE_BATCH])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = list(pred.predict_stream(iter(ims), batch_size=SERVE_BATCH))
    stream_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if len(results) != len(ims) or not all(
            r["parsing"].shape == im.shape[:2]
            and np.isfinite(r["keypoints"]).all()
            for r, im in zip(results, ims)):
        raise AssertionError("phase 11: the stream's results are incomplete")
    batch_s = stream_s / (len(ims) / SERVE_BATCH)
    prof = profile_step(lambda _, b: pred.predict_batch(b), None,
                        ims[:SERVE_BATCH])
    idle = 1.0 - prof["busy_ms"] / (batch_s * 1e3)
    # The host's share: the preprocess and the postprocess alone.
    t0 = time.perf_counter()
    pres = [pred.preprocess(im) for im in ims]
    pre_s = (time.perf_counter() - t0) / len(ims)
    t0 = time.perf_counter()
    for im, p, r in zip(ims, pres, results):
        pred._postprocess(im, r["parsing_crop"], p[1], np.float32(p[2]),
                          r["keypoints"])
    post_s = (time.perf_counter() - t0) / len(ims)
    pred(ims[0])  # the first call at batch 1 sets up its shapes
    lat = []
    for im in ims[:LATENCY_CALLS]:
        t0 = time.perf_counter()
        pred(im)
        lat.append(time.perf_counter() - t0)
    sizes = [im.shape[:2] for im in ims]
    print(f"phase 11: predict_stream bs{SERVE_BATCH} over {len(ims)} images "
          f"({min(min(s) for s in sizes)}-{max(max(s) for s in sizes)} px a "
          f"side): {stream_s * 1e3:.3f} ms = {len(ims) / stream_s:.3f} img/s "
          f"(host preprocess in the prefetch thread, device, postprocess); "
          f"peak memory {peak / 2**30:.3f} GiB; one profiled batch: "
          f"{prof['kernels']} device operations, device busy "
          f"{prof['busy_ms']:.3f} ms, idle share of the stream's mean batch "
          f"({batch_s * 1e3:.3f} ms) {idle:.3f}; host alone per image: "
          f"preprocess {pre_s * 1e3:.3f} ms, postprocess {post_s * 1e3:.3f} "
          f"ms; top by device time {prof['top']} {tag}")
    print(f"phase 11: __call__ latency at batch 1 over {LATENCY_CALLS} calls: "
          f"median {statistics.median(lat) * 1e3:.3f} ms, max "
          f"{max(lat) * 1e3:.3f} ms ({['%.1f' % (t * 1e3) for t in lat]} ms) "
          f"{tag}")

    # bf16 against fp32 on the same weights and canvases, before the argmax.
    canv = torch.from_numpy(np.stack([p[0] for p in pres[:SERVE_BATCH]]))
    cps = torch.from_numpy(np.stack([p[1] for p in pres[:SERVE_BATCH]]))
    canv, cps = canv.to("cuda"), cps[None].to("cuda")
    par16, hm16 = pred.fuse(canv, cps)
    model.dtype = torch.float32
    par32, hm32 = pred.fuse(canv, cps)
    model.dtype = torch.bfloat16
    rel = [((a - b).norm() / b.norm()).item()
           for a, b in ((par16, par32), (hm16, hm32))]
    del par16, hm16, par32, hm32
    # pose_scales=(1.0,) is the single-scale path, bit for bit.
    one = Predictor(model, crop_size=(384, 384), pose_scales=(1.0,))
    a, b = one.predict_batch(ims[:SERVE_BATCH]), results[:SERVE_BATCH]
    same = all(np.array_equal(x["parsing"], y["parsing"])
               and np.array_equal(x["keypoints"], y["keypoints"])
               for x, y in zip(a, b))
    print(f"phase 11: bf16 vs fp32 (same weights, {SERVE_BATCH} canvases): "
          f"fused parsing logits relative error {rel[0]:.4g}, fused heatmaps "
          f"{rel[1]:.4g} (<= {BF16_MAP_RTOL}); pose_scales=(1.0,) equals the "
          f"single-scale results bit for bit: {same} {tag}")
    if not all(r <= BF16_MAP_RTOL for r in rel):
        raise AssertionError(f"phase 11: bf16 vs fp32 maps {rel}")
    if not same:
        raise AssertionError("phase 11: pose_scales=(1.0,) differs from the "
                             "single-scale path")

    # Multi-scale sliding-window parsing over 2 synthetic images.
    ds = SyntheticDataset(length=2, crop_size=(384, 384), is_train=False,
                          seed=SEED)
    loader = L.DataLoader(ds, 1, device="cuda", num_workers=2)
    apply_fn = test_seg.make_parsing_apply_fn(model)
    test_seg.testval(apply_fn, loader, num_classes=20, crop_size=(384, 384),
                     scales=(1.0,))  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seg = test_seg.testval(apply_fn, loader, num_classes=20,
                           scales=LIP.test['scale_list'], flip=True,
                           crop_size=(384, 384), ignore=eval_lip.IGNORE)
    per_image = (time.perf_counter() - t0) / len(ds)
    n_valid = 2 * 384 * 384
    print(f"phase 11: testval over 2 images at scales "
          f"{LIP.test['scale_list']} with flips: {per_image * 1e3:.3f} ms per "
          f"image; pixel_acc {seg['pixel_acc']:.4f} mIoU "
          f"{seg['mean_iou']:.4f}; cm.sum={int(seg['cm'].sum())} == valid "
          f"pixels {n_valid} {tag}")
    if int(seg["cm"].sum()) != n_valid:
        raise AssertionError("phase 11: testval's confusion matrix misses "
                             "pixels")
    del one
    torch.cuda.empty_cache()

    # The CLIs: train -> serve, search -> serve, and the test CLI.
    cli = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, extra in (("train_ckpt", ["--ckpt", train_ckpt]),
                            ("genotype", ["--genotype", genotype])):
            out_dir = os.path.join(tmp, name)
            out = predict.main(["--synthetic", "8", "--out", out_dir, *extra])
            back = [vis.read_png(os.path.join(out_dir, f"{n}.png"))[0]
                    for n in out["names"]]
            decoded = len(back) == 8 and all(
                np.array_equal(x, y) for x, y in zip(back, out["parsings"]))
            with open(out["csv"]) as f:
                rows = len(f.read().splitlines())
            print(f"phase 11: python -m npp_tpu_torch.tools.predict "
                  f"--synthetic 8 {' '.join(extra)}: {len(back)} PNGs decode "
                  f"back to the returned labels {decoded}; pose_pred.csv "
                  f"rows {rows} {tag}")
            if not (decoded and rows == 8):
                raise AssertionError(f"phase 11: the predict CLI with "
                                     f"{name} failed")
            cli[name] = dict(pngs=len(back), csv_rows=rows)
    res = test_lip.main(["--synthetic", "--mode", "testval", "--limit", "2"])
    if int(res["cm"].sum()) != n_valid:
        raise AssertionError("phase 11: the test_lip CLI missed pixels")
    print(f"phase 11: python -m npp_tpu_torch.tools.test_lip --synthetic "
          f"--mode testval --limit 2: mIoU {res['mean_iou']:.4f}, cm.sum "
          f"{int(res['cm'].sum())} {tag}")
    out = dict(img_per_s=len(ims) / stream_s, stream_ms=stream_s * 1e3,
               batch_ms=batch_s * 1e3, peak_gib=peak / 2**30,
               idle_share=idle, preprocess_ms=pre_s * 1e3,
               postprocess_ms=post_s * 1e3,
               latency_median_ms=statistics.median(lat)
               * 1e3, latency_max_ms=max(lat) * 1e3, bf16_rel=rel,
               testval_ms_per_image=per_image * 1e3, cli=cli, **prof)
    # Phase 20 serves the same model and images in npp_tpu's layouts.
    return out, dict(model=model, pred=pred, ims=ims, results=results)


def int8_classes(model, x) -> tuple[dict, dict]:
    """The dense-conv shape classes of one int8 forward of ``model`` (a
    prepared NPPNet) on ``x``: (input shape, weight shape, geometry, bias,
    output dtype) -> [the conv operands of its first call, the geometry,
    calls in the forward, that call's activation, static scale and ReLU
    flag, calls with the ReLU folded in]. ``quantize.int8_conv`` and
    ``F.relu`` are wrapped for the forward, which also gives the ReLU
    count: F.relu calls, calls with the ReLU folded, and the convs whose
    input is an F.relu output that they do not fold (each must be one of
    SHARED_RELU_CONVS)."""
    seen = {}
    names = {id(m): n for n, m in model.named_modules()}
    relu_outs = {}
    fold = collections.Counter()
    orig, orig_relu = Q.int8_conv, F.relu

    def relu(x, inplace=False):
        y = orig_relu(x, inplace)
        if not fold["inside"]:
            relu_outs[id(y)] = weakref.ref(y)
            fold["relu_calls"] += 1
        return y

    def record(x, conv, *, act_scale=None, relu=False):
        fold["inside"] = 1  # a plain version's own F.relu is not the model's
        try:
            q_x, a_scale = Q.quantize_act(x, act_scale, relu=relu)
        finally:
            fold["inside"] = 0
        kw = Q._s8_args(conv, x)
        args = (q_x, conv.qweight, conv.wscale, a_scale, Q._bias(conv))
        key = (tuple(q_x.shape), tuple(conv.qweight.shape),
               kw["kernel_size"], kw["stride"], kw["padding"],
               kw["dilation"], conv.bias is not None,
               str(kw["out_dtype"]).replace("torch.", ""))
        if key not in seen:
            seen[key] = [args, kw, 0, x, act_scale, relu, 0]
        seen[key][2] += 1
        seen[key][6] += int(relu)
        fold["folded"] += int(relu)
        ref = relu_outs.get(id(x))
        if ref is not None and ref() is x and not relu:
            fold.setdefault("unfolded", []).append(names[id(conv)])
        return Q.conv_s8(*args, **kw)

    Q.int8_conv, F.relu = record, relu
    try:
        with torch.inference_mode():
            model(x)
    finally:
        Q.int8_conv, F.relu = orig, orig_relu
    stray = [n for n in fold.get("unfolded", [])
             if n not in SHARED_RELU_CONVS]
    if stray:
        raise AssertionError(f"phase 20a: int8 convs read an F.relu output "
                             f"without folding the ReLU: {stray}")
    del fold["inside"]
    return seen, dict(fold)


def relu_calls(model, x) -> int:
    """F.relu calls in one forward of ``model`` on ``x``."""
    calls = [0]
    orig = F.relu

    def relu(t, inplace=False):
        calls[0] += 1
        return orig(t, inplace)

    F.relu = relu
    try:
        with torch.inference_mode():
            model(x)
    finally:
        F.relu = orig
    return calls[0]


def int_mm_conv(q_x, qweight, w_scale, a_scale, bias, *, kernel_size,
                stride, padding, dilation, out_dtype):
    """The library's yardstick for ``conv_s8``: an im2col copy of the int8
    input (pad + unfold + one copy), ``torch._int_mm`` (cuBLASLt int8 x
    int8 -> int32; operands zero-padded to its shape rules: M > 16, K
    and N multiples of 8), then the same epilogue. The port never calls
    it."""
    n, c, h, w = q_x.shape
    (kh, kw), (sh, sw), (ph, pw), (dh, dw) = (kernel_size, stride, padding,
                                              dilation)
    xp = F.pad(q_x, (pw, pw, ph, ph))
    cols = xp.unfold(2, dh * (kh - 1) + 1, sh).unfold(
        3, dw * (kw - 1) + 1, sw)[..., ::dh, ::dw]  # (N, C, Ho, Wo, kh, kw)
    ho, wo = cols.shape[2], cols.shape[3]
    a = cols.permute(0, 2, 3, 4, 5, 1).reshape(n * ho * wo, kh * kw * c)
    m, k = a.shape
    cout = qweight.shape[0]
    mp, kp, np_ = max(m, 32), -(-k // 8) * 8, -(-cout // 8) * 8
    a = F.pad(a, (0, kp - k, 0, mp - m))
    b = F.pad(qweight, (0, kp - k, 0, np_ - cout)).t()
    acc = torch._int_mm(a, b)[:m, :cout]
    if out_dtype == torch.int32:
        return acc
    out = acc.to(torch.float32) * (a_scale * w_scale)
    if bias is not None:
        out = out + bias
    return out.to(out_dtype).reshape(n, ho, wo, cout).permute(0, 3, 1, 2)


def cold_copies(t: torch.Tensor, n: int):
    """An endless cycle over ``n`` copies of ``t`` (``t`` itself first)."""
    return itertools.cycle([t] + [t.clone() for _ in range(n - 1)])


def int8_bound_us(key, out_bytes: int) -> tuple[float, float]:
    """(bytes time, operations time) in us of one class: the int8 input
    and weights read once, the scales and bias read, the output written
    once; 2 M N K int8 operations at the data sheet's dense rate."""
    (n, c, h, w), (cout, k) = key[0], key[1]
    kh, kw = key[2]
    ho = (h + 2 * key[4][0] - key[5][0] * (kh - 1) - 1) // key[3][0] + 1
    wo = (w + 2 * key[4][1] - key[5][1] * (kw - 1) - 1) // key[3][1] + 1
    m = n * ho * wo
    nbytes = (n * c * h * w + cout * k + 4 * cout * (2 if key[6] else 1) + 4
              + m * cout * out_bytes)
    return (nbytes / HBM_BYTES_PER_S * 1e6,
            2 * m * cout * k / INT8_OPS_PER_S * 1e6)


def variant_kind(plan) -> str:
    """The plan's variant as INT8_VARIANTS names it."""
    if plan.variant in ("wgmma", "wgmma_tma") and plan.splits > 1:
        return "wgmma split-K"
    return plan.variant


def same_scale(a, b) -> bool:
    """Equal 0-d float scales, a NaN equal to a NaN (an input with a NaN
    has a NaN dynamic scale)."""
    a, b = a.reshape(()), b.reshape(())
    return bool(torch.equal(a, b) or (a.isnan() & b.isnan()))


def quantize_agrees(x, act_scale) -> tuple[float, int]:
    """The quantize kernel's q and scale against its plain version's on
    ``x``, bit for bit, with and without the ReLU, dynamic and static (at
    ``act_scale`` where given, else at half each dynamic scale, so that
    some values clip); and the absmax kernel against its plain version,
    with and without its folded ReLU (what the conv quantizes: ``x``, or
    ``F.relu(x)`` where the ReLU folds in): [max|x|, scale] bit for bit
    (calibration and the grid's dynamic scale read it). Returns
    (max |diff|, static values clipped)."""
    err, clipped = 0.0, 0
    for relu in (False, True):
        q_d, s_d = Q.quantize_act(x, relu=relu)
        r_d, rs_d = Q.quantize_act_reference(x, relu=relu)
        static = act_scale if act_scale is not None else rs_d * 0.5
        q_s, s_s = Q.quantize_act(x, static, relu=relu)
        r_s, rs_s = Q.quantize_act_reference(x, static, relu=relu)
        m_k = Q.act_absmax(x, relu=relu)
        m_p = Q.act_absmax_reference(x, relu=relu)
        torch.cuda.synchronize()
        nhwc = (q_d.permute(0, 2, 3, 1).is_contiguous()
                and q_s.permute(0, 2, 3, 1).is_contiguous())
        pairs = ((s_d, rs_d), (s_s, rs_s), (m_k[0], m_p[0]),
                 (m_k[1], m_p[1]))
        diff = max((q_d.int() - r_d.int()).abs().max().item(),
                   (q_s.int() - r_s.int()).abs().max().item(),
                   *(0.0 if same_scale(a, b) else abs(a.item() - b.item())
                     for a, b in pairs))
        same = (torch.equal(q_d, r_d) and torch.equal(q_s, r_s)
                and all(same_scale(a, b) for a, b in pairs))
        if not (same and nhwc):
            layout = ("channels_last" if x.is_contiguous(
                memory_format=torch.channels_last) else "nchw")
            raise AssertionError(
                f"phase 20a: the quantize or absmax kernel disagrees with "
                f"its plain version at {tuple(x.shape)} {x.dtype} {layout} "
                f"(relu {relu}; max |diff| {diff}, scales {s_d.item()} / "
                f"{rs_d.item()}, absmax {m_k.tolist()} / {m_p.tolist()}, "
                f"NHWC {nhwc})")
        err = max(err, diff)
        clipped += int((r_s.abs() == 127).sum())
    return err, clipped


def check_quantize(x, act_scale, relu: bool) -> dict:
    """Phase 20a's quantize check at one class's real input ``x``
    (``quantize_agrees``); then, with the forward's own ReLU flag, the
    device time of the dynamic and static launches, the plain version's,
    ``torch.quantize_per_tensor``'s (a yardstick: a reciprocal multiply
    and a clip at -128, not the same function) and, where the forward
    folds the ReLU, ``F.relu``'s (the pass the fold took away), beside
    the bytes bound (x read once, int8 written once)."""
    err, clipped = quantize_agrees(x, act_scale)
    layout = ("channels_last" if x.is_contiguous(
        memory_format=torch.channels_last) else "nchw")
    static = (act_scale if act_scale is not None
              else Q.quantize_act_reference(x, relu=relu)[1] * 0.5)
    nbytes = x.numel() * x.element_size()
    xs = cold_copies(x, min(64, -(-COLD_BYTES // max(nbytes, 1))))
    d_us = queued_device_us(lambda: Q.quantize_act(next(xs), relu=relu),
                            INT8_CALLS, "dynamic quantize")
    s_us = queued_device_us(lambda: Q.quantize_act(next(xs), static,
                                                   relu=relu),
                            INT8_CALLS, "static quantize")
    p_us, _ = device_us(lambda: Q.quantize_act_reference(next(xs),
                                                         relu=relu),
                        INT8_PLAIN_CALLS)
    r_us = (queued_device_us(lambda: F.relu(next(xs)), INT8_LIB_CALLS,
                             "F.relu") if relu else 0.0)
    scale = float(static)
    try:
        torch.quantize_per_tensor(x, scale, 0, torch.qint8)
        yard_x = "its input"
    except RuntimeError:  # no bf16 kernel: the yardstick reads a float32 copy
        xs = cold_copies(x.float(), min(64, -(-COLD_BYTES // max(
            4 * x.numel(), 1))))
        yard_x = "a float32 copy"
    l_us, _ = device_us(lambda: torch.quantize_per_tensor(
        next(xs), scale, 0, torch.qint8), INT8_LIB_CALLS)
    del xs
    sms = Q._sm_count(x.device)
    plan_d = Q._quant_plan(x.numel(), x.element_size(), layout, True, sms)
    plan_s = Q._quant_plan(x.numel(), x.element_size(), layout, False, sms)
    return dict(quant_dynamic_us=d_us, quant_static_us=s_us,
                quant_plain_us=p_us, quant_library_us=l_us,
                quant_relu_us=r_us,
                quant_bound_us=(nbytes + x.numel()) / HBM_BYTES_PER_S * 1e6,
                quant_err=err, quant_layout=layout, quant_clipped=clipped,
                quant_relu=relu, quant_library_input=yard_x,
                quant_plan=f"{plan_d.variant}/{plan_d.grid} stash "
                           f"{plan_d.stash_chunks} ring {plan_d.ring} reread "
                           f"{plan_d.reread}; {plan_s.variant}/{plan_s.grid}")


def special_input(shape, dtype, seed: int, specials) -> torch.Tensor:
    """A channels_last input of normal values, negatives and zeros, with
    ``specials`` (NaN, inf, -inf, -0.0) set at seeded places."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g) * 3.0
    x[torch.rand(shape, generator=g) < 0.3] = 0.0
    flat = x.view(-1)
    where = torch.randperm(flat.numel(), generator=g)
    for i, v in enumerate(specials):
        flat[where[i::len(specials) * 97][:3]] = v
    return x.to(dtype).cuda().contiguous(memory_format=torch.channels_last)


def quantize_edges(classes: dict, tag: str) -> dict:
    """Phase 20a's quantize checks beyond the classes' inputs, bit for bit
    as ``quantize_agrees``: the largest class input (above the on-chip
    stash, streamed through the ring and read again), a tiny squeeze-excite
    input, NCHW copies (bf16 and fp32), a misaligned view, and crafted
    inputs with NaN, inf, -inf, -0.0 and negatives, of sizes whose last
    elements are not a whole 16-element unit."""
    inputs = [v[3] for v in classes.values()]
    big = max(inputs, key=torch.Tensor.numel)
    tiny = next(x for x in inputs if x.shape[2:] == (1, 1))
    mids = [x for x in inputs if x.shape[2] >= 32 and x.shape[1] <= 64]
    mid = next((x for x in mids if x.dtype == torch.bfloat16), mids[0])
    flat = torch.randn(mid.numel() + 8, device="cuda",
                       dtype=mid.dtype)[1:1 + mid.numel()]
    n, c, h, w = mid.shape
    cases = {
        "largest": big, "tiny": tiny,
        "nchw": mid.contiguous(),
        "nchw_fp32": mid.float().contiguous(),
        "misaligned": flat.view(n, h, w, c).permute(0, 3, 1, 2),
        "special_finite_fp32": special_input((3, 37, 5, 7), torch.float32,
                                             1, (-0.0,)),
        "special_finite_bf16": special_input((8, 41, 13, 11), torch.bfloat16,
                                             2, (-0.0,)),
        "special_nan_bf16": special_input((8, 41, 13, 11), torch.bfloat16,
                                          3, (float("nan"), -0.0)),
        "special_inf_fp32": special_input((2, 33, 17, 9), torch.float32, 4,
                                          (float("inf"), -0.0)),
        "special_neg_inf_fp32": special_input((2, 33, 17, 9), torch.float32,
                                              5, (float("-inf"),)),
        "special_nan_nchw_fp32": special_input(
            (3, 37, 5, 7), torch.float32, 6,
            (float("nan"), float("inf"))).contiguous(),
    }
    out = {}
    for name, x in cases.items():
        layout = ("channels_last" if x.is_contiguous(
            memory_format=torch.channels_last) else "nchw")
        err, _ = quantize_agrees(x, None)
        plan = Q._quant_plan(x.numel(), x.element_size(), layout, True,
                             Q._sm_count(x.device))
        out[name] = dict(shape=list(x.shape), dtype=str(x.dtype),
                         layout=layout, err=err,
                         plan=f"{plan.variant}/{plan.grid}",
                         reread=plan.reread)
        timed = ""
        if name.startswith("nchw"):  # the NCHW kernels' time, cold L2
            static = Q.quantize_act_reference(x)[1]
            xs = cold_copies(x, min(64, -(-COLD_BYTES // (
                x.numel() * x.element_size()))))
            out[name].update(
                dynamic_us=queued_device_us(lambda: Q.quantize_act(next(xs)),
                                            INT8_CALLS, "NCHW quantize"),
                static_us=queued_device_us(lambda: Q.quantize_act(
                    next(xs), static), INT8_CALLS, "NCHW quantize"),
                bound_us=x.numel() * (x.element_size() + 1)
                / HBM_BYTES_PER_S * 1e6)
            del xs
            timed = (f"; dynamic {out[name]['dynamic_us']:.3f} us, static "
                     f"{out[name]['static_us']:.3f}, bound "
                     f"{out[name]['bound_us']:.3f}")
        print(f"phase 20a: quantize {name} x{tuple(x.shape)} {x.dtype} "
              f"{layout} (dynamic plan {plan.variant}, grid {plan.grid}, "
              f"stash {plan.stash_chunks}, ring {plan.ring}, reread "
              f"{plan.reread} of {x.numel()}): quantize and absmax bit for "
              f"bit, with and without the ReLU, dynamic and static{timed} "
              f"{tag}")
    if "largest" in out and out["largest"]["reread"] == 0:
        raise AssertionError("phase 20a: the largest input fit on chip; "
                             "the ring went unchecked")
    return out


def check_int8_kernel(classes: dict, tag: str) -> dict:
    """Phase 20a: at every shape class, the conv kernel's int32
    accumulators and outputs against its plain version's (max |diff| must
    be 0.0), and the device time per call of the kernel, its plain
    version, the library's ``_int_mm`` yardstick and the bf16 cuDNN conv
    of the same shape, beside the bound; then the quantize kernel on the
    class's real input (``check_quantize``)."""
    rows, worst, kinds = [], 0.0, collections.Counter()
    for key, ((q_x, qw, ws, a_s, bias), kw, count, x, act_scale, relu,
              _) in classes.items():
        n, cin, h, w = q_x.shape
        plan = Q._conv_plan(n, h, w, cin, qw.shape[0], kw["kernel_size"],
                            kw["stride"], kw["padding"], kw["dilation"],
                            sms=Q._sm_count(q_x.device))
        kinds[variant_kind(plan)] += 1
        ref_kw = dict(kw, out_dtype=torch.int32)
        acc_k = Q.conv_s8(q_x, qw, ws, a_s, bias, **ref_kw)
        acc_p = Q.conv_s8_reference(q_x, qw, ws, a_s, bias, **ref_kw)
        out_k = Q.conv_s8(q_x, qw, ws, a_s, bias, **kw)
        out_p = Q.conv_s8_reference(q_x, qw, ws, a_s, bias, **kw)
        lib = int_mm_conv(q_x, qw, ws, a_s, bias, **ref_kw)
        torch.cuda.synchronize()
        err_acc = (acc_k.double() - acc_p.double()).abs().max().item()
        err_out = (out_k.double() - out_p.double()).abs().max().item()
        lib_same = bool(torch.equal(lib.reshape(acc_k.shape[0], -1,
                                                acc_k.shape[1]),
                                    acc_k.permute(0, 2, 3, 1).reshape(
                                        acc_k.shape[0], -1, acc_k.shape[1])))
        worst = max(worst, err_acc, err_out)
        if not (err_acc == 0.0 and err_out == 0.0):
            raise AssertionError(f"phase 20a: the int8 kernel ({plan.name}) "
                                 f"disagrees with its plain version at {key}"
                                 f": accumulators {err_acc}, outputs "
                                 f"{err_out}")
        kh, kwid = kw["kernel_size"]
        w_bf16 = (qw.reshape(-1, kh, kwid, cin).permute(0, 3, 1, 2)
                  .to(torch.bfloat16)
                  .contiguous(memory_format=torch.channels_last))
        b_bf16 = None if bias is None else bias.to(torch.bfloat16)
        # Each call reads another copy of the input, so that the input
        # too is cold in the L2 (up to 64 copies: the smallest stay warm).
        n_copies = min(64, -(-COLD_BYTES // max(q_x.numel(), 1)))
        xs = cold_copies(q_x, n_copies)
        xs_bf16 = cold_copies(q_x.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last), n_copies)
        k_us = queued_device_us(lambda: Q.conv_s8(next(xs), qw, ws, a_s,
                                                  bias, **kw), INT8_CALLS,
                                "int8 conv")
        p_us, _ = device_us(lambda: Q.conv_s8_reference(
            next(xs), qw, ws, a_s, bias, **kw), INT8_PLAIN_CALLS)
        l_us, _ = device_us(lambda: int_mm_conv(next(xs), qw, ws, a_s, bias,
                                                **kw), INT8_LIB_CALLS)
        c_us, _ = device_us(lambda: F.conv2d(
            next(xs_bf16), w_bf16, b_bf16, kw["stride"], kw["padding"],
            kw["dilation"]), INT8_LIB_CALLS)
        del xs, xs_bf16
        t_bytes, t_ops = int8_bound_us(key, out_k.element_size())
        b_us = max(t_bytes, t_ops)
        quant = check_quantize(x, act_scale, relu)
        worst = max(worst, quant["quant_err"])
        rows.append(dict(
            shape=json.loads(class_key(key)), variant=plan.name,
            calls_per_forward=count, device_us=k_us, plain_us=p_us,
            library_us=l_us, cudnn_bf16_us=c_us, bound_us=b_us,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bytes_us=t_bytes, operations_us=t_ops,
            share_of_bound=b_us / k_us, library_equal=lib_same, **quant))
        print(f"phase 20a: int8 conv x{tuple(key[0])} w{tuple(key[1])} "
              f"k{key[2]} s{key[3]} p{key[4]} d{key[5]} bias={key[6]} "
              f"{key[7]} (x{count} a forward), {plan.name} grid "
              f"{plan.grid}: max|diff| acc {err_acc} out {err_out}; kernel "
              f"{k_us:.3f} us, plain {p_us:.3f}, _int_mm {l_us:.3f} (equal "
              f"accumulators {lib_same}), bf16 cuDNN {c_us:.3f}; bound "
              f"{b_us:.3f} us ({rows[-1]['bound_by']}), share "
              f"{b_us / k_us:.4f}; quantize ({quant['quant_layout']} "
              f"{x.dtype}, relu {relu}, plan {quant['quant_plan']}; with "
              f"the absmax, bit for bit with and without the ReLU, "
              f"{quant['quant_clipped']} clipped static): dynamic {quant['quant_dynamic_us']:.3f} us, "
              f"static {quant['quant_static_us']:.3f}, plain "
              f"{quant['quant_plain_us']:.3f}, quantize_per_tensor "
              f"{quant['quant_library_us']:.3f}, F.relu "
              f"{quant['quant_relu_us']:.3f}, bound "
              f"{quant['quant_bound_us']:.3f} {tag}")
        del acc_k, acc_p, out_k, out_p, lib, w_bf16
    missing = [v for v in INT8_VARIANTS if not kinds[v]]
    if missing:
        raise AssertionError(f"phase 20a: no class ran the plan's {missing}")
    return dict(rows=rows, max_abs_err=worst, variants=dict(kinds))


SUMMED = ("device_us", "plain_us", "library_us", "cudnn_bf16_us", "bound_us",
          "bytes_us", "operations_us", "quant_dynamic_us", "quant_static_us",
          "quant_plain_us", "quant_library_us", "quant_bound_us")


def per_forward(rows, counts, relu_counts) -> dict:
    """The kernels', plain versions', yardsticks' and bounds' time summed
    over one forward's calls (``counts``: shape class -> calls), and
    F.relu's over the calls that fold the ReLU in (``relu_counts``)."""
    by = {json.dumps(r["shape"]): r for r in rows}
    tot = collections.Counter()
    for key, n in counts.items():
        r = by[key]
        for f in SUMMED:
            tot[f] += n * r[f]
        tot["calls"] += n
        tot["quant_relu_us"] += relu_counts[key] * r["quant_relu_us"]
        tot["relu_calls"] += relu_counts[key]
    return dict(tot)


def class_key(key) -> str:
    return json.dumps([list(key[0]), list(key[1]), list(key[2]),
                       list(key[3]), list(key[4]), list(key[5]), key[6],
                       key[7]])


def serve_layout(pred, ims) -> dict:
    """One layout's stream over ``ims`` at bs8 (img/s, peak memory) and
    one profiled batch (device operations, busy, idle share); the
    int8 kernel's launches over the stream alone."""
    pred.predict_batch(ims[:SERVE_BATCH])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_int8_counts()
    t0 = time.perf_counter()
    results = list(pred.predict_stream(iter(ims), batch_size=SERVE_BATCH))
    stream_s = time.perf_counter() - t0
    launches = int8_counts()
    peak = torch.cuda.max_memory_allocated()
    if len(results) != len(ims) or not all(
            np.isfinite(r["keypoints"]).all() for r in results):
        raise AssertionError("phase 20b: a layout's stream is incomplete")
    if results[0]["keypoints"].shape != (16, 3):
        raise AssertionError("phase 20b: keypoints of another shape")
    prof = profile_step(lambda _, b: pred.predict_batch(b), None,
                        ims[:SERVE_BATCH])
    batch_s = stream_s / (len(ims) / SERVE_BATCH)
    return dict(img_per_s=len(ims) / stream_s, batch_ms=batch_s * 1e3,
                peak_gib=peak / 2**30,
                idle_share=1.0 - prof["busy_ms"] / (batch_s * 1e3),
                int8_launches=launches, results=results, **prof)


def reset_int8_counts() -> None:
    Q.conv_s8.launches = 0
    Q.quantize_act.launches = 0
    Q.act_absmax.launches = 0


def int8_counts() -> dict:
    """The int8 kernels' launches since ``reset_int8_counts``: the conv,
    the quantize launch, the absmax launch."""
    return dict(conv=Q.conv_s8.launches, quantize=Q.quantize_act.launches,
                absmax=Q.act_absmax.launches)


def check_int8_counts(path: str, got: dict, scale: str | None) -> None:
    """The launch rule of ``path``: none of the three on an fp path
    (``scale`` None); on an int8 path at least one conv and one quantize
    per conv, dynamic or static; an absmax launch per conv under
    calibration (``scale`` "calibrating") and with a grid's dynamic scale
    (``scale`` "grid"), and never while serving on one device."""
    if scale is None:
        ok = not any(got.values())
    else:
        ok = (got["conv"] > 0 and got["quantize"] == got["conv"]
              and got["absmax"] == (got["conv"] if scale in ("calibrating",
                                                             "grid")
                                    else 0))
    if not ok:
        raise AssertionError(f"the {path} path's int8 launches {got} break "
                             f"the rule for "
                             f"{scale or 'an fp path (none)'}")


def agreement(got: list, ref: list, unique=None) -> dict:
    """Share of equal crop labels and the largest keypoint difference (px;
    over the joints whose reference peak is unique, with ``unique``)."""
    share = float(np.mean([np.mean(x["parsing_crop"] == y["parsing_crop"])
                           for x, y in zip(got, ref)]))
    kp = np.stack([np.abs(x["keypoints"][:, :2] - y["keypoints"][:, :2])
                   .max(axis=1) for x, y in zip(got, ref)])
    out = dict(label_share=share, kp_max=float(kp.max()))
    if unique is not None:
        out["kp_max_unique"] = float(kp[unique].max()) if unique.any() else 0.0
    return out


def serving_layouts(tag: str, ctx: dict, serve: dict) -> tuple[dict, dict]:
    """Phase 20: npp_tpu's serving layouts on phase 11's flagship model and
    images. 20a the hand-written int8 conv against its plain version at
    every dense-conv shape class of the unfused and fused int8 forwards at
    bs8, timed beside its bound, ``_int_mm`` and bf16 cuDNN; 20b the
    Predictor in four layouts (unfused, as phase 11; fused necks + cells,
    in turns with it; int8 dynamic; int8 calibrated on CALIB_IMAGES
    images): img/s,
    device operations, busy, idle and peak, fused against unfused in fp32
    and int8 against bf16; 20c the predict CLI (its fused default and
    ``--int8``) and ``eval_lip --synthetic --int8``. Returns (its numbers,
    the int8 conv's and the quantize kernel's entries of the kernels
    line)."""
    model, base, ims = ctx["model"], ctx["pred"], ctx["ims"]
    check_int8_counts("phases 3-11", int8_counts(), None)
    # 20a: the shape classes of both int8 forwards, from real activations.
    canv = torch.from_numpy(np.stack([base.preprocess(im)[0]
                                      for im in ims[:SERVE_BATCH]]))
    x = base._normalize(canv.to(base.device))
    pred_q = Predictor(model, crop_size=(384, 384), quantize="int8")
    classes, fold = int8_classes(pred_q.model, x)
    fq = Predictor(model, crop_size=(384, 384), quantize="int8",
                   fuse_necks=True, fuse_cells=True)
    fused_classes, fused_fold = int8_classes(fq.model, x)
    fold["fp_relu_calls"] = relu_calls(base.model, x)
    fused_fold["fp_relu_calls"] = relu_calls(
        Predictor(model, crop_size=(384, 384), fuse_necks=True,
                  fuse_cells=True).model, x)
    del fq
    for name, f in (("unfused", fold), ("fused", fused_fold)):
        print(f"phase 20a: the {name} int8 forward: {f['folded']} of "
              f"{sum(v[2] for v in (classes if name == 'unfused' else fused_classes).values())} "
              f"dense-conv calls fold the ReLU into the quantize; F.relu "
              f"calls {f['relu_calls']} (the bf16 forward's "
              f"{f['fp_relu_calls']}); convs reading a shared F.relu output "
              f"unfolded: {f.get('unfolded', [])} {tag}")
    counts = {class_key(k): v[2] for k, v in classes.items()}
    fused_counts = {class_key(k): v[2] for k, v in fused_classes.items()}
    relu_counts = {class_key(k): v[6] for k, v in classes.items()}
    fused_relu_counts = {class_key(k): v[6]
                         for k, v in fused_classes.items()}
    merged = dict(fused_classes)
    merged.update(classes)
    print(f"phase 20a: {len(classes)} dense-conv shape classes in the "
          f"unfused int8 forward at bs{SERVE_BATCH} "
          f"({sum(counts.values())} calls), {len(fused_classes)} in the "
          f"fused one ({sum(fused_counts.values())} calls), {len(merged)} in "
          f"all; timing: CUDA events around {INT8_CALLS} calls of a kernel "
          f"({INT8_PLAIN_CALLS} of a plain version, {INT8_LIB_CALLS} of a "
          f"yardstick) queued behind a torch.cuda._sleep, the outputs of the "
          f"last {COLD_RING} kept referenced, each call on another of up to "
          f"64 copies of the input ({COLD_BYTES >> 20} MiB of them) {tag}")
    kernel = check_int8_kernel(merged, tag)
    edges = quantize_edges(merged, tag)
    del merged, classes, fused_classes
    one = per_forward(kernel["rows"], counts, relu_counts)
    one_fused = per_forward(kernel["rows"], fused_counts, fused_relu_counts)
    print(f"phase 20a: per unfused int8 forward at bs{SERVE_BATCH} "
          f"({one['calls']} calls): conv kernel "
          f"{one['device_us'] / 1e3:.4f} ms (the mma.sync design: "
          f"{MMA_SYNC_FORWARD_MS} ms), plain {one['plain_us'] / 1e3:.4f}, "
          f"_int_mm {one['library_us'] / 1e3:.4f}, bf16 cuDNN "
          f"{one['cudnn_bf16_us'] / 1e3:.4f}, bound "
          f"{one['bound_us'] / 1e3:.4f} ms (bytes {one['bytes_us'] / 1e3:.4f}"
          f", operations {one['operations_us'] / 1e3:.4f}); fused forward "
          f"({one_fused['calls']} calls): conv kernel "
          f"{one_fused['device_us'] / 1e3:.4f} ms, bound "
          f"{one_fused['bound_us'] / 1e3:.4f} ms; plan variants over the "
          f"classes {kernel['variants']} {tag}")
    print(f"phase 20a: quantize per unfused int8 forward: dynamic (one "
          f"launch) {one['quant_dynamic_us'] / 1e3:.4f} ms, static "
          f"{one['quant_static_us'] / 1e3:.4f} ms, plain version (dynamic) "
          f"{one['quant_plain_us'] / 1e3:.4f} ms, quantize_per_tensor "
          f"{one['quant_library_us'] / 1e3:.4f} ms, bytes bound "
          f"{one['quant_bound_us'] / 1e3:.4f} ms; F.relu at the "
          f"{one['relu_calls']} calls that fold it (the pass gone) "
          f"{one['quant_relu_us'] / 1e3:.4f} ms; fused forward: dynamic "
          f"{one_fused['quant_dynamic_us'] / 1e3:.4f}, static "
          f"{one_fused['quant_static_us'] / 1e3:.4f} ms {tag}")

    # 20b: the layouts, unfused and fused in turns (unfused, fused, fused,
    # unfused: the host clock drifts between calls), then int8.
    fused = Predictor(model, crop_size=(384, 384), fuse_necks=True,
                      fuse_cells=True)
    runs = {"unfused": base, "fused": fused, "int8_dynamic": pred_q}
    layouts, results, launches = {}, {"unfused": ctx["results"]}, {}
    for name in ("unfused", "fused", "fused", "unfused", "int8_dynamic",
                 "int8_calibrated"):
        if name == "int8_calibrated":
            reset_int8_counts()
            pred_q.calibrate_int8(ims[:CALIB_IMAGES])
            launches["calibrate"] = int8_counts()
            check_int8_counts("calibrate", launches["calibrate"],
                              "calibrating")
            runs[name] = pred_q
        got = serve_layout(runs[name], ims[:LAYOUT_STREAM])
        results.setdefault(name, got.pop("results"))
        check_int8_counts(f"serve_{name}", got["int8_launches"],
                          name[5:] if name.startswith("int8") else None)
        launches[f"serve_{name}"] = got["int8_launches"]
        if name in layouts:  # the second of a pair: both runs kept
            layouts[name]["img_per_s_runs"].append(got["img_per_s"])
            layouts[name]["busy_ms_runs"].append(got["busy_ms"])
        else:
            layouts[name] = dict(got, img_per_s_runs=[got["img_per_s"]],
                                 busy_ms_runs=[got["busy_ms"]])
        print(f"phase 20b: {name}: {got['img_per_s']:.3f} img/s over "
              f"{LAYOUT_STREAM} images at bs{SERVE_BATCH} (phase 11 unfused "
              f"{serve['img_per_s']:.3f}); one profiled batch: "
              f"{got['kernels']} device operations, busy "
              f"{got['busy_ms']:.3f} ms, idle {got['idle_share']:.3f}; peak "
              f"{got['peak_gib']:.3f} GiB; int8 launches over the stream "
              f"{got['int8_launches']}; top {got['top'][:4]} {tag}")
    for name in ("int8_dynamic", "int8_calibrated"):
        a = agreement(results[name], results["unfused"])
        layouts[name]["vs_bf16"] = a
        print(f"phase 20b: {name} against the bf16 unfused stream (seeded "
              f"weights, no bar): crop labels agree on {a['label_share']:.6f}"
              f", keypoints max|diff| {a['kp_max']:.3f} px {tag}")
    a = agreement(results["fused"], results["unfused"])
    layouts["fused"]["vs_unfused_bf16"] = a
    print(f"phase 20b: fused against unfused, bf16: labels "
          f"{a['label_share']:.6f}, keypoints max|diff| {a['kp_max']:.3f} px "
          f"{tag}")
    # Fused against unfused in fp32 (TF32 off since phase 4).
    sub = ims[:LAYOUT_IMAGES]
    model.dtype = fused.model.dtype = torch.float32
    try:
        ref32 = base.predict_batch(sub)
        got32 = fused.predict_batch(sub)
        unique = peak_is_unique(base, sub)
    finally:
        model.dtype = fused.model.dtype = torch.bfloat16
    a = agreement(got32, ref32, unique)
    layouts["fused"]["vs_unfused_fp32"] = a
    print(f"phase 20b: fused against unfused in fp32 on {len(sub)} images: "
          f"crop labels agree on {a['label_share']:.6f} (>= "
          f"{FUSED_LABEL_SHARE}); keypoints max|diff| {a['kp_max']:.3g} px, "
          f"{a['kp_max_unique']:.3g} over the {int(unique.sum())} of "
          f"{unique.size} joints with a unique peak {tag}")
    if not a["label_share"] >= FUSED_LABEL_SHARE:
        raise AssertionError("phase 20b: the fused layout's labels disagree "
                             "with the unfused ones")
    del fused, pred_q, runs, results, got32, ref32
    torch.cuda.empty_cache()

    # 20c: the CLIs.
    cli = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, extra in (("predict", []), ("predict_int8", ["--int8"])):
            reset_int8_counts()
            out = predict.main(["--synthetic", "4", "--out",
                                os.path.join(tmp, name), *extra])
            launches[name] = int8_counts()
            check_int8_counts(name, launches[name],
                              "dynamic" if extra else None)
            ok = (len(out["parsings"]) == 4 and all(
                np.isfinite(k).all() for k in out["keypoints"]))
            print(f"phase 20c: python -m npp_tpu_torch.tools.predict "
                  f"--synthetic 4 {' '.join(extra)}: 4 parsings {ok}; int8 "
                  f"launches {launches[name]} {tag}")
            if not ok:
                raise AssertionError(f"phase 20c: {name} failed")
            cli[name] = dict(parsings=len(out["parsings"]))
    reset_int8_counts()
    heat0 = heatmaps.render_heatmaps.launches
    res = eval_lip.main(["--synthetic", "--int8"])
    launches["eval_int8"] = int8_counts()
    check_int8_counts("eval_int8", launches["eval_int8"], "dynamic")
    heat = heatmaps.render_heatmaps.launches - heat0
    n_valid = valid_pixels()
    print(f"phase 20c: python -m npp_tpu_torch.tools.eval_lip --synthetic "
          f"--int8: {eval_lip.result_line(res)} cm.sum={int(res['cm'].sum())}"
          f" == valid pixels {n_valid}; int8 launches "
          f"{launches['eval_int8']}, heatmap kernel launches {heat} {tag}")
    if not (math.isfinite(res["loss"]) and int(res["cm"].sum()) == n_valid):
        raise AssertionError("phase 20c: the int8 eval CLI failed")
    cli["eval_int8"] = dict(loss=res["loss"], mean_iou=res["mean_iou"])
    entry = {
        "name": "int8_conv", "route": "cuda",
        "source": "npp_tpu_torch/ops/csrc/int8_conv.cu",
        "replaces": "npp_tpu/ops/quantize.py:113 (XLA int8 conv; not a "
                    "Pallas kernel)",
        "launches_by_path": {k: v["conv"] for k, v in launches.items()},
        "max_abs_err": kernel["max_abs_err"],
        "ms": one["device_us"] / 1e3, "plain_ms": one["plain_us"] / 1e3,
        "bound_ms": one["bound_us"] / 1e3,
        "bound_by": ("bytes" if one["bytes_us"] >= one["operations_us"]
                     else "operations"),
        "library_ms": one["library_us"] / 1e3,
        "library": "torch._int_mm on an im2col copy, plus the epilogue",
        "cudnn_bf16_ms": one["cudnn_bf16_us"] / 1e3,
        "unit": f"one unfused flagship int8 forward at bs{SERVE_BATCH} "
                f"({one['calls']} calls)",
        "variants": kernel["variants"],
        "fused_forward": one_fused, "shapes": kernel["rows"]}
    quant_entry = {
        "name": "int8_quantize", "route": "cuda",
        "source": "npp_tpu_torch/ops/csrc/int8_quantize.cu",
        "replaces": "npp_tpu/ops/quantize.py:100-109 (the activation "
                    "quantize, fused by XLA into the int8 conv's producer; "
                    "not a Pallas kernel)",
        "launches_by_path": {k: v["quantize"] + v["absmax"]
                             for k, v in launches.items()},
        "quantize_launches_by_path": {k: v["quantize"]
                                      for k, v in launches.items()},
        "absmax_launches_by_path": {k: v["absmax"]
                                    for k, v in launches.items()},
        "max_abs_err": max([r["quant_err"] for r in kernel["rows"]]
                           + [e["err"] for e in edges.values()]),
        "ms": one["quant_dynamic_us"] / 1e3,
        "static_ms": one["quant_static_us"] / 1e3,
        "relu_ms": one["quant_relu_us"] / 1e3,
        "relu_folded_calls": one["relu_calls"],
        "fused_forward_ms": {"dynamic": one_fused["quant_dynamic_us"] / 1e3,
                             "static": one_fused["quant_static_us"] / 1e3},
        "fold": {"unfused": fold, "fused": fused_fold},
        "edges": edges,
        "plain_ms": one["quant_plain_us"] / 1e3,
        "bound_ms": one["quant_bound_us"] / 1e3, "bound_by": "bytes",
        "library_ms": one["quant_library_us"] / 1e3,
        "library": "torch.quantize_per_tensor (a reciprocal multiply and a "
                   "clip at -128: a yardstick, not the same function)",
        "unit": f"the dynamic scale (one launch) over one unfused "
                f"flagship int8 forward at bs{SERVE_BATCH} ({one['calls']} "
                f"calls); bound: x read once, int8 written once; the absmax "
                f"launches are calibrate_acts' and, on a grid of ranks, the "
                f"dynamic scale's (phase 18b's sp_* paths)"}
    return (dict(layouts=layouts, cli=cli, heatmap_launches=heat), entry,
            quant_entry)


def ppp_batches(device, n_batches: int = 2) -> list:
    """Phase 12's batches: synthetic 128x128 PPP samples (7 classes, 14
    joints) at batch 2, rendered on the card by the heatmap kernel; the
    CPU run gets copies of the same rendered tensors, so the two devices
    score the same targets (the kernel's expf and the CPU's exp may round
    a tied maximum apart)."""
    ds = SyntheticDataset(length=2 * n_batches, crop_size=(128, 128),
                          num_joints=PPP.num_joints,
                          num_classes=PPP.num_classes, seed=SEED,
                          is_train=False, device_normalize=True)
    renderer = L.make_target_renderer(stride=4, sigma=3,
                                      num_joints=PPP.num_joints,
                                      ignore=eval_lip.IGNORE,
                                      normalize_images=True)
    loader = L.DataLoader(ds, 2, device="cuda", num_workers=2,
                          renderer=renderer)
    keep = ("image", "par", "edge", "pose", "pose_aux")
    return [{k: (b[k] if device == "cuda" else b[k].cpu()) for k in keep}
            for b in take(loader, n_batches)]


def check_tiny_ppp(tag: str) -> dict:
    """Phase 12: the tiny PPP eval (make_ppp_eval_step + validate_ppp over
    2 batches) and the pretrained merge on the card against the CPU."""
    model_kw, hp = PPP.train_config(tiny=True)
    cpu_model = build_nppnet(device="cpu", generator=torch.Generator()
                             .manual_seed(SEED), dtype=torch.float32,
                             **model_kw)
    card_model = copy.deepcopy(cpu_model).to("cuda").to(
        memory_format=torch.channels_last)
    runs = {}
    sides = (("card", "cuda", card_model), ("host", "cpu", cpu_model))
    for side, dev, model in sides:
        batches = ppp_batches(dev)
        step = augment_lip.make_eval_step(model, hp, PPP)
        crit = init_criterion_params(2, dev)
        first = step(crit, batches[0])
        res = E.validate_ppp(step, crit, batches, num_classes=7,
                             log_fn=lambda _: None)
        runs[side] = dict(hm=first["pose_hm"].double().cpu(),
                          par=first["par_pred"].cpu(), res=res)
    card, cpu = runs["card"], runs["host"]
    hm_err = ((card["hm"] - cpu["hm"]).abs().max()
              / cpu["hm"].abs().max()).item()
    loss_rel = abs(card["res"]["loss"] - cpu["res"]["loss"]) / abs(
        cpu["res"]["loss"])
    cm_same = np.array_equal(card["res"]["cm"], cpu["res"]["cm"])
    par_same = torch.equal(card["par"], cpu["par"])
    pck_same = np.array_equal(card["res"]["pck"], cpu["res"]["pck"])

    # The pretrained merge of a tiny supernet into the tiny NPPNet.
    smodel_kw, _ = PPP.search_config(tiny=True)
    sn = S.build_search_model(device="cpu", generator=torch.Generator()
                              .manual_seed(SEED + 1), **smodel_kw)
    weights = {k: v.clone() for k, v in sn.state_dict().items()}
    merged = {}
    for side, _, model in sides:
        loaded, skipped = checkpoint.load_pretrained_params(
            model, weights, log_fn=lambda _: None)
        values = all(torch.equal(p.detach().cpu(), weights[n])
                     for n, p in model.named_parameters() if n in loaded)
        merged[side] = (len(loaded), len(skipped), values)
    print(f"phase 12: tiny PPP eval (L=8, C=8, 128x128, 7 classes, 14 "
          f"joints, bs2, fp32, TF32 off), card vs CPU over 2 batches: "
          f"confusion matrices equal {cm_same}, parsing labels of batch 1 "
          f"equal {par_same}; fused heatmaps {hm_err:.3g} of max|ref| (<= "
          f"{PPP_HM_RTOL}); loss {card['res']['loss']:.6f} vs "
          f"{cpu['res']['loss']:.6f}, relative {loss_rel:.3g} (<= "
          f"{TINY_LOSS_RTOL[0]}); PCK vectors equal {pck_same} "
          f"({np.round(card['res']['pck'], 3).tolist()}); pretrained merge "
          f"(supernet L=8 -> NPPNet L=8) loaded / shape-skipped / values "
          f"copied: card {merged['card']}, CPU {merged['host']} {tag}")
    if not (cm_same and par_same and pck_same):
        raise AssertionError("phase 12: confusion matrices, labels or PCK "
                             "vectors differ")
    if not (hm_err <= PPP_HM_RTOL and loss_rel <= TINY_LOSS_RTOL[0]):
        raise AssertionError("phase 12: heatmaps or losses disagree")
    if not (merged["card"] == merged["host"] and merged["card"][2]
            and merged["card"][0] > 0):
        raise AssertionError("phase 12: the pretrained merges differ")
    return dict(hm_rel=hm_err, loss_rel=loss_rel, merge=merged["card"][:2])


def ppp_map_fixtures(root: str, noise: float, rng) -> tuple:
    """Four PPP images with 1-3 persons each: ground truth written as
    ``.mat`` files with ``scipy.io.savemat`` and per-image predictions
    (relative to each person's box corner) with ``noise`` px of error."""
    import scipy.io as scio
    gt_dir = os.path.join(root, "PersonJoints")
    os.makedirs(gt_dir, exist_ok=True)
    names, preds = [f"{noise:g}_{i}" for i in range(4)], {}
    for i, name in enumerate(names):
        n = 1 + i % 3
        joints = np.empty((1, n), dtype=object)
        boxes = np.empty((1, n), dtype=object)
        preds[name] = []
        for k in range(n):
            x0, y0 = rng.uniform(0, 200, 2)
            w, h = rng.uniform(40, 160, 2)
            xy = rng.uniform(0, 1, (14, 2)) * (w, h) + (x0, y0)
            vis = (rng.random(14) > 0.2).astype(np.float64)
            joints[0, k] = np.concatenate([xy, vis[:, None]], 1)
            boxes[0, k] = np.array([[x0, y0, x0 + w, y0 + h]])
            preds[name].append(xy - (x0, y0)
                               + rng.normal(0, noise, (14, 2)))
        scio.savemat(os.path.join(gt_dir, name + ".mat"),
                     {"joints": joints, "boxes": boxes})
    val = os.path.join(root, f"val_{noise:g}.txt")
    with open(val, "w") as f:
        f.write("\n".join(names) + "\n")
    pred_path = os.path.join(root, f"preds_{noise:g}.npy")
    np.save(pred_path, preds, allow_pickle=True)
    return ["--val-list", val, "--gt-dir", gt_dir, "--preds", pred_path], \
        preds, names


def flagship_ppp(tag: str, out_root: str) -> dict:
    """Phase 13: the PPP train slice at the flagship width (L=16, C=64, 7
    classes, 14 joints, batch 2, bf16 + channels_last) through the train
    CLI's functions, validate_ppp, the train and search CLIs with
    ``--dataset ppp``, and eval_ppp_map on .mat fixtures."""
    model_kw, hp = PPP.train_config()
    bs = hp["batch_size"]
    heatmaps.render_heatmaps.launches = 0  # the PPP train path's count
    train_loader, val_loader = augment_lip.build_loaders(hp, "cuda", PPP)
    state = augment_lip.init_state(model_kw, hp, device="cuda",
                                   dtype=torch.bfloat16, seed=SEED,
                                   steps_per_epoch=len(train_loader))
    n_params = sum(p.numel() for p in state.model.parameters())
    step = augment_lip.make_train_step(hp, PPP)
    batches = take(train_loader, 2)
    taken = heatmaps.render_heatmaps.launches
    loss32 = fp32_loss(state, batches[0], hp, PPP.class_weights)
    losses = [step(state, batches[0])["loss"] for _ in range(TRAIN_REPEAT)]
    losses = [x.item() for x in losses]
    rel = abs(losses[0] - loss32) / abs(loss32)
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
    print(f"phase 13: PPP flagship train step (bs{bs}, 384x384, 7 classes, "
          f"14 joints, bf16, channels_last, {n_params:,} parameters): "
          f"heatmap kernel launches for the {len(batches)} batches taken "
          f"{taken}; first loss {losses[0]:.6f} vs fp32 {loss32:.6f}, "
          f"relative {rel:.3g} (<= {BF16_RTOL}); {TRAIN_REPEAT} steps on one "
          f"batch: {['%.4f' % x for x in losses]}; median {step_s * 1e3:.3f} "
          f"ms over {TRAIN_TIMED - 1} warm steps "
          f"({['%.1f' % (t * 1e3) for t in times]} ms) = {bs / step_s:.2f} "
          f"img/s; peak memory {peak / 2**30:.3f} GiB; one profiled step: "
          f"{prof['kernels']} device operations, device busy "
          f"{prof['busy_ms']:.3f} ms, idle share of the median step "
          f"{idle:.3f}; top by device time {prof['top']} {tag}")
    if not all(math.isfinite(x) for x in losses + [loss32]):
        raise AssertionError(f"phase 13: non-finite loss {losses}")
    if not rel <= BF16_RTOL:
        raise AssertionError(f"phase 13: bf16 loss {losses[0]} vs fp32 "
                             f"{loss32}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"phase 13: the loss did not fall: {losses}")
    if taken != len(batches):
        raise AssertionError(f"phase 13: {taken} kernel launches for "
                             f"{len(batches)} train batches")

    # validate_ppp over the 2 val batches, its table printed.
    eval_step = augment_lip.make_eval_step(state.model, hp, PPP)
    res = augment_lip.validate(state, eval_step, val_loader, PPP,
                               log_fn=lambda t: print(
                                   "phase 13: " + t.replace("\n", " | ")))
    n_valid = len(val_loader.dataset) * 384 * 384  # synthetic: no ignore
    print(f"phase 13: validate_ppp over {len(val_loader)} val batches: loss "
          f"{res['loss']:.6f}, mIoU {res['mean_iou']:.4f}, cm.sum "
          f"{int(res['cm'].sum())} == valid pixels {n_valid}, pck shape "
          f"{res['pck'].shape}, PCK avg {res['pck_avg']:.3f} {tag}")
    if not (math.isfinite(res["loss"]) and int(res["cm"].sum()) == n_valid
            and res["pck"].shape == (15,)):
        raise AssertionError("phase 13: validate_ppp failed")
    train_launches = heatmaps.render_heatmaps.launches
    del state, batches, eval_step
    torch.cuda.empty_cache()

    # The CLIs with --dataset ppp.
    heatmaps.render_heatmaps.launches = 0
    out = augment_lip.main(["--synthetic", "--dataset", "ppp", "--steps",
                            "2", "--epochs", "1", "--out", out_root])
    cli_train_launches = heatmaps.render_heatmaps.launches
    r = out["result"]
    print(f"phase 13: python -m npp_tpu_torch.tools.augment_lip --synthetic "
          f"--dataset ppp --steps 2 --epochs 1: train loss "
          f"{out['train_loss']:.6f}, val loss {r['loss']:.6f}, mIoU "
          f"{r['mean_iou']:.4f}, PCK {r['pck_avg']:.3f}; heatmap kernel "
          f"launches {cli_train_launches} {tag}")
    if not (math.isfinite(out["train_loss"]) and math.isfinite(r["loss"])):
        raise AssertionError("phase 13: the PPP train CLI's loss is not "
                             "finite")
    del out
    torch.cuda.empty_cache()
    heatmaps.render_heatmaps.launches = 0  # the PPP search path's count
    out = search_lip.main(["--synthetic", "--dataset", "ppp", "--steps",
                           "1", "--epochs", "1", "--out", out_root])
    genotype = os.path.join(out["out_dir"], "best_genotype.json")
    print(f"phase 13: python -m npp_tpu_torch.tools.search_lip --synthetic "
          f"--dataset ppp --steps 1 --epochs 1 (supernet L="
          f"{out['state'].model.layers}, bs{PPP.search['batch_size']}): "
          f"train loss "
          f"{out['train_loss']:.6f}, {eval_lip.result_line(out['result'])}, "
          f"best_genotype.json written {os.path.isfile(genotype)} {tag}")
    if not (math.isfinite(out["train_loss"]) and os.path.isfile(genotype)
            and out["state"].model.layers == 12):
        raise AssertionError("phase 13: the PPP search CLI failed")

    # A bi-level pair at the PPP search scale: timed and profiled.
    state = out["state"]
    del out
    shp = PPP.search_config()[1]
    train_l, mini_l, _ = search_lip.build_loaders(shp, "cuda", PPP)
    tb, mb = take(train_l, 1)[0], take(mini_l, 1)[0]
    weight_step, arch_step = search_lip.make_search_steps(shp, PPP)

    def pair(st, b):
        m1 = weight_step(st, b[0])
        m2 = arch_step(st, b[1], 1.0)
        return m1["loss"], m2["loss"]

    torch.cuda.synchronize()
    times, pair_losses = [], []
    for _ in range(SEARCH_TIMED):
        t0 = time.perf_counter()
        pair_losses.append([x.item() for x in pair(state, (tb, mb))])
        times.append(time.perf_counter() - t0)
    pair_s = statistics.median(times[1:])
    sprof = profile_step(pair, state, (tb, mb))
    s_idle = 1.0 - sprof["busy_ms"] / (pair_s * 1e3)
    search_launches = heatmaps.render_heatmaps.launches
    print(f"phase 13: PPP search pair (L={PPP.search_model['layers']}, "
          f"C={PPP.search_model['init_channels']}, bs{shp['batch_size']}, "
          f"bf16): losses "
          f"{pair_losses}; median of {SEARCH_TIMED - 1} warm pairs "
          f"{pair_s * 1e3:.3f} ms "
          f"({['%.1f' % (t * 1e3) for t in times]} ms); one profiled pair: "
          f"{sprof['kernels']} device operations, device busy "
          f"{sprof['busy_ms']:.3f} ms, idle share {s_idle:.3f} {tag}")
    if not all(math.isfinite(x) for p in pair_losses for x in p):
        raise AssertionError("phase 13: non-finite PPP search pair loss")
    del state, tb, mb
    torch.cuda.empty_cache()

    # eval_ppp_map on .mat fixtures: exact predictions give AP 1 for every
    # joint; noisy ones the numbers of the port's oks_map in-process.
    rng = np.random.default_rng(SEED)
    maps = {}
    with tempfile.TemporaryDirectory() as tmp:
        for noise in (0.0, 6.0):
            args, preds, names = ppp_map_fixtures(tmp, noise, rng)
            ap = eval_ppp_map.main(args)
            gts = eval_ppp_map.load_gt(os.path.join(tmp, "PersonJoints"),
                                       names)
            maps[noise] = (ap, M.oks_map(preds, gts))
    exact, noisy = maps[0.0][0], maps[6.0]
    print(f"phase 13: python -m npp_tpu_torch.tools.eval_ppp_map on .mat "
          f"fixtures: predictions equal to the GT give AP "
          f"{exact.tolist()}; noisy ones mAP {noisy[0][-1]:.4f}, equal to "
          f"oks_map in-process {np.array_equal(noisy[0], noisy[1])} {tag}")
    if not (np.array_equal(exact, np.ones(15))
            and np.array_equal(noisy[0], noisy[1]) and noisy[0][-1] < 1):
        raise AssertionError("phase 13: eval_ppp_map disagrees")
    return dict(step_ms=step_s * 1e3, img_per_s=bs / step_s,
                peak_gib=peak / 2**30, idle_share=idle,
                loss_rel_bf16=rel, val_loss=res["loss"],
                pck_avg=res["pck_avg"], search_pair_ms=pair_s * 1e3,
                search_kernels=sprof["kernels"],
                search_busy_ms=sprof["busy_ms"], search_idle=s_idle,
                noisy_map=float(noisy[0][-1]), **prof), \
        dict(ppp_train=train_launches + cli_train_launches,
             ppp_search=search_launches)


def chain(tag: str, out_root: str, genotype: str, search_ckpt: str) -> dict:
    """Phase 14: the search -> train -> eval chain on the port's own
    artifacts at the LIP flagship width: the train CLI builds phase 9's
    genotype and merges phase 9's search checkpoint, then the eval CLI
    scores that run's checkpoint; an in-process validate of the restored
    state on the same images and device must give the same loss and
    mIoU."""
    out = augment_lip.main(["--synthetic", "--genotype", genotype,
                            "--pretrained-encoder", search_ckpt, "--steps",
                            "2", "--epochs", "1", "--out", out_root])
    n_tensors = len(list(out["state"].model.parameters()))
    loaded, skipped = out["merged"]
    without = n_tensors - loaded - skipped
    print(f"phase 14: python -m npp_tpu_torch.tools.augment_lip --synthetic "
          f"--genotype <phase 9> --pretrained-encoder <phase 9 checkpoints> "
          f"--steps 2 --epochs 1: pretrained merge {loaded} loaded, "
          f"{skipped} shape-skipped, {without} without a counterpart, of "
          f"{n_tensors} parameter tensors; train loss "
          f"{out['train_loss']:.6f}, {eval_lip.result_line(out['result'])} "
          f"{tag}")
    if not (loaded > 0 and without >= 0 and math.isfinite(out["train_loss"])):
        raise AssertionError("phase 14: the merge or the train run failed")
    ckpt = out["checkpoints"]
    del out
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        csv, js = os.path.join(tmp, "pred.csv"), os.path.join(tmp, "m.json")
        res = eval_lip.main(["--synthetic", "--ckpt", ckpt, "--genotype",
                             genotype, "--pred-csv", csv, "--json-out", js])
        with open(js) as f:
            blob = json.load(f)
        with open(csv) as f:
            rows = len(f.read().splitlines())
    # The restored state, in-process, with the eval CLI's initial lambdas.
    model_kw, hp = LIP.train_config()
    kw = dict(model_kw)
    kw["inter"], kw["fusion"] = load_genotypes(genotype)
    state = augment_lip.init_state(kw, hp, device="cuda",
                                   dtype=torch.bfloat16, seed=SEED + 1,
                                   steps_per_epoch=1)
    restored, _ = checkpoint.CheckpointManager(ckpt).restore_named(state,
                                                                    "best")
    if restored is None:
        checkpoint.CheckpointManager(ckpt).restore(state)
    state.model.eval()
    ref = eval_lip.evaluate_synthetic(state.model, n=N_IMAGES, batch=BATCH,
                                      crop_size=(384, 384), device="cuda",
                                      seed=SEED)
    del state
    same = res["loss"] == ref["loss"] and res["mean_iou"] == ref["mean_iou"]
    keys = {"mean_iou", "pixel_acc", "loss"} <= set(blob)
    print(f"phase 14: python -m npp_tpu_torch.tools.eval_lip --synthetic "
          f"--ckpt <that run> --genotype <phase 9> --pred-csv --json-out: "
          f"loss {res['loss']!r} mIoU {res['mean_iou']!r}; in-process "
          f"validate of the restored state: loss {ref['loss']!r} mIoU "
          f"{ref['mean_iou']!r}; equal {same}; JSON keys {sorted(blob)[:4]}.. "
          f"present {keys}; CSV rows {rows} for {len(res['names'])} images "
          f"{tag}")
    if not (same and keys and rows == len(res["names"]) == N_IMAGES):
        raise AssertionError("phase 14: the eval CLI disagrees with the "
                             "restored state, or its outputs are wrong")
    return dict(merge=(loaded, skipped, without, n_tensors),
                eval_loss=res["loss"], eval_miou=res["mean_iou"])


def write_lip_tree(root: str, records: list, rng) -> str:
    """A LIP directory as ``config.LIP.data`` lays it out, from the
    committed fixtures: LIP_TRAIN train and LIP_VAL val entries that reuse
    the fixture JPEGs and grey PNG labels under distinct names, with
    ``joint_self`` (MPII order, about one joint in seven at (0, 0), so not
    visible) and ``objpos`` drawn from ``rng``; every annotation file the
    preset names (the search's ``_w`` and ``_a`` sets are the train
    entries, the test set is the val one) and the pose GT CSV of the val
    entries. Returns the GT CSV's path."""
    layout = LIP.data
    entries = {}
    for split, n in (("train", LIP_TRAIN), ("val", LIP_VAL)):
        im_dir = os.path.join(root, layout[f"{split}_imroot"])
        seg_dir = os.path.join(root, layout[f"{split}_segroot"])
        os.makedirs(im_dir)
        os.makedirs(seg_dir)
        annos = []
        for i in range(n):
            rec = records[i % len(records)]
            name = f"{split}_{i:04d}"
            shutil.copyfile(os.path.join(FIXTURES, rec["image"]),
                            os.path.join(im_dir, f"{name}.jpg"))
            shutil.copyfile(os.path.join(FIXTURES, rec["label"]),
                            os.path.join(seg_dir, f"{name}.png"))
            h, w = rec["height"], rec["width"]
            joints = np.stack([rng.uniform(0.2 * w, 0.8 * w, 16),
                               rng.uniform(0.05 * h, 0.95 * h, 16),
                               np.ones(16)], 1)
            joints[rng.random(16) < 0.15] = 0.0
            # upper neck (8) and head top (9) set a head size for PCKh
            joints[8] = [w / 2, 0.2 * h, 1]
            joints[9] = [w / 2, 0.06 * h, 1]
            annos.append({"im_name": f"{name}.jpg",
                          "joint_self": joints.tolist(),
                          "objpos": [w / 2 + rng.uniform(-0.05, 0.05) * w,
                                     h / 2 + rng.uniform(-0.05, 0.05) * h],
                          "scale_provided": 1.0})
        entries[split] = annos
    os.makedirs(os.path.join(root, "jsons"))
    for key, split in (("train_set", "train"), ("search_train_set", "train"),
                       ("search_mini_set", "train"), ("val_set", "val"),
                       ("search_val_set", "val"), ("test_set", "val")):
        with open(os.path.join(root, layout[key]), "w") as f:
            json.dump({"root": entries[split]}, f)
    gt = os.path.join(root, "pose_gt.csv")
    with open(gt, "w") as f:
        for a in entries["val"]:
            cells = [a["im_name"].split(".")[0]]
            for x, y, v in a["joint_self"]:
                cells += [repr(x), repr(y), str(int(v))]
            f.write(",".join(cells) + "\n")
    return gt


def write_ppp_tree(root: str, n_train: int, n_val: int, rng) -> dict:
    """A Pascal-Person-Part directory as ``config.PPP.data`` lays it out,
    from the committed fixtures: ``n_train`` and ``n_val`` ids that reuse
    the JPEGs and grey part labels under distinct names. Each id but the
    last of each list has 1-3 GT persons side by side (a pose ``.mat`` of
    boxes and 14 joints, some not visible) and a Mask-R-CNN-style
    ``.npy``: one person instance close to each GT box but the last when
    there are two or more (that GT has none to match: cost 1 > 0.3), and
    one non-person instance on the first GT's box (which would match it
    exactly); masks are ellipses in the boxes, bool or uint8 by turns.
    The last id of each list has its ``.npy`` but no ``.mat``. Returns
    per split the db entries this implies, and the counts of unmatched
    GTs, non-person instances and ids without a ``.mat``."""
    import scipy.io as scio

    layout = PPP.data
    with open(os.path.join(PPP_FIXTURES, "fixtures.json")) as f:
        records = json.load(f)
    for key in ("train_imroot", "val_imroot", "train_segroot",
                "val_segroot", "pose_root", "mask_root"):
        os.makedirs(os.path.join(root, layout[key]), exist_ok=True)
    out = {}
    for split, n in (("train", n_train), ("val", n_val)):
        ids, implied, unmatched = [], 0, 0
        for i in range(n):
            rec = records[i % len(records)]
            name = f"{split}_{i:04d}"
            ids.append(name)
            shutil.copyfile(os.path.join(FIXTURES, rec["image"]), os.path.join(
                root, layout[f"{split}_imroot"], name + ".jpg"))
            shutil.copyfile(os.path.join(PPP_FIXTURES, rec["label"]),
                            os.path.join(root, layout[f"{split}_segroot"],
                                         name + ".png"))
            h, w = rec["height"], rec["width"]
            n_gt = int(rng.integers(1, 4))
            slot = w / n_gt
            gt_boxes, gt_joints = [], []
            for k in range(n_gt):
                x1 = k * slot + rng.uniform(0, 0.1) * slot
                x2 = (k + 1) * slot - rng.uniform(0, 0.1) * slot
                y1, y2 = rng.uniform(0, 0.15) * h, rng.uniform(0.85, 1) * h
                gt_boxes.append(np.array([[x1, y1, x2, y2]]))
                gt_joints.append(np.stack(
                    [rng.uniform(x1 + 2, x2 - 2, 14),
                     rng.uniform(y1 + 2, y2 - 2, 14),
                     rng.choice([0.0, 1.0, 2.0], 14, p=[0.15, 0.7, 0.15])],
                    1))
            matched = n_gt - 1 if n_gt > 1 else n_gt
            inst = [b[0] + rng.uniform(-2, 2, 4) for b in gt_boxes[:matched]]
            classes = [0] * matched + [15]
            inst.append(gt_boxes[0][0].copy())
            order = rng.permutation(len(inst))
            yy, xx = np.mgrid[0:h, 0:w]
            masks = np.stack([
                ((xx - (b[0] + b[2]) / 2) / ((b[2] - b[0]) / 2)) ** 2
                + ((yy - (b[1] + b[3]) / 2) / ((b[3] - b[1]) / 2)) ** 2 <= 1
                for b in inst])[order]
            np.save(os.path.join(root, layout["mask_root"], name + ".npy"),
                    {"pred_classes": np.array(classes)[order],
                     "boxes": np.array(inst, np.float32)[order],
                     "pred_masks": masks if i % 2 else masks.astype(
                         np.uint8)})
            if i == n - 1:
                continue  # masks, but no .mat: skipped
            cells = [np.empty((1, n_gt), object) for _ in range(2)]
            for k in range(n_gt):
                cells[0][0, k], cells[1][0, k] = gt_boxes[k], gt_joints[k]
            scio.savemat(os.path.join(root, layout["pose_root"],
                                      name + ".mat"),
                         {"boxes": cells[0], "joints": cells[1]})
            implied += matched
            unmatched += n_gt - matched
        with open(os.path.join(root, layout[f"{split}_set"]), "w") as f:
            f.write("\n".join(ids) + "\n")
        out[split] = dict(entries=implied, unmatched_gt=unmatched,
                          non_person=n - 1, without_mat=1)
    return out


def reader_stages(root: str) -> dict:
    """Mean ms per sample of each stage of the train reader, run one after
    another on the first STAGE_SAMPLES train entries: decode, scale,
    rotate, crop, flip, and the label chain (PNG read + nearest scale,
    warp, crop, flip)."""
    ds = lip.dataset_for(LIP.data, "train", root, crop_size=(384, 384),
                         is_train=True, seed=SEED, **LIP.reader)
    rng = np.random.default_rng(SEED)
    t = collections.defaultdict(float)
    for item in ds.anno_list[:STAGE_SAMPLES]:
        name = item["im_name"]
        t0 = time.perf_counter()
        im = vis.read_image(os.path.join(ds.im_root, name))
        t1 = time.perf_counter()
        im_s, scale = A.augmentation_scale(im, 1.0, crop_size=384.0, rng=rng,
                                           scale_min=ds.scale_min,
                                           scale_max=ds.scale_max)
        t2 = time.perf_counter()
        im_r, rot = A.augmentation_rotate(
            im_s, max_rotate_degree=ds.max_rotate_degree, rng=rng)
        t3 = time.perf_counter()
        center = np.array([item["objpos"]], np.float64) * scale
        center = A.rotate_coords(center, center, rot)[1]
        im_c, crop = A.augmentation_cropped(
            im_r, center, crop_x=384, crop_y=384,
            max_center_trans=ds.max_center_trans, rng=rng)
        t4 = time.perf_counter()
        _, flip = A.augmentation_flip(im_c, flip_prob=ds.flip_prob, rng=rng)
        t5 = time.perf_counter()
        TG.gen_parsing_target(
            lip.read_label_png(os.path.join(ds.parsing_anno_root,
                                            name.split(".")[0] + ".png")),
            scale_param=scale, rotate_param=[rot, im_r.shape[1],
                                             im_r.shape[0]],
            crop_param=[crop, 384, 384], flip_param=flip, stride=1,
            flip_pairs=ds.flip_pairs)
        t6 = time.perf_counter()
        for k, (a, b) in zip(("decode", "scale", "rotate", "crop", "flip",
                              "labels"),
                             ((t0, t1), (t1, t2), (t2, t3), (t3, t4),
                              (t4, t5), (t5, t6))):
            t[k] += (b - a) * 1e3 / STAGE_SAMPLES
    return dict(t)


def reader_rate(ds, workers: int, batch: int = 16) -> float:
    """Samples/s of one epoch of the reader ``ds`` through the loader
    (``workers`` threads, ``batch``, pinned copies to the card, no target
    rendering)."""
    loader = L.DataLoader(ds, batch, device="cuda", shuffle=True,
                          drop_last=True, num_workers=workers)
    t0 = time.perf_counter()
    n = sum(b["image"].shape[0] for b in loader)
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0)


def lip_reader(root: str, **kw):
    """The train LIPDataset of the tree at 384x384 with the preset's
    augmentation (``kw``: ``cls`` for the fused reader, overrides)."""
    return lip.dataset_for(LIP.data, "train", root, **{
        **dict(crop_size=(384, 384), is_train=True, seed=SEED,
               device_normalize=True), **LIP.reader, **kw})


def fused_stages(root: str) -> dict:
    """Mean ms per sample, on one thread over the first STAGE_SAMPLES
    train entries, of the fused reader's JPEG decode, its label PNG read,
    and the rest of a whole sample (the fused warp of image and labels,
    the joints, the Python around them)."""
    ds = lip_reader(root, cls=lip.FastLIPDataset)
    t = collections.defaultdict(float)
    for i, item in enumerate(ds.anno_list[:STAGE_SAMPLES]):
        t0 = time.perf_counter()
        vis.read_image(os.path.join(ds.im_root, item["im_name"]))
        t1 = time.perf_counter()
        lip.read_label_png(os.path.join(ds.parsing_anno_root,
                                        item["im_name"].split(".")[0]
                                        + ".png"))
        t2 = time.perf_counter()
        ds[i]
        t3 = time.perf_counter()
        for k, v in (("decode", t1 - t0), ("label_png", t2 - t1),
                     ("rest", (t3 - t2) - (t2 - t0))):
            t[k] += v * 1e3 / STAGE_SAMPLES
    return dict(t)


def fed_steps(step, state, loader, epochs: int, limit: int = 0):
    """The train loop fed by ``loader`` over ``epochs`` epochs (each cut
    at ``limit`` steps when given): per step its seconds from ``next()``
    to the synchronised step, its seconds in ``next()``, and its loss."""
    steps, waits, losses = [], [], []
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        it = iter(loader)
        try:
            for _ in range(limit or len(loader)):
                t0 = time.perf_counter()
                batch = next(it, None)
                t1 = time.perf_counter()
                if batch is None:
                    break
                losses.append(step(state, batch)["loss"].item())
                torch.cuda.synchronize()
                steps.append(time.perf_counter() - t0)
                waits.append(t1 - t0)
        finally:
            it.close()
    return steps, waits, losses


def lip_from_disk(tag: str, out_root: str, root: str) -> dict:
    """Phase 15: the LIP reader beside the card. The host library is
    built and each fixture decodes to its recorded SHA-256; a LIP tree is
    written from the fixtures into ``root`` (phase 16 reads it too); the
    reader is timed alone (8 threads and 1, stage by stage); the flagship
    train step (L=16, C=64, bs16, bf16 + channels_last) runs fed from the
    tree, timed with the loop's wait on the loader; then the train, eval,
    test, search and predict CLIs read the tree (the fixtures, for
    predict)."""
    t0 = time.perf_counter()
    lib_path, _ = imgproc.build_library()
    build_s = time.perf_counter() - t0
    with open(os.path.join(FIXTURES, "fixtures.json")) as f:
        records = json.load(f)
    bad = [r["image"] for r in records if hashlib.sha256(imgproc.read_jpeg(
        os.path.join(FIXTURES, r["image"])).tobytes()).hexdigest()
        != r["sha256"]]
    print(f"phase 15: host library {lib_path.name} ({build_s:.2f} s to build "
          f"or find: phase 22c builds it first); "
          f"{len(records) - len(bad)} of {len(records)} fixture JPEGs "
          f"({sorted({r['sampling'] for r in records})}, restart intervals "
          f"{sorted({r['restart'] for r in records})}) decode to their "
          f"recorded SHA-256 {tag}")
    if bad or not records:
        raise AssertionError(f"phase 15: decodes differ from the recorded "
                             f"hashes: {bad}")

    gt = write_lip_tree(root, records, np.random.default_rng(SEED))

    # The reader alone.
    cpus = os.cpu_count()
    rates = {w: reader_rate(lip_reader(root), w) for w in (8, 1)}
    stages = reader_stages(root)
    print(f"phase 15: reader alone (train LIPDataset, 384x384 crops, one "
          f"epoch of {LIP_TRAIN} samples through the loader at bs16): "
          f"{rates[8]:.3f} samples/s with 8 threads, {rates[1]:.3f} with 1; "
          f"os.cpu_count() {cpus}, affinity {len(os.sched_getaffinity(0))}; "
          f"mean ms per sample by stage "
          f"{json.dumps({k: round(v, 3) for k, v in stages.items()})} "
          f"{tag}")

    # The flagship train step fed from the tree.
    model_kw, hp = LIP.train_config()
    bs = hp["batch_size"]
    train_loader, _ = augment_lip.build_loaders(hp, "cuda", LIP, root, SEED)
    state = augment_lip.init_state(model_kw, hp, device="cuda",
                                   dtype=torch.bfloat16, seed=SEED,
                                   steps_per_epoch=len(train_loader))
    step = augment_lip.make_train_step(hp)
    first = take(train_loader, 1)[0]
    loss32 = fp32_loss(state, first, hp)
    loss0 = step(state, first)["loss"].item()
    rel = abs(loss0 - loss32) / abs(loss32)
    n0 = heatmaps.render_heatmaps.launches
    steps, waits, losses = fed_steps(step, state, train_loader, LIP_EPOCHS)
    launched = heatmaps.render_heatmaps.launches - n0
    step_s = statistics.median(steps[1:])
    wait_share = sum(waits[1:]) / sum(steps[1:])
    print(f"phase 15: flagship train step from the LIP tree (bs{bs}, "
          f"384x384, bf16, channels_last, reader seed {SEED}): first loss "
          f"{loss0:.6f} vs fp32 {loss32:.6f}, relative {rel:.3g} (<= "
          f"{BF16_RTOL}); {len(steps)} steps over {LIP_EPOCHS} epochs, "
          f"losses {['%.4f' % x for x in losses]}; median step "
          f"{step_s * 1e3:.3f} ms over {len(steps) - 1} warm steps "
          f"({['%.1f' % (t * 1e3) for t in steps]} ms) = {bs / step_s:.2f} "
          f"img/s; waiting in next() "
          f"{['%.1f' % (t * 1e3) for t in waits]} ms, {wait_share:.3f} of "
          f"the warm steps' time; heatmap kernel launches {launched} for "
          f"{len(steps)} steps {tag}")
    if not all(math.isfinite(x) for x in [loss0, *losses]):
        raise AssertionError(f"phase 15: non-finite loss {losses}")
    if not rel <= BF16_RTOL:
        raise AssertionError(f"phase 15: bf16 loss {loss0} vs fp32 {loss32}")
    if launched != len(steps) or len(steps) < 6:
        raise AssertionError(f"phase 15: {launched} kernel launches for "
                             f"{len(steps)} steps")
    del state, first, train_loader
    torch.cuda.empty_cache()

    # The CLIs on the tree.
    cli = {}
    # One step (3 before phase 23 came): the val set is one batch either way.
    out = augment_lip.main(["--data-root", root, "--gt-csv", gt, "--steps",
                            "1", "--epochs", "1", "--out", out_root])
    r = out["result"]
    print(f"phase 15: python -m npp_tpu_torch.tools.augment_lip --data-root "
          f"<tree> --gt-csv <tree> --steps 1 --epochs 1: train loss "
          f"{out['train_loss']:.6f}, {eval_lip.result_line(r)} {tag}")
    if not (math.isfinite(out["train_loss"]) and math.isfinite(r["loss"])
            and math.isfinite(r["pck_avg"])):
        raise AssertionError("phase 15: the train CLI failed on the tree")
    ckpt = out["checkpoints"]
    cli["augment_lip"] = dict(train_loss=out["train_loss"], val=r["loss"])
    del out
    torch.cuda.empty_cache()
    res = eval_lip.main(["--data-root", root, "--gt-csv", gt, "--ckpt", ckpt])
    print(f"phase 15: python -m npp_tpu_torch.tools.eval_lip --data-root "
          f"<tree> --gt-csv <tree> --ckpt <that run>: "
          f"{eval_lip.result_line(res)} {tag}")
    if not (len(res["names"]) == LIP_VAL and math.isfinite(res["loss"])
            and math.isfinite(res["mean_iou"])
            and math.isfinite(res["pck_avg"])):
        raise AssertionError("phase 15: the eval CLI failed on the tree")
    cli["eval_lip"] = dict(loss=res["loss"], miou=res["mean_iou"],
                           pckh=res["pck_avg"])
    res = test_lip.main(["--data-root", root, "--mode", "testval", "--limit",
                         "4"])
    print(f"phase 15: python -m npp_tpu_torch.tools.test_lip --data-root "
          f"<tree> --mode testval --limit 4: mIoU {res['mean_iou']:.4f}, "
          f"cm.sum {int(res['cm'].sum())} {tag}")
    if not (int(res["cm"].sum()) > 0 and math.isfinite(res["mean_iou"])):
        raise AssertionError("phase 15: the test CLI failed on the tree")
    cli["test_lip"] = dict(miou=res["mean_iou"])
    out = search_lip.main(["--data-root", root, "--gt-csv", gt, "--steps",
                           "1", "--epochs", "2", "--warmup-epochs", "1",
                           "--out", out_root])
    genotype = os.path.join(out["out_dir"], "best_genotype.json")
    print(f"phase 15: python -m npp_tpu_torch.tools.search_lip --data-root "
          f"<tree> --gt-csv <tree> --steps 1 --epochs 2 --warmup-epochs 1: "
          f"train loss {out['train_loss']:.6f}, "
          f"{eval_lip.result_line(out['result'])}, best_genotype.json "
          f"written {os.path.isfile(genotype)} {tag}")
    if not (math.isfinite(out["train_loss"]) and os.path.isfile(genotype)):
        raise AssertionError("phase 15: the search CLI failed on the tree")
    cli["search_lip"] = dict(train_loss=out["train_loss"])
    del out
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out = predict.main(["--images", os.path.join(FIXTURES, "*.jpg"),
                            "--out", tmp])
        ok = len(out["names"]) == len(records) and all(
            p.shape == (r["height"], r["width"])
            for p, r in zip(out["parsings"], records))
    print(f"phase 15: python -m npp_tpu_torch.tools.predict --images "
          f"'tests/fixtures/torch_lip/*.jpg': {len(out['names'])} JPEGs "
          f"served, parsings at the images' sizes {ok} {tag}")
    if not ok:
        raise AssertionError("phase 15: the predict CLI failed on the JPEGs")
    return dict(build_s=build_s, samples_per_s_8=rates[8],
                samples_per_s_1=rates[1], cpu_count=cpus, stage_ms=stages,
                step_ms=step_s * 1e3, img_per_s=bs / step_s,
                wait_share=wait_share, loss_rel_bf16=rel, cli=cli)


def ppp_and_fused_from_disk(tag: str, out_root: str, lip_root: str,
                            parity: dict) -> tuple[dict, dict]:
    """Phase 16: the PPP reader and the fused warp beside the card. A PPP
    tree is written from the fixtures and its db held to the count the
    construction implies; the PPP reader is timed alone; the PPP flagship
    train step (L=16, C=64, 7 classes, 14 joints, bs2, bf16 +
    channels_last) runs fed from the tree, then validate_ppp over its val
    set. On phase 15's LIP tree (``lip_root``; ``parity`` holds phase
    15's numbers) the fused reader is timed alone, held against the
    parity reader in eval mode and its uint8 path against its float32
    one, and feeds the flagship bs16 train step. Then the train CLI reads
    the PPP tree and, with ``--fast-aug``, the LIP tree. Returns the
    numbers and the heatmap kernel's launches on the PPP-from-disk and
    fused-LIP paths."""
    launches = {}
    root = os.path.join(os.path.dirname(lip_root), "ppp")
    implied = write_ppp_tree(root, PPP_TRAIN, PPP_VAL,
                             np.random.default_rng(SEED))
    common = dict(crop_size=(384, 384), seed=SEED, device_normalize=True,
                  **PPP.reader)
    train_ds = pascal.dataset_for(PPP.data, "train", root, is_train=True,
                                  **common)
    val_ds = pascal.dataset_for(PPP.data, "val", root, is_train=False,
                                **common)
    counts = {"train": len(train_ds), "val": len(val_ds)}
    print(f"phase 16: PPP tree of {PPP_TRAIN} train and {PPP_VAL} val ids "
          f"from the fixtures: build_ppp_db gives {counts} persons, the "
          f"construction implies "
          f"{ {k: v['entries'] for k, v in implied.items()} } (dropped "
          f"unmatched GTs { {k: v['unmatched_gt'] for k, v in implied.items()} }, "
          f"non-person instances filtered, one id per list without a "
          f".mat) {tag}")
    if any(counts[k] != implied[k]["entries"] for k in counts):
        raise AssertionError("phase 16: build_ppp_db's count differs from "
                             "the tree's")

    # The PPP reader alone.
    ppp_rates = {w: reader_rate(train_ds, w, batch=2) for w in (8, 1)}
    print(f"phase 16: PPP reader alone (train PPPDataset, 384x384 crops, "
          f"one epoch of {len(train_ds)} persons through the loader at "
          f"bs2): {ppp_rates[8]:.3f} samples/s with 8 threads, "
          f"{ppp_rates[1]:.3f} with 1 {tag}")

    # The PPP flagship train step fed from the tree, then validate_ppp.
    heatmaps.render_heatmaps.launches = 0  # the PPP-from-disk path's count
    model_kw, hp = PPP.train_config()
    bs = hp["batch_size"]
    train_loader, val_loader = augment_lip.build_loaders(hp, "cuda", PPP,
                                                         root, SEED)
    state = augment_lip.init_state(model_kw, hp, device="cuda",
                                   dtype=torch.bfloat16, seed=SEED,
                                   steps_per_epoch=len(train_loader))
    step = augment_lip.make_train_step(hp, PPP)
    first = take(train_loader, 1)[0]
    loss32 = fp32_loss(state, first, hp, PPP.class_weights)
    loss0 = step(state, first)["loss"].item()
    rel = abs(loss0 - loss32) / abs(loss32)
    n0 = heatmaps.render_heatmaps.launches
    steps, waits, losses = fed_steps(step, state, train_loader, 1,
                                     PPP_STEPS)
    launched = heatmaps.render_heatmaps.launches - n0
    ppp_step_s = statistics.median(steps[1:])
    ppp_wait = sum(waits[1:]) / sum(steps[1:])
    print(f"phase 16: PPP flagship train step from the tree (bs{bs}, "
          f"384x384, 7 classes, 14 joints, bf16, channels_last, reader seed "
          f"{SEED}): first loss {loss0:.6f} vs fp32 {loss32:.6f}, relative "
          f"{rel:.3g} (<= {BF16_RTOL}); losses "
          f"{['%.4f' % x for x in losses]}; median step "
          f"{ppp_step_s * 1e3:.3f} ms over {len(steps) - 1} warm steps "
          f"({['%.1f' % (t * 1e3) for t in steps]} ms) = "
          f"{bs / ppp_step_s:.2f} img/s; waiting in next() "
          f"{['%.1f' % (t * 1e3) for t in waits]} ms, {ppp_wait:.3f} of the "
          f"warm steps' time; heatmap kernel launches {launched} for "
          f"{len(steps)} steps {tag}")
    if not all(math.isfinite(x) for x in [loss0, loss32, *losses]):
        raise AssertionError(f"phase 16: non-finite PPP loss {losses}")
    if not rel <= BF16_RTOL:
        raise AssertionError(f"phase 16: bf16 loss {loss0} vs fp32 {loss32}")
    if launched != len(steps) or len(steps) != PPP_STEPS:
        raise AssertionError(f"phase 16: {launched} kernel launches for "
                             f"{len(steps)} PPP steps")
    eval_step = augment_lip.make_eval_step(state.model, hp, PPP)
    res = augment_lip.validate(state, eval_step, val_loader, PPP,
                               log_fn=lambda t: print(
                                   "phase 16: " + t.replace("\n", " | ")))
    n_valid = int(sum((val_ds[i]["par"] != eval_lip.IGNORE).sum()
                      for i in range(len(val_ds))))
    print(f"phase 16: validate_ppp over the val tree ({len(val_ds)} persons, "
          f"{len(val_loader)} batches): loss {res['loss']:.6f}, mIoU "
          f"{res['mean_iou']:.4f}, cm.sum {int(res['cm'].sum())} == valid "
          f"pixels {n_valid}, pck shape {res['pck'].shape}, PCK avg "
          f"{res['pck_avg']:.3f} {tag}")
    if not (math.isfinite(res["loss"]) and int(res["cm"].sum()) == n_valid
            and res["pck"].shape == (15,)
            and np.isfinite(res["pck"]).all()):
        raise AssertionError("phase 16: validate_ppp failed on the tree")
    del state, first, eval_step, train_loader, val_loader
    torch.cuda.empty_cache()
    # One step (3 before phase 23 came): one val batch either way.
    out = augment_lip.main(["--dataset", "ppp", "--data-root", root,
                            "--steps", "1", "--epochs", "1", "--out",
                            out_root])
    r = out["result"]
    print(f"phase 16: python -m npp_tpu_torch.tools.augment_lip --dataset "
          f"ppp --data-root <PPP tree> --steps 1 --epochs 1: train loss "
          f"{out['train_loss']:.6f}, val loss {r['loss']:.6f}, mIoU "
          f"{r['mean_iou']:.4f}, PCK avg {r['pck_avg']:.3f} {tag}")
    if not (math.isfinite(out["train_loss"]) and math.isfinite(r["loss"])
            and r["pck"].shape == (15,)):
        raise AssertionError("phase 16: the train CLI failed on the PPP tree")
    ppp_cli = dict(train_loss=out["train_loss"], val=r["loss"])
    launches["ppp_disk"] = heatmaps.render_heatmaps.launches
    del out
    torch.cuda.empty_cache()

    # The fused reader on phase 15's LIP tree.
    fast = lambda **kw: lip_reader(lip_root, cls=lip.FastLIPDataset, **kw)
    fast_rates = {w: reader_rate(fast(), w) for w in (8, 1)}
    stages = fused_stages(lip_root)
    print(f"phase 16: fused-warp reader alone (train FastLIPDataset, "
          f"384x384, one epoch of {LIP_TRAIN} samples at bs16): "
          f"{fast_rates[8]:.3f} samples/s with 8 threads, "
          f"{fast_rates[1]:.3f} with 1; the parity LIPDataset in phase 15 "
          f"of this run: {parity['samples_per_s_8']:.3f} and "
          f"{parity['samples_per_s_1']:.3f}; mean ms per fused sample "
          f"{json.dumps({k: round(v, 3) for k, v in stages.items()})} "
          f"{tag}")
    # Eval mode against the parity reader (tests/test_data.py:168-190's
    # bounds: the geometry alike, labels apart at region borders only,
    # bilinear against two cubic resamplings). One departure, npp_tpu's
    # own: its fused reader takes the crop's end as start + crop size,
    # the parity reader as int(centre + crop / 2), one less where the
    # start int(centre - crop / 2) truncates a negative fraction towards
    # 0; so the crop and store ends may both be one apart.
    ref, ours = (lip.dataset_for(LIP.data, "val", lip_root, cls=cls,
                                 crop_size=(384, 384), is_train=False)
                 for cls in (lip.LIPDataset, lip.FastLIPDataset))
    worst = dict(joints=0.0, agree=1.0, image=0.0, crop_end_apart=0)
    for i in range(len(ref)):
        a, b = ref[i], ours[i]
        d = (b["crop_param"] - a["crop_param"])[0]
        end_ok = all(d[k] == d[k + 2] in (0, 1) for k in (4, 5))
        worst["crop_end_apart"] += int(d[4:].any())
        if not (end_ok and not d[:4].any()
                and np.allclose(b["scale"], a["scale"], rtol=1e-6)):
            raise AssertionError(f"phase 16: fused eval geometry differs at "
                                 f"{a['name']}: {a['crop_param']} vs "
                                 f"{b['crop_param']}")
        worst["joints"] = max(worst["joints"], float(
            np.abs(b["joints"] - a["joints"]).max()))
        worst["agree"] = min(worst["agree"],
                             float((a["par"] == b["par"]).mean()))
        worst["image"] = max(worst["image"], float(
            np.abs(a["image"] - b["image"]).mean()))
    # The uint8 path against the float32 one on the same train draws
    # (tests/test_data.py:82-103's bound: half a uint8 step).
    u8, f32 = fast(device_normalize=True), fast(device_normalize=False)
    half_step = 0.5 / 255.0 / float(IMAGENET_STD.min()) + 1e-5
    u8_err, u8_labels = 0.0, True
    for i in range(STAGE_SAMPLES):
        a, b = u8[i], f32[i]
        renorm = (a["image"].astype(np.float32) / 255.0 - IMAGENET_MEAN) \
            / IMAGENET_STD
        u8_err = max(u8_err, float(np.abs(renorm - b["image"]).max()))
        u8_labels &= bool(np.array_equal(a["par"], b["par"]))
    print(f"phase 16: fused vs parity reader in eval mode over {len(ref)} "
          f"val entries: crop starts equal, the ends one apart (npp_tpu's "
          f"rule) in {worst['crop_end_apart']}; joints max|diff| "
          f"{worst['joints']:.3g} px (<= "
          f"1e-2), labels agree on >= {worst['agree']:.4f} (> 0.9), mean "
          f"|image diff| <= {worst['image']:.4f} (< 0.2); uint8 vs float32 "
          f"path over {STAGE_SAMPLES} train draws: labels equal {u8_labels}, "
          f"max|diff| {u8_err:.3g} (< {half_step:.3g}) {tag}")
    if not (worst["joints"] <= 1e-2 and worst["agree"] > 0.9
            and worst["image"] < 0.2 and u8_labels and u8_err < half_step):
        raise AssertionError("phase 16: the fused reader disagrees")

    # The flagship LIP bs16 train step fed by the fused reader.
    heatmaps.render_heatmaps.launches = 0  # the fused-LIP path's count
    model_kw, hp = LIP.train_config()
    bs = hp["batch_size"]
    train_loader, _ = augment_lip.build_loaders(hp, "cuda", LIP, lip_root,
                                                SEED, fast_aug=True)
    state = augment_lip.init_state(model_kw, hp, device="cuda",
                                   dtype=torch.bfloat16, seed=SEED,
                                   steps_per_epoch=len(train_loader))
    step = augment_lip.make_train_step(hp)
    steps, waits, losses = fed_steps(step, state, train_loader, LIP_EPOCHS)
    launched = heatmaps.render_heatmaps.launches
    fast_step_s = statistics.median(steps[1:])
    fast_wait = sum(waits[1:]) / sum(steps[1:])
    print(f"phase 16: flagship train step fed by the fused reader (bs{bs}, "
          f"384x384, bf16, channels_last): losses "
          f"{['%.4f' % x for x in losses]}; median step "
          f"{fast_step_s * 1e3:.3f} ms over {len(steps) - 1} warm steps "
          f"({['%.1f' % (t * 1e3) for t in steps]} ms), waiting in next() "
          f"{['%.1f' % (t * 1e3) for t in waits]} ms, {fast_wait:.3f} of the "
          f"warm steps' time; phase 15's parity reader: "
          f"{parity['step_ms']:.3f} ms, {parity['wait_share']:.3f}; heatmap "
          f"kernel launches {launched} for {len(steps)} steps {tag}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"phase 16: non-finite loss {losses}")
    if launched != len(steps) or len(steps) < 6:
        raise AssertionError(f"phase 16: {launched} kernel launches for "
                             f"{len(steps)} fused-reader steps")
    del state, train_loader
    torch.cuda.empty_cache()
    # One step (3 before phase 23 came).
    out = augment_lip.main(["--fast-aug", "--data-root", lip_root, "--steps",
                            "1", "--epochs", "1", "--out", out_root])
    print(f"phase 16: python -m npp_tpu_torch.tools.augment_lip --fast-aug "
          f"--data-root <LIP tree> --steps 1 --epochs 1: train loss "
          f"{out['train_loss']:.6f}, {eval_lip.result_line(out['result'])} "
          f"{tag}")
    if not (math.isfinite(out["train_loss"])
            and math.isfinite(out["result"]["loss"])):
        raise AssertionError("phase 16: the --fast-aug train CLI failed")
    launches["lip_fast_disk"] = heatmaps.render_heatmaps.launches
    fast_cli = dict(train_loss=out["train_loss"], val=out["result"]["loss"])
    del out
    torch.cuda.empty_cache()
    return dict(
        ppp_db=counts, ppp_samples_per_s_8=ppp_rates[8],
        ppp_samples_per_s_1=ppp_rates[1], ppp_step_ms=ppp_step_s * 1e3,
        ppp_wait_share=ppp_wait, ppp_loss_rel_bf16=rel,
        ppp_val=dict(loss=res["loss"], miou=res["mean_iou"],
                     pck_avg=res["pck_avg"]), ppp_cli=ppp_cli,
        fast_samples_per_s_8=fast_rates[8],
        fast_samples_per_s_1=fast_rates[1], fast_stage_ms=stages,
        fast_vs_parity=worst,
        fast_u8_err=u8_err, fast_step_ms=fast_step_s * 1e3,
        fast_wait_share=fast_wait, fast_cli=fast_cli), launches


# Phase 17: data parallelism. 17a: two gloo ranks sharing the card
# against one process; 17b: NCCL at world size 1, the DDP step timed and
# the train, eval and search CLIs under torchrun.
SHARED_WORLD = 2          # gloo ranks on cuda:0
SHARED_TIMEOUT_S = 420    # a rank that has not ended by then fails the phase
GO_TIMEOUT_S = 900        # a rank waits that long for the word to take its
                          # timed flagship step (``wait_file``)
SHARED_STEPS = 2          # DDP train steps against the one-process run
# 17a's bounds are tests/test_torch_parallel.py's where they carry over:
# the first step's losses and lambda gradients at rtol 1e-5, its running
# stats at 1e-4 x max|ref| + STATS_ATOL, its weights by Adam's first step
# (lr * g / (|g| + eps) of each side's gradient). Its gradients are held
# by phase 6's rule (TINY_GRAD_TENSOR, TINY_GRAD_NORM), set for this
# configuration: at L=8 and 128x128 the deepest maps are smaller than at
# the test's L=4, 64x64, and the fp32 gradients keep fewer digits (the
# test's tighter rule gave 1.54 and a norm of 0.011 here, on the CPU).
# Later steps as phase 6: losses at TINY_LOSS_RTOL, lambdas at
# TINY_LAMDA_ATOL. The search pair's losses at test_torch_search.py's
# (weight step 1e-5, arch step 1e-3); the arch step alone from the seeded
# state: its loss at 1e-5, its architecture gradients by phase 6's rule
# and their update by Adam's first-step rule with the arch Adam's L2
# decay. The card's backward is not bit-stable (atomics), so ZeRO is
# held to plain DDP by the same first-step rules and RESUME_RTOL after.
N_SHARED_VAL = 5          # validate's set: two ranks do not divide it
DDP_TIMED = 1             # timed DDP steps (after a warm-up one; 5 before
                          # phase 22 came, 3 before phase 23)
SHARED_TIMED = 1          # 17a's timed flagship steps a rank


def shard_batch(device, seed: int, rank: int, world: int, n: int = 4):
    """Rank ``rank``'s contiguous share of phase 6's batch of ``n`` (the
    global batch is the ranks' shares in rank order), uploaded and
    rendered on ``device`` (the heatmap kernel on the card)."""
    ds = SyntheticDataset(length=n, crop_size=augment_lip.TINY_TRAIN["crop"],
                          seed=seed, device_normalize=True)
    host = L.collate([ds[i] for i in range(n)])
    gain = np.linspace(0.25, 1.0, n, dtype=np.float32)
    host["image"] = (host["image"] * gain[:, None, None, None]).astype(
        np.uint8)
    host["par"][1, :32, :60] = eval_lip.IGNORE  # the shards' ignored
    host["par"][3, 80:, :90] = eval_lip.IGNORE  # pixels differ
    share = slice(rank * n // world, (rank + 1) * n // world)
    keys = ("image", "par", "joints", "visibility")
    batch = {k: torch.from_numpy(np.ascontiguousarray(host[k][share]))
             .to(device) for k in keys}
    renderer = L.make_target_renderer(stride=4, sigma=eval_lip.SIGMA,
                                      num_joints=eval_lip.NUM_JOINTS,
                                      ignore=eval_lip.IGNORE,
                                      normalize_images=True)
    batch.update(renderer(*(batch[k] for k in keys)))
    return batch


def train_snapshot(state) -> dict:
    cpu = lambda t: t.detach().float().cpu().clone()
    return {"params": {n: cpu(p) for n, p in state.model.named_parameters()},
            "grads": {n: cpu(p.grad)
                      for n, p in state.model.named_parameters()},
            "stats": {n: cpu(t) for n, t in state.model.state_dict().items()
                      if "running" in n},
            "lamdas": {k: cpu(p) for k, p in state.lamdas.items()},
            "lamda_grads": {k: cpu(p.grad) for k, p in state.lamdas.items()}}


def shared_card_work(device, group) -> dict:
    """17a's work, run by each gloo rank (``group``) and by the one
    process (``group=None``) on the same card: SHARED_STEPS tiny fp32
    train steps under DDP (and, on the ranks, under ZeRO-1), one search
    pair, ``validate`` and ``validate_ppp`` at batch 1 over
    N_SHARED_VAL images. Each rank takes its share of the batch of 4."""
    rank, world = ((0, 1) if group is None else
                   (dist.get_rank(group), dist.get_world_size(group)))
    hp = augment_lip.TINY_TRAIN
    out = {}
    for zero in ((False, True) if group is not None else (False,)):
        state = augment_lip.init_state(eval_lip.TINY, hp, device=device,
                                       dtype=torch.float32, seed=SEED,
                                       steps_per_epoch=1, group=group,
                                       zero=zero)
        step = augment_lip.make_train_step(hp)
        losses, first = [], None
        for i in range(SHARED_STEPS):
            losses.append(step(state, shard_batch(device, SEED + i, rank,
                                                  world))["loss"].item())
            if i == 0:
                first = train_snapshot(state)
        out["zero" if zero else "ddp"] = dict(
            losses=losses, first=first, last=train_snapshot(state))
        del state
    shp = search_lip.TINY_SEARCH
    sstate = search_lip.init_state(search_lip.TINY_SEARCH_MODEL, shp,
                                   device=device, dtype=torch.float32,
                                   seed=SEED, steps_per_epoch=1, group=group)
    weight_step, arch_step = search_lip.make_search_steps(shp)
    m1 = weight_step(sstate, shard_batch(device, SEED + 10, rank, world))
    m2 = arch_step(sstate, shard_batch(device, SEED + 11, rank, world), 1.0)
    out["search"] = dict(losses=[m1["loss"].item(), m2["loss"].item()],
                         entropy=m2["entropy"].item())
    # The arch step alone, from the seeded state: its gradients and the
    # arch Adam's first update are held against the one process's.
    sstate = search_lip.init_state(search_lip.TINY_SEARCH_MODEL, shp,
                                   device=device, dtype=torch.float32,
                                   seed=SEED, steps_per_epoch=1, group=group)
    arch = sstate.model.arch_parameters()
    seeded = {k: p.detach().cpu().clone() for k, p in arch.items()}
    m = arch_step(sstate, shard_batch(device, SEED + 11, rank, world), 1.0)
    out["arch_step"] = dict(
        loss=m["loss"].item(), seeded=seeded,
        params={k: p.detach().cpu().clone() for k, p in arch.items()},
        grads={k: p.grad.detach().cpu().clone() for k, p in arch.items()})
    del sstate, arch
    for name, preset in (("validate", LIP), ("validate_ppp", PPP)):
        model_kw = dict(eval_lip.TINY, num_classes=preset.num_classes,
                        num_joints=preset.num_joints)
        model = build_nppnet(device=device, dtype=torch.float32,
                             generator=torch.Generator().manual_seed(SEED),
                             **model_kw)
        ds = SyntheticDataset(length=N_SHARED_VAL, crop_size=(128, 128),
                              num_joints=preset.num_joints,
                              num_classes=preset.num_classes, seed=SEED,
                              is_train=False, device_normalize=True)
        renderer = L.make_target_renderer(stride=4, sigma=eval_lip.SIGMA,
                                          num_joints=preset.num_joints,
                                          ignore=eval_lip.IGNORE,
                                          normalize_images=True)
        loader = L.DataLoader(ds, 1, device=device, num_workers=1,
                              renderer=renderer)
        crit = init_criterion_params(2, device)
        kw = dict(num_classes=preset.num_classes,
                  class_weights=preset.class_weights,
                  ignore_index=eval_lip.IGNORE)
        if preset is LIP:
            res = E.validate(E.make_eval_step(model, decode_hw=(128, 128),
                                              **kw),
                             crit, loader, num_classes=preset.num_classes)
            out[name] = dict(cm=res["cm"], loss=res["loss"],
                             preds=res["pose_preds"], names=res["names"])
        else:
            res = E.validate_ppp(E.make_ppp_eval_step(model, **kw), crit,
                                 loader, num_classes=preset.num_classes,
                                 log_fn=lambda s: None)
            out[name] = dict(cm=res["cm"], loss=res["loss"], pck=res["pck"])
    return out


def timed_train_step(step, state, batches, n: int) -> dict:
    """``n`` train steps over ``batches`` after a warm-up one: their
    median (host clock after ``synchronize``), each step's ms, one
    profiled step (``profile_step``), the idle share and the peak
    memory."""
    step(state, batches[0])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(n):
        t0 = time.perf_counter()
        loss = step(state, batches[i % len(batches)])["loss"]
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if not math.isfinite(loss.item()):
        raise AssertionError("non-finite train loss")
    step_s = statistics.median(times)
    prof = profile_step(step, state, batches[0])
    return dict(step_ms=step_s * 1e3, times_ms=[x * 1e3 for x in times],
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                idle_share=1.0 - prof["busy_ms"] / (step_s * 1e3), **prof)


def shared_card_flagship(device, group) -> dict:
    """17a: the flagship bf16 channels_last train step at the preset's
    batch split over the ranks (bs8 a rank), with the cross-rank BN and
    the global criterion, timed and profiled on this rank."""
    hp = dict(augment_lip.FLAGSHIP_TRAIN,
              batch_size=augment_lip.FLAGSHIP_TRAIN["batch_size"]
              // dist.get_world_size(group))
    train_loader, _ = augment_lip.build_loaders(hp, device)
    batches = take(train_loader, 2)
    state = augment_lip.init_state(
        eval_lip.FLAGSHIP, hp, device=device, dtype=torch.bfloat16,
        seed=SEED, steps_per_epoch=len(train_loader), group=group)
    out = timed_train_step(augment_lip.make_train_step(hp), state, batches,
                           SHARED_TIMED)
    out["batch"] = hp["batch_size"]
    return out


def pair_rank(rank: int, port: int, out_dir: str, spawned: float) -> None:
    """A rank of phases 17a and 18 (spawned at ``spawned``,
    ``time.time()``): joins the gloo group of SHARED_WORLD ranks on
    cuda:0 through torchrun's variables, runs ``shared_card_work`` and
    ``shared_card_flagship`` and saves their results and its heatmap
    kernel launches, then runs ``sp_work`` and saves its results."""
    line_buffered()
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(SHARED_WORLD),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if not mesh.initialize_distributed("cuda:0", backend="gloo"):
        raise RuntimeError("the gloo group did not start")
    try:
        started = time.time() - spawned
        t0 = time.perf_counter()
        heatmaps.render_heatmaps.launches = 0
        out = shared_card_work("cuda:0", mesh.data_group())
        work_s = time.perf_counter() - t0
        wait_file(os.path.join(out_dir, "flagship.go"), GO_TIMEOUT_S)
        out["flagship"] = shared_card_flagship("cuda:0", mesh.data_group())
        out["launches"] = heatmaps.render_heatmaps.launches
        out["seconds"] = {"start": round(started, 1),
                          "tiny": round(work_s, 1),
                          "flagship (after the go)": round(
                              time.perf_counter() - t0 - work_s, 1)}
        save_atomic(out, os.path.join(out_dir, f"rank{rank}_17a.pt"))
        del out
        torch.cuda.empty_cache()
        out = sp_work("cuda:0", os.path.join(out_dir, "sp.go"))
        save_atomic(out, os.path.join(out_dir, f"rank{rank}_18.pt"))
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def grad_rule(got: dict, ref: dict) -> tuple:
    """(worst per-tensor ratio of phase 6's rule, its tensor, norm error)
    of ``got`` against ``ref``."""
    model_max = max(r.abs().max().item() for r in ref.values())
    worst, key, sq_d, sq_r = 0.0, "", 0.0, 0.0
    for n, r in ref.items():
        d = (got[n].double() - r.double())
        share = d.abs().max().item() / (r.abs().max().item()
                                        + 1e-4 * model_max)
        if share > worst:
            worst, key = share, n
        sq_d += float((d * d).sum())
        sq_r += float((r.double() ** 2).sum())
    return worst, key, (sq_d / sq_r) ** 0.5


def adam_first_step_err(got: dict, ref: dict, lr: float,
                        decay: float = 0.0) -> float:
    """The worst share of Adam's first-step bound: weights from equal
    seeded values differ by lr * |u(g) - u(g_ref)| (u(g) = g / (|g| +
    eps)) plus rounding. With an L2 ``decay``, g is the gradient plus
    decay x the seeded value (``ref["seeded"]``), as Adam adds it."""
    worst = 0.0
    u = lambda g: g.double() / (g.double().abs() + 1e-8)
    for n, w in ref["params"].items():
        g, g_ref = got["grads"][n].double(), ref["grads"][n].double()
        if decay:
            g = g + decay * ref["seeded"][n].double()
            g_ref = g_ref + decay * ref["seeded"][n].double()
        bound = (lr * (u(g) - u(g_ref)).abs()
                 + 1e-7 + 1e-6 * w.double().abs())
        worst = max(worst, ((got["params"][n].double() - w.double()).abs()
                            / bound).max().item())
    return worst


def stats_err(got: dict, ref: dict) -> float:
    return max(((got[n] - r).abs().max().item()
                / (r.abs().max().item() * 1e-4 + STATS_ATOL))
               for n, r in ref.items())


class RankPair:
    """The SHARED_WORLD (= SP_WORLD) gloo ranks on cuda:0 that phases 17a
    and 18 share (``pair_rank``; one spawn, one start for both): each
    rank saves its 17a results, then runs phase 18's work and saves
    those. Before phase 23 came, 17a and 18 each spawned a pair."""

    def __init__(self):
        self.tmp = tempfile.TemporaryDirectory()
        self.spawned = time.time()
        port = free_port()
        ctx = torch.multiprocessing.get_context("spawn")
        self.procs = [ctx.Process(target=pair_rank,
                                  args=(r, port, self.tmp.name, self.spawned))
                      for r in range(SHARED_WORLD)]
        for p in self.procs:
            p.start()

    def go(self, part: str = "17a") -> None:
        """Let the ranks take 17a's timed flagship step (after 17b's CLIs,
        which run beside their tiny work, have ended) or, with ``part``
        "18", phase 18's timed sections (after phase 14, 23c's train CLI,
        phase 18's one-process references and test_lip --mesh, and phase
        19's tiny steps have ended)."""
        name = "flagship.go" if part == "17a" else "sp.go"
        open(os.path.join(self.tmp.name, name), "w").close()

    def stop(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join()
        self.tmp.cleanup()

    def results(self, part: str, timeout: float) -> list:
        """Every rank's results of ``part`` ("17a" or "18"), waiting up to
        ``timeout`` seconds; a rank that exits without them, or the
        timeout, stops the pair and fails the phase. After "18" the ranks
        must exit 0."""
        paths = [os.path.join(self.tmp.name, f"rank{r}_{part}.pt")
                 for r in range(SHARED_WORLD)]
        deadline = time.monotonic() + timeout
        while not all(os.path.exists(x) for x in paths):
            if (time.monotonic() > deadline
                    or any(p.exitcode is not None for p in self.procs)):
                codes = [p.exitcode for p in self.procs]
                self.stop()
                raise AssertionError(f"phase {part}: the ranks gave no "
                                     f"results (exit codes {codes})")
            time.sleep(0.2)
        out = [torch.load(x, weights_only=False) for x in paths]
        if part == "18":
            for p in self.procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()))
            codes = [p.exitcode for p in self.procs]
            self.stop()
            if codes != [0] * SHARED_WORLD:
                raise AssertionError(f"phase 18: the ranks exited with "
                                     f"{codes}")
        return out


def wait_file(path: str, timeout: float) -> None:
    """Wait for ``path`` to exist (a rank waits so for the main process's
    word that the card is quiet enough for its timed flagship step)."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise RuntimeError(f"no {os.path.basename(path)} in {timeout} s")
        time.sleep(0.2)


def save_atomic(obj, path: str) -> None:
    """``torch.save`` to ``path`` by way of a temporary name, so that a
    reader polling for ``path`` never sees it half written."""
    torch.save(obj, path + ".part")
    os.replace(path + ".part", path)


def shared_card(tag: str, train: dict, pair: RankPair,
                before_flagship=None) -> tuple[dict, int]:
    """17a: SHARED_WORLD gloo ranks share cuda:0 (``pair``), the tiny
    configuration in fp32 with TF32 off at batch 2 a rank, against one
    process at batch 4 on the same card fed the ranks' batches
    concatenated in rank order; then each rank's flagship bf16 step at
    bs8, beside phase 7's unwrapped bs16 step (``train``), once
    ``before_flagship()`` (the one-process run's follow-up, if given) has
    returned. Returns the numbers and the ranks' heatmap kernel
    launches."""
    torch.backends.cudnn.allow_tf32 = False  # as in the ranks
    torch.backends.cuda.matmul.allow_tf32 = False
    one = shared_card_work("cuda", None)  # the one-process run, meanwhile
    if before_flagship is not None:
        before_flagship()
    pair.go()
    ranks = pair.results("17a", SHARED_TIMEOUT_S)
    print(f"phase 17a: seconds by section, per rank (start: from the spawn "
          f"to the group) {[r['seconds'] for r in ranks]}")
    lr = augment_lip.TINY_TRAIN["lr"]
    ddp = [r["ddp"] for r in ranks]
    # Both ranks hold the same state after every step.
    for part in ("first", "last"):
        for field in ("params", "stats", "lamdas", "grads"):
            for n, t in ddp[0][part][field].items():
                if not torch.equal(t, ddp[1][part][field][n]):
                    raise AssertionError(f"phase 17a: the ranks' {field} "
                                         f"{n} differ after the {part} step")
    ref = one["ddp"]
    mean_losses = [statistics.mean(r["losses"][i] for r in ddp)
                   for i in range(SHARED_STEPS)]
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(mean_losses,
                                                   ref["losses"])]
    loss_tol = (1e-5,) + TINY_LOSS_RTOL[1:]
    g_worst, g_key, g_norm = grad_rule(ddp[0]["first"]["grads"],
                                       ref["first"]["grads"])
    lg_rel = max(((ddp[0]["first"]["lamda_grads"][k] - r).abs()
                  / r.abs()).max().item()
                 for k, r in ref["first"]["lamda_grads"].items())
    s1 = stats_err(ddp[0]["first"]["stats"], ref["first"]["stats"])
    w1 = adam_first_step_err(ddp[0]["first"], ref["first"], lr)
    lam3 = max((ddp[0]["last"]["lamdas"][k] - r).abs().max().item()
               for k, r in ref["last"]["lamdas"].items())
    print(f"phase 17a: {SHARED_WORLD} gloo ranks sharing cuda:0 at bs2 "
          f"each vs one process at bs4 (tiny L=8, C=8, 128x128, fp32, TF32 "
          f"off), {SHARED_STEPS} DDP train steps: mean losses "
          f"{['%.6f' % x for x in mean_losses]} vs "
          f"{['%.6f' % x for x in ref['losses']]}, relative "
          f"{['%.3g' % x for x in loss_rel]} (<= {loss_tol}); step 1: "
          f"gradients worst tensor {g_worst:.3g} (<= {TINY_GRAD_TENSOR}; "
          f"{g_key}), norm {g_norm:.3g} (<= {TINY_GRAD_NORM}); lambda "
          f"gradients "
          f"{lg_rel:.3g} (<= 1e-5); running stats {s1:.3g} of 1e-4 x "
          f"max|ref| + {STATS_ATOL}; weights {w1:.3g} of Adam's first-step "
          f"bound; after step {SHARED_STEPS}: lambdas {lam3:.3g} (<= "
          f"{TINY_LAMDA_ATOL}) {tag}")
    if not all(r <= t for r, t in zip(loss_rel, loss_tol)):
        raise AssertionError("phase 17a: DDP losses differ")
    if not (g_worst <= TINY_GRAD_TENSOR and g_norm <= TINY_GRAD_NORM
            and lg_rel <= 1e-5 and s1 <= 1.0 and w1 <= 1.0):
        raise AssertionError("phase 17a: the first DDP step differs")
    if not lam3 <= TINY_LAMDA_ATOL:
        raise AssertionError("phase 17a: the DDP run drifted")

    # ZeRO-1 against plain DDP on the same ranks.
    zero = ranks[0]["zero"]
    z_loss = [abs(a - b) / abs(b) for a, b in zip(zero["losses"],
                                                ddp[0]["losses"])]
    zg_worst, _, zg_norm = grad_rule(zero["first"]["grads"],
                                     ddp[0]["first"]["grads"])
    zw1 = adam_first_step_err(zero["first"], ddp[0]["first"], lr)
    print(f"phase 17a: --zero vs plain DDP: losses relative "
          f"{['%.3g' % x for x in z_loss]} (first 0, then <= {RESUME_RTOL}); "
          f"step-1 gradients {zg_worst:.3g} (<= {TINY_GRAD_TENSOR}), norm "
          f"{zg_norm:.3g} (<= {TINY_GRAD_NORM}); weights {zw1:.3g} of "
          f"Adam's first-step bound "
          f"{tag}")
    if not (z_loss[0] == 0.0 and max(z_loss) <= RESUME_RTOL
            and zg_worst <= TINY_GRAD_TENSOR and zg_norm <= TINY_GRAD_NORM
            and zw1 <= 1.0):
        raise AssertionError("phase 17a: ZeRO differs from plain DDP")

    # The search pair.
    srch = [r["search"] for r in ranks]
    s_mean = [statistics.mean(s["losses"][i] for s in srch) for i in (0, 1)]
    s_rel = [abs(a - b) / abs(b) for a, b in zip(s_mean,
                                                one["search"]["losses"])]
    e_rel = abs(srch[0]["entropy"] - one["search"]["entropy"]) / abs(
        one["search"]["entropy"])
    arch = [r["arch_step"] for r in ranks]
    for k in ("params", "grads"):
        for n, t in arch[0][k].items():
            if not torch.equal(t, arch[1][k][n]):
                raise AssertionError(f"phase 17a: the ranks' arch {k} {n} "
                                     f"differ")
    a1 = one["arch_step"]
    al_rel = abs(statistics.mean(a["loss"] for a in arch) - a1["loss"]) / abs(
        a1["loss"])
    ag_worst, ag_key, ag_norm = grad_rule(arch[0]["grads"], a1["grads"])
    aw = adam_first_step_err(arch[0], a1, search_lip.TINY_SEARCH["alpha_lr"],
                             decay=S.ALPHA_WEIGHT_DECAY)
    print(f"phase 17a: search pair (L=8, C=8, bs2 a rank vs bs4): mean "
          f"losses {s_mean} vs {one['search']['losses']}, relative "
          f"{['%.3g' % x for x in s_rel]} (<= (1e-5, 1e-3)); entropy "
          f"{e_rel:.3g} (<= {ENTROPY_RTOL}); the arch step alone from the "
          f"seeded state: loss {al_rel:.3g} (<= 1e-5), architecture "
          f"gradients worst tensor {ag_worst:.3g} (<= {TINY_GRAD_TENSOR}; "
          f"{ag_key}), norm {ag_norm:.3g} (<= {TINY_GRAD_NORM}), "
          f"architecture parameters {aw:.3g} of Adam's first-step bound "
          f"with the L2 decay {tag}")
    if not (s_rel[0] <= 1e-5 and s_rel[1] <= 1e-3 and e_rel <= ENTROPY_RTOL
            and al_rel <= 1e-5 and ag_worst <= TINY_GRAD_TENSOR
            and ag_norm <= TINY_GRAD_NORM and aw <= 1.0):
        raise AssertionError("phase 17a: the DDP search pair differs")

    # validate and validate_ppp: one result on both ranks, the
    # predictions in dataset order equal to the one-process pass's.
    for name in ("validate", "validate_ppp"):
        a, b = ranks[0][name], ranks[1][name]
        for k in a:
            same = (np.array_equal(a[k], b[k]) if k != "names"
                    else a[k] == b[k])
            if not same:
                raise AssertionError(f"phase 17a: {name}'s {k} differs "
                                     f"between the ranks")
    v, v1 = ranks[0]["validate"], one["validate"]
    ds = SyntheticDataset(length=N_SHARED_VAL, crop_size=(128, 128),
                          seed=SEED, is_train=False, device_normalize=True)
    pred_err = float(np.abs(v["preds"] - v1["preds"]).max())
    cm_extra = int(v["cm"].sum() - v1["cm"].sum())
    dup = int((ds[0]["par"] != eval_lip.IGNORE).sum())
    print(f"phase 17a: validate over {N_SHARED_VAL} images at bs1 a rank: "
          f"equal on both ranks; names {v['names'] == ds.image_names()} in "
          f"dataset order; predictions {pred_err:.3g} px from the one "
          f"process's (<= {KP_ATOL}); the summed matrix counts the padding "
          f"duplicate's {cm_extra} pixels (image 0: {dup}); validate_ppp "
          f"equal on both ranks, PCK avg "
          f"{ranks[0]['validate_ppp']['pck'][0]:.2f} "
          f"{tag}")
    if not (v["names"] == ds.image_names() and pred_err <= KP_ATOL
            and cm_extra == dup):
        raise AssertionError("phase 17a: the gathered validate differs")
    for r, f in enumerate(r["flagship"] for r in ranks):
        print(f"phase 17a: rank {r} of {SHARED_WORLD} gloo ranks sharing "
              f"cuda:0, the flagship train step (bs{f['batch']} a rank, "
              f"384x384, bf16, channels_last, cross-rank BN, global "
              f"criterion, DDP): median {f['step_ms']:.3f} ms over "
              f"{SHARED_TIMED} warm steps "
              f"({['%.1f' % x for x in f['times_ms']]} ms); "
              f"{f['kernels']} device operations, device busy "
              f"{f['busy_ms']:.3f} ms, idle share {f['idle_share']:.3f}, "
              f"peak memory {f['peak_gib']:.3f} GiB; phase 7's unwrapped "
              f"bs16 step in this call: {train['kernels']} device "
              f"operations, busy {train['busy_ms']:.3f} ms, peak "
              f"{train['peak_gib']:.3f} GiB; top by device time "
              f"{f['top']} {tag}")
    launches = sum(r["launches"] for r in ranks)
    return dict(loss_rel=loss_rel, grad_worst=g_worst, grad_norm=g_norm,
                stats_step1=s1, adam_step1=w1, lamda_after=lam3,
                zero_loss_rel=z_loss, search_rel=s_rel,
                arch_grad_worst=ag_worst, arch_grad_norm=ag_norm,
                arch_adam=aw, pred_err=pred_err,
                flagship=[r["flagship"] for r in ranks]), launches


def cli_rank(module: str, out_json: str, argv: list) -> int:
    """One rank of a CLI under torchrun (``chip_smoke.py --cli MODULE
    OUT_JSON ARGS``): runs ``MODULE.main(ARGS)`` as ``python -m MODULE``
    would and writes rank 0's train loss (or the test CLI's pixel
    accuracy) and launches of the heatmap kernel to OUT_JSON."""
    line_buffered()
    mod = importlib.import_module(module)
    heatmaps.render_heatmaps.launches = 0
    out = mod.main(argv)
    if mesh.is_primary():
        with open(out_json, "w") as f:
            json.dump({"launches": heatmaps.render_heatmaps.launches,
                       "train_loss": out.get("train_loss"),
                       "pixel_acc": out.get("pixel_acc"),
                       "loss": out["result"]["loss"] if "result" in out
                       else out.get("loss")}, f)
    return 0


def run_under_torchrun(module: str, argv: list, tmp: str, name: str):
    """Starts ``module``'s CLI at world size 1 under ``python -m
    torch.distributed.run`` (NCCL on the card); returns the process and
    the JSON path ``cli_rank`` writes."""
    out_json = os.path.join(tmp, f"{name}.json")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node=1", os.path.abspath(__file__), "--cli", module,
           out_json, *argv]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), out_json


def finish(proc, out_json: str, what: str, timeout: float = 600) -> dict:
    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"phase 17b: {what} did not end in {timeout} s")
    if proc.returncode != 0:
        print(log[-6000:])
        raise AssertionError(f"phase 17b: {what} exited with "
                             f"{proc.returncode}")
    with open(out_json) as f:
        return json.load(f)


def first_logged_loss(run_dir: str) -> float:
    """Step 0's loss as the train CLI logs it (``Epoch: [0][0/N] Loss:``)
    in its log file under ``run_dir``."""
    logs = [os.path.join(run_dir, f) for f in os.listdir(run_dir)
            if f.endswith(".log")]
    if len(logs) != 1:
        raise AssertionError(f"phase 17b: {len(logs)} log files in {run_dir}")
    with open(logs[0]) as f:
        for line in f:
            if "Epoch: [0][0/" in line:
                return float(line.split("Loss: ")[1].split()[0])
    raise AssertionError(f"phase 17b: no first-step loss in {logs[0]}")


def nccl_world_one(tag: str, train: dict) -> tuple[dict, dict, float]:
    """17b's first part: NCCL at world size 1 in this process: the
    flagship bs16 bf16 train step under DDP (the model wrapped,
    find_unused_parameters off and on), timed, profiled and its peak
    memory, beside phase 7's unwrapped step (``train``); the fp32 loss of
    the train CLI's first batch. Returns the numbers, the heatmap
    kernel's launches on the DDP train path and that loss. The CLIs under
    torchrun are ``DdpClis``."""
    launches = {}
    hp = augment_lip.FLAGSHIP_TRAIN
    os.environ.update(RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost",
                      MASTER_PORT=str(free_port()))
    try:
        if not mesh.initialize_distributed("cuda"):
            raise AssertionError("phase 17b: the NCCL group did not start")
        heatmaps.render_heatmaps.launches = 0  # the DDP train path's count
        train_loader, _ = augment_lip.build_loaders(hp, "cuda")
        batches = take(train_loader, 2)
        step = augment_lip.make_train_step(hp)
        timed, loss32 = {}, None
        for unused in (False, True):
            # A fresh seeded state each time: two DDP wrappers over one
            # module would both hook its parameters.
            state = augment_lip.init_state(
                eval_lip.FLAGSHIP, hp, device="cuda", dtype=torch.bfloat16,
                seed=SEED, steps_per_epoch=len(train_loader))
            # find_unused_parameters, which the port leaves off (every
            # parameter gets a gradient), only for its timing here.
            state.net = (DistributedDataParallel(
                state.model, device_ids=[0], broadcast_buffers=False,
                find_unused_parameters=True) if unused
                else mesh.wrap_model(state.model, mesh.data_group()))
            if not isinstance(state.net, DistributedDataParallel):
                raise AssertionError("phase 17b: the model is not wrapped")
            if loss32 is None:  # the train CLI's first batch and weights
                loss32 = fp32_loss(state, batches[0], hp)
            timed[unused] = timed_train_step(step, state, batches, DDP_TIMED)
            t = timed[unused]
            print(f"phase 17b: DDP train step at world size 1 over NCCL "
                  f"(bs16, 384x384, bf16, channels_last, "
                  f"find_unused_parameters={unused}): median "
                  f"{t['step_ms']:.3f} ms over {DDP_TIMED} warm steps "
                  f"({['%.1f' % x for x in t['times_ms']]} ms); "
                  f"{t['kernels']} device operations, device busy "
                  f"{t['busy_ms']:.3f} ms, idle share {t['idle_share']:.3f}, "
                  f"peak memory {t['peak_gib']:.3f} GiB; phase 7's unwrapped "
                  f"step in this call: median {train['step_ms']:.3f} ms, "
                  f"{train['kernels']} device operations, busy "
                  f"{train['busy_ms']:.3f} ms, idle share "
                  f"{train['idle_share']:.3f}, peak {train['peak_gib']:.3f} "
                  f"GiB; top by device time {t['top'][:4]} {tag}")
            del state
            torch.cuda.empty_cache()
        launches["ddp_train"] = heatmaps.render_heatmaps.launches
        del batches, train_loader
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
            os.environ.pop(k, None)
    return dict(ddp_step=timed[False], ddp_step_find_unused=timed[True]), \
        launches["ddp_train"], loss32


class DdpClis:
    """17b's second part: under torchrun (NCCL at world size 1) the train
    CLI, the train CLI with ``--zero`` and the search CLI (``--tiny
    --zero``) side by side, and the eval CLI on the train CLI's checkpoint
    once that is written. They start with phase 17a's rank pair and run
    beside its tiny work (17a's and 18's checks do not read times;
    before phase 23 came they ran after 17a's ranks had ended)."""

    def __init__(self):
        self.tmp = tempfile.TemporaryDirectory()
        tmp = self.tmp.name
        # One step each (3 and 2 before phase 23 came): the first logged
        # loss and the checkpoint are what the phase checks.
        common = ["--synthetic", "--steps", "1", "--epochs", "1"]
        self.procs = {
            "train": run_under_torchrun(
                "npp_tpu_torch.tools.augment_lip",
                common + ["--out", os.path.join(tmp, "ddp")], tmp, "train"),
            "zero": run_under_torchrun(
                "npp_tpu_torch.tools.augment_lip",
                common + ["--zero", "--out", os.path.join(tmp, "zero")], tmp,
                "zero"),
            "search": run_under_torchrun(
                "npp_tpu_torch.tools.search_lip",
                ["--synthetic", "--tiny", "--steps", "1", "--epochs", "2",
                 "--warmup-epochs", "1", "--zero", "--out",
                 os.path.join(tmp, "search")], tmp, "search")}

    def stop(self) -> None:
        for proc, _ in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        self.tmp.cleanup()

    def finish(self, tag: str, loss32: float) -> tuple[dict, dict]:
        """Wait for the CLIs and check them; ``loss32`` is the fp32 loss
        of the train CLI's first batch (``nccl_world_one``). Returns the
        numbers and the heatmap kernel's launches by path."""
        tmp, procs = self.tmp.name, self.procs
        # The eval CLI reads the train CLI's checkpoint while the other two
        # still run.
        res = {"train": finish(*procs.pop("train"), "train")}
        ckpt = os.path.join(tmp, "ddp", "lip", "augment", "flagship",
                            "checkpoints")
        procs["eval"] = run_under_torchrun(
            "npp_tpu_torch.tools.eval_lip", ["--synthetic", "--ckpt", ckpt],
            tmp, "eval")
        blob = torch.load(os.path.join(ckpt, "final", "state.pt"),
                          map_location="cpu", weights_only=True)
        module_keys = sum(k.startswith("module.") for k in blob["model"])
        del blob
        res.update({k: finish(*v, k) for k, v in procs.items()})
        procs.clear()
        firsts = {k: first_logged_loss(os.path.join(tmp, d, "lip", "augment",
                                                    "flagship"))
                  for k, d in (("train", "ddp"), ("zero", "zero"))}
        self.stop()
        rel = {k: abs(v - loss32) / abs(loss32) for k, v in firsts.items()}
        print(f"phase 17b: under python -m torch.distributed.run "
              f"--nproc_per_node=1 (NCCL): augment_lip --synthetic --steps 1 "
              f"--epochs 1 train loss {res['train']['train_loss']:.6f}, val loss "
              f"{res['train']['loss']:.6f}; with --zero "
              f"{res['zero']['train_loss']:.6f} / {res['zero']['loss']:.6f}; "
              f"first logged losses {firsts} vs fp32 {loss32:.6f} on the same "
              f"batch, relative { {k: round(v, 6) for k, v in rel.items()} } (<= "
              f"{BF16_RTOL}); the checkpoint holds {module_keys} 'module.' keys; "
              f"eval_lip --ckpt: loss {res['eval']['loss']:.6f}; search_lip "
              f"--tiny --zero: train loss {res['search']['train_loss']:.6f} "
              f"{tag}")
        losses = [res["train"]["train_loss"], res["train"]["loss"],
                  res["zero"]["train_loss"], res["zero"]["loss"],
                  res["eval"]["loss"], res["search"]["train_loss"]]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"phase 17b: non-finite CLI losses {losses}")
        if not (max(rel.values()) <= BF16_RTOL and module_keys == 0):
            raise AssertionError("phase 17b: the CLI's first loss or its "
                                 "checkpoint is off")
        launches = {"ddp_train": res["train"]["launches"]
                    + res["zero"]["launches"],
                    "ddp_search": res["search"]["launches"],
                    "ddp_eval": res["eval"]["launches"]}
        return dict(cli_first_loss_rel=rel), launches


# Phase 18: spatial partitioning. Two gloo ranks share cuda:0 (NCCL
# refuses two ranks on one card), as in 17a. 18a: a 1x2 space grid at the
# flagship width (the fp32 forward against the one process's, the bf16
# forward profiled, Predictor(mesh=) with pose scales); 18b: a 2x1 data
# grid (Predictor(mesh=) with pose scales, multi-scale testval with
# mesh=) and test_lip --mesh under torchrun, then npp_tpu's serving
# layouts on both grids (fused necks + cells, int8 dynamic, int8
# calibrated, fused + int8; each against the one process's Predictor of
# that layout), with the dynamic layout served again with each rank's own
# max as its scale (the negative control), a rank's int8 conv launches
# against the plain version on the same windows or shard and the
# grid-scale quantize against the one-device dynamic quantize of the
# whole activation, both bit for bit; 18c: the 1x2 grid training (a tiny
# fp32 step against the one process's, the flagship bf16 step at bs2
# timed). Two ranks on one card measure correctness and collective
# counts, not scaling.
SP_WORLD = 2
SP_TIMEOUT_S = 300      # a rank that has not ended by then fails the phase
SP_FWD_ATOL = 1e-4      # npp_tpu's bound for the sharded fp32 forward
SP_FWD_BATCH = 2
SP_SERVE_IMAGES = 8
SP_POSE_SCALES = (1.0, 0.75)
SP_TIMED = 1            # 18c's timed flagship steps a rank
SP_MS_SCALES = (0.5, 1.0)
# 18b's serving layouts, at the base pose scale (the fp pairs of 18a and
# 18b hold the pose-scale TTA on both grids), each against the one
# process's Predictor of the layout. On the data grid each rank runs
# whole images through the one process's kernels and the grid's max is
# the whole batch's, so all four layouts are held at the fp bounds, and
# every int8 conv call takes the one process's dynamic scale bit for bit.
# On the space grid the fused fp32 layout is held at the fp bounds too;
# an int8 layout cannot be: an fp32 rounding difference (the sharded fp
# ops round otherwise) that crosses a midpoint of the int8 grid moves a
# value one quantum, that moves the next convs' maxima, and at the
# flagship's depth (552 int8 convs a forward, seeded weights) the flips
# spread over the maps. So there its crop labels may differ from the one
# process's on at most SP_INT8_NOISE_X times the share on which the one
# process's int8 labels differ from its fp32 ones (the quantization's own
# error; keypoints printed beside, with no bar), and the int8 conv calls
# of the stems, whose inputs the grid computes bit for bit, take the one
# process's dynamic scales bit for bit (the grid's max is the whole
# activation's). The control (each rank's own max) must miss the data
# grid's fp bounds and the space grid's stem scales.
SP_LAYOUTS = {"fused": dict(fuse_necks=True, fuse_cells=True),
              "int8_dynamic": dict(quantize="int8"),
              "int8_calibrated": dict(quantize="int8"),
              "fused_int8": dict(fuse_necks=True, fuse_cells=True,
                                 quantize="int8")}
SP_LAYOUT_SCALES = (1.0,)
SP_LAYOUT_FLIP = False   # one forward a batch (18a and 18b's fp pairs flip)
SP_INT8_NOISE_X = 2.0
SP_INT8_GAP = 0.05       # a unique peak's top-2 gap, x the peak (printing)
# The grid-scale quantize's activation: the 3x3 128->128 conv's input at
# bs8 (bf16, channels_last), with a spike on the last rank's part.
SP_QUANT_SHAPE = (8, 128, 96, 96)


def sp_images(n: int) -> torch.Tensor:
    """``n`` normalised 384x384 images, one brightness each."""
    g = torch.Generator().manual_seed(SEED + 18)
    x = torch.randn(n, 3, 384, 384, generator=g)
    return x * torch.linspace(0.5, 1.5, n)[:, None, None, None]


def sp_flagship(device):
    return build_nppnet(device=device, generator=torch.Generator()
                        .manual_seed(SEED), dtype=torch.float32,
                        **eval_lip.FLAGSHIP).to(
        memory_format=torch.channels_last)


def sp_tiny_step(device, grid=None) -> dict:
    """One tiny fp32 train step (phase 6's batch of 4 at 128x128; on a
    grid, this rank's rows of it, rendered at full height)."""
    hp = augment_lip.TINY_TRAIN
    state = T.init_train_state(
        generator=torch.Generator().manual_seed(SEED), device=device,
        base_lr=hp["lr"], lr_step=hp["lr_step"], lr_factor=hp["lr_factor"],
        steps_per_epoch=1, dtype=torch.float32, grid=grid, **eval_lip.TINY)
    batch = tiny_batch(device)
    if grid is not None:
        batch = spatial.shard_batch_spatial(batch, grid)
    step = T.make_train_step(class_weights=LIP_CLASS_WEIGHTS,
                             ignore_index=eval_lip.IGNORE,
                             ohem_thres=hp["ohem_thres"],
                             ohem_keep=hp["ohem_keep"], grid=grid)
    metrics = step(state, batch)
    out = train_snapshot(state)
    out["losses"] = {k: v.item() for k, v in metrics.items()}
    return out


def sp_testval(device, grid=None) -> np.ndarray:
    """The tiny model's multi-scale testval over 2 synthetic images (its
    confusion matrix), with the windows split over ``grid``'s data axis."""
    model = build_nppnet(device=device, generator=torch.Generator()
                         .manual_seed(SEED), dtype=torch.float32,
                         **eval_lip.TINY)
    ds = SyntheticDataset(length=2, crop_size=(128, 128), is_train=False,
                          num_joints=16, num_classes=20, seed=SEED)
    loader = L.DataLoader(ds, 1, device=device, num_workers=1,
                          process_index=0, process_count=1)
    return test_seg.testval(test_seg.make_parsing_apply_fn(model), loader,
                            num_classes=20, scales=SP_MS_SCALES,
                            crop_size=(128, 128), mesh=grid)["cm"]


def count_collectives(fn) -> tuple:
    """(fn(), the all-reduces it issued in this process)."""
    calls = [0]
    real = dist.all_reduce

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    dist.all_reduce = counted
    try:
        return fn(), calls[0]
    finally:
        dist.all_reduce = real


def own_part(t: torch.Tensor, grid) -> torch.Tensor:
    """Data shard ``grid.d`` and row block ``grid.s`` of a whole NCHW
    tensor."""
    b, h = len(t) // grid.n_data, t.shape[2] // grid.n_space
    return t[grid.d * b:(grid.d + 1) * b, :, grid.s * h:(grid.s + 1) * h]


def grid_quantize_check(grid, device) -> dict:
    """18b: ``quantize.grid_quantize`` (the absmax kernel, one MAX
    all-reduce, the static quantize kernel) of this rank's part of one
    activation against the one-device dynamic quantize kernel on the
    whole, int8 values and scale bit for bit, with and without the ReLU;
    and the int8 values that a per-rank scale puts one quantum and more
    apart (the control)."""
    g = torch.Generator().manual_seed(SEED + 16)
    whole = torch.randn(SP_QUANT_SHAPE, generator=g) * torch.linspace(
        0.5, 2.0, SP_QUANT_SHAPE[0])[:, None, None, None]
    whole[-1, 3, -5, 7] = 20.0
    whole = whole.to(device, torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    x = own_part(whole, grid).contiguous(memory_format=torch.channels_last)
    out = {}
    for relu in (False, True):
        q, scale = Q.grid_quantize(x, grid.world, relu=relu)
        q_all, scale_all = Q.quantize_act(whole, relu=relu)
        want = own_part(q_all, grid)
        q_own, _ = Q.quantize_act(x, relu=relu)
        apart = (q_own.int() - want.int()).abs()
        out[relu] = dict(equal=bool(torch.equal(q, want)
                                    and same_scale(scale, scale_all)),
                         one=int((apart == 1).sum()),
                         more=int((apart > 1).sum()), n=apart.numel())
    return out


class wrapped:
    """``Q.<name>`` replaced by ``wrapper(real, *args, **kw)`` inside the
    block. The kernels' wrappers count their launches on the module's
    name for themselves, so the count moves over to the wrapper and
    back."""

    def __init__(self, name: str, wrapper):
        self.name, self.real = name, getattr(Q, name)
        self.fn = lambda *a, **kw: wrapper(self.real, *a, **kw)

    def __enter__(self):
        self.fn.launches = self.real.launches
        setattr(Q, self.name, self.fn)

    def __exit__(self, *exc):
        setattr(Q, self.name, self.real)
        self.real.launches = self.fn.launches


def call_scales(model, x) -> tuple[torch.Tensor, int]:
    """The activation scale of every int8 conv call of one forward of
    ``model`` on ``x``, in call order, and the calls that fold the ReLU
    into their quantize."""
    scales, folded = [], [0]

    def record(real, x, act_scale=None, relu=False):
        q, scale = real(x, act_scale, relu=relu)
        scales.append(scale.reshape(()))
        folded[0] += int(relu)
        return q, scale

    with wrapped("quantize_act", record), torch.inference_mode():
        model(x)
    return torch.stack(scales).cpu(), folded[0]


def windowed_convs_check(model, x) -> dict:
    """18b: every int8 conv launch of one forward of the grid's ``model``
    on this rank's part ``x`` (its data shard; on a space grid its rows,
    each conv on a row window with its halos) against
    ``conv_s8_reference`` on the same int8 input, bit for bit; and each
    call's dynamic scale."""
    seen = dict(calls=0, equal=0, err=0.0)

    def checked(real, q_x, qweight, w_scale, a_scale, bias, **kw):
        out = real(q_x, qweight, w_scale, a_scale, bias, **kw)
        ref = Q.conv_s8_reference(q_x, qweight, w_scale, a_scale, bias, **kw)
        seen["calls"] += 1
        seen["equal"] += int(torch.equal(out, ref))
        seen["err"] = max(seen["err"],
                          (out.float() - ref.float()).abs().max().item())
        return out

    with wrapped("conv_s8", checked):
        seen["scales"], seen["folded"] = call_scales(model, x)
    return seen


def per_rank_control(pred, x, ims) -> dict:
    """18b's negative control on the dynamic int8 layout: the scale of
    every int8 conv call of one forward on this rank's part ``x``, and the
    predictions of ``ims``, with each rank's own max as the scale (no MAX
    all-reduce); the grid's scale group is put back after."""
    convs = [m for m in pred.model.modules() if isinstance(m, Q.Int8Conv2d)]
    group = convs[0].scale_group
    for m in convs:
        m.scale_group = None
    try:
        scales, _ = call_scales(pred.model, x)
        with torch.no_grad():
            return dict(scales=scales, serve=pred.predict_batch(ims))
    finally:
        for m in convs:
            m.scale_group = group


def sp_layout(device, grid, base, ims) -> dict:
    """18b: the four serving layouts of ``base`` (an unconverted fp32
    flagship) on ``grid``: after a warm-up batch of one image (which
    traces the plan on the space grid), each one's predictions of a
    batch timed (host clock after a synchronize) with its int8 launches,
    all all-reduces and MAX all-reduces counted. The calibrated layout is
    the dynamic one's Predictor after ``calibrate_int8``, whose launches
    and all-reduces are counted too. The dynamic one also checks its int8
    conv launches on this rank's part of the canvases and serves the
    control (``per_rank_control``)."""
    out = {}
    for name, kw in SP_LAYOUTS.items():
        row = {}
        if name == "int8_calibrated":  # the dynamic one's, calibrated
            reset_int8_counts()
            before = mesh.all_max.calls
            _, row["cal_all_reduces"] = count_collectives(
                lambda: pred.calibrate_int8(ims, batch_size=len(ims)))
            row["cal_all_max"] = mesh.all_max.calls - before
            row["cal_launches"] = int8_counts()
        else:
            pred = Predictor(base, crop_size=(384, 384),
                             pose_scales=SP_LAYOUT_SCALES,
                             flip_test=SP_LAYOUT_FLIP, mesh=grid, **kw)
            with torch.no_grad():  # warm-up; on a space grid, the plan
                pred.predict_batch(ims[:1])
        torch.cuda.synchronize()
        reset_int8_counts()
        before, t0 = mesh.all_max.calls, time.perf_counter()
        with torch.no_grad():
            row["serve"], row["all_reduces"] = count_collectives(
                lambda: pred.predict_batch(ims))
            torch.cuda.synchronize()
        row["ms"] = (time.perf_counter() - t0) * 1e3
        row["all_max"] = mesh.all_max.calls - before
        row["launches"] = int8_counts()
        if name == "int8_dynamic":
            b = len(ims) // grid.n_data
            canv = torch.from_numpy(np.stack([
                pred.preprocess(im)[0]
                for im in ims[grid.d * b:(grid.d + 1) * b]]))
            x = pred._normalize(pred._own_rows(canv.to(device)))
            row["windows"] = windowed_convs_check(pred.model, x)
            row["own"] = per_rank_control(pred, x, ims)
        out[name] = row
    return out


def sp_work(device, go_path: str) -> dict:
    """Phase 18's work on one rank of the two (``pair_rank``); its timed
    and profiled sections (18a's bf16 forward, 18c's flagship step) wait
    for ``go_path``, the main process's word that nothing else runs on
    the card but these two ranks (before phase 23 came nothing else did
    while phase 18 ran)."""
    space, data = mesh.make_grid(1, SP_WORLD), mesh.make_grid(SP_WORLD, 1)
    out = {"s": space.s, "d": data.d, "seconds": {}}
    t0 = time.perf_counter()

    def done(section):
        nonlocal t0
        out["seconds"][section] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()

    # 18a: the fp32 forward; the bf16 one is timed and profiled after the
    # go, below.
    model = spatial.convert_spatial(sp_flagship(device), space)
    x = spatial.shard_batch_spatial({"image": sp_images(SP_FWD_BATCH)},
                                    space)["image"].to(device)
    x = x.contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        pose_list, par_list = model(x)
        out["fwd"] = [t.float().cpu() for stage in (pose_list, par_list)
                      for pair in stage for t in pair]
        del pose_list, par_list
        model.dtype = torch.bfloat16
        model(x)  # warm-up
    done("18a forward")
    # 18a / 18b: Predictor(mesh=) on the space grid and on the data grid.
    ims = serve_images(SP_SERVE_IMAGES)
    for name, grid in (("serve_space", space), ("serve_data", data)):
        pred = Predictor(sp_flagship(device), crop_size=(384, 384),
                         pose_scales=SP_POSE_SCALES, mesh=grid)
        with torch.no_grad():
            out[name] = pred.predict_batch(ims)
        del pred
        done(name)
    out["testval_cm"] = sp_testval(device, data)
    done("testval")
    # 18b: the serving layouts on both grids, then the grid quantize.
    base = sp_flagship(device)
    for name, grid in (("space", space), ("data", data)):
        out[f"layouts_{name}"] = sp_layout(device, grid, base, ims)
        out[f"quantize_{name}"] = grid_quantize_check(grid, device)
        done(f"layouts {name}")
    del base
    torch.cuda.empty_cache()
    # 18c: the tiny step, then the flagship bf16 step at bs2, on the space
    # grid; the heatmap kernel renders every rank's batch at full height.
    heatmaps.render_heatmaps.launches = 0
    out["tiny"] = sp_tiny_step(device, space)
    done("18c tiny")
    hp = dict(augment_lip.FLAGSHIP_TRAIN, batch_size=2)
    renderer = L.make_target_renderer(stride=4, sigma=eval_lip.SIGMA,
                                      num_joints=eval_lip.NUM_JOINTS,
                                      ignore=eval_lip.IGNORE,
                                      normalize_images=True)
    loader = L.DataLoader(SyntheticDataset(length=8, crop_size=(384, 384),
                                           device_normalize=True),
                          2, device=device, shuffle=True, drop_last=True,
                          num_workers=4, renderer=renderer, grid=space)
    batches = take(loader, 2)
    state = T.init_train_state(
        generator=torch.Generator().manual_seed(SEED), device=device,
        base_lr=hp["lr"], lr_step=hp["lr_step"], lr_factor=hp["lr_factor"],
        steps_per_epoch=len(loader), dtype=torch.bfloat16, grid=space,
        **eval_lip.FLAGSHIP)
    step = T.make_train_step(class_weights=LIP_CLASS_WEIGHTS,
                             ignore_index=eval_lip.IGNORE,
                             ohem_thres=hp["ohem_thres"],
                             ohem_keep=hp["ohem_keep"], grid=space)
    done("18c flagship build")
    wait_file(go_path, GO_TIMEOUT_S)
    done("wait for the go")
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, out["collectives"] = count_collectives(lambda: model(x))
        torch.cuda.synchronize()
        out["bf16_ms"] = (time.perf_counter() - t0) * 1e3
        out["bf16_prof"] = profile_step(lambda m, b: m(b), model, x)
    del model
    done("18a bf16 forward")
    out["flagship"] = timed_train_step(step, state, batches, SP_TIMED)
    out["flagship"]["rows"] = tuple(batches[0]["image"].shape)
    out["launches"] = heatmaps.render_heatmaps.launches
    done("18c flagship")
    return out


def serve_agreement(got: list, ref: list, unique: np.ndarray) -> tuple:
    """(crop label share, image label share, worst keypoint |diff| over
    the joints with a unique peak, worst score |diff|)."""
    crop = np.mean([np.mean(a["parsing_crop"] == b["parsing_crop"])
                    for a, b in zip(got, ref)])
    full = (sum(int((a["parsing"] == b["parsing"]).sum())
                for a, b in zip(got, ref))
            / sum(b["parsing"].size for b in ref))
    kp = np.stack([np.abs(a["keypoints"][:, :2] - b["keypoints"][:, :2])
                   .max(axis=1) for a, b in zip(got, ref)])
    score = max(float(np.abs(a["keypoints"][:, 2] - b["keypoints"][:, 2])
                      .max()) for a, b in zip(got, ref))
    return crop, full, float(kp[unique].max()), score


def spatial_parallel(tag: str, pair: RankPair,
                     before_timed=None) -> tuple[dict, int]:
    """Phase 18 (see the constants above) on ``pair``'s ranks, which have
    gone on from 17a to ``sp_work``. They take their timed sections once
    this process's references and test_lip --mesh have ended and
    ``before_timed()`` (a wait for other work on the card, if given) has
    returned. Returns the numbers and the ranks' heatmap kernel launches
    on the sp train path."""
    torch.backends.cudnn.allow_tf32 = False  # as in the ranks
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        # The one process's references, meanwhile.
        t_main = time.perf_counter()
        model = sp_flagship("cuda")
        with torch.no_grad():
            pose_list, par_list = model(sp_images(SP_FWD_BATCH).to("cuda")
                                        .contiguous(memory_format=
                                                    torch.channels_last))
            one_fwd = [t.float().cpu() for stage in (pose_list, par_list)
                       for pair in stage for t in pair]
        del pose_list, par_list
        ims = serve_images(SP_SERVE_IMAGES)
        one_pred = Predictor(model, crop_size=(384, 384),
                             pose_scales=SP_POSE_SCALES)
        one_serve = one_pred.predict_batch(ims)
        unique = peak_is_unique(one_pred, ims)
        del one_pred
        # The layouts' one-process Predictors (the int8 ones count their
        # launches as a path of their own).
        one_layouts = {}
        reset_int8_counts()
        for name, kw in SP_LAYOUTS.items():
            if name == "int8_calibrated":
                p.calibrate_int8(ims, batch_size=len(ims))
            else:
                p = Predictor(model, crop_size=(384, 384),
                              pose_scales=SP_LAYOUT_SCALES,
                              flip_test=SP_LAYOUT_FLIP, **kw)
            with torch.no_grad():
                one_layouts[name] = dict(
                    serve=p.predict_batch(ims), unique=peak_is_unique(
                        p, ims, SP_INT8_GAP if "quantize" in kw
                        else UNIQUE_GAP))
            if name == "int8_dynamic":  # its scales, call by call
                canv = torch.from_numpy(np.stack([p.preprocess(im)[0]
                                                  for im in ims]))
                one_layouts["scales"], one_layouts["folded"] = call_scales(
                    p.model, p._normalize(canv.to("cuda")))
                one_layouts["stem_convs"] = sum(
                    1 for n, m in p.model.named_modules()
                    if n.startswith("stem") and isinstance(m, Q.Int8Conv2d))
        del p
        one_launches = int8_counts()
        del model
        one_cm = sp_testval("cuda")
        one_tiny = sp_tiny_step("cuda")
        torch.cuda.empty_cache()
        # test_lip --mesh under torchrun (world size 1: NCCL on the card).
        cli, cli_json = run_under_torchrun(
            "npp_tpu_torch.tools.test_lip",
            ["--synthetic", "--tiny", "--mesh", "--limit", "2"], tmp,
            "test_lip_mesh")
        cli_out = finish(cli, cli_json, "test_lip --mesh", timeout=300)
        main_s = time.perf_counter() - t_main
        if before_timed is not None:
            before_timed()
        pair.go("18")
        ranks = pair.results("18", SP_TIMEOUT_S)
    # 18a: every rank's rows of the 8 outputs.
    fwd_err = 0.0
    for r in ranks:
        for got, want in zip(r["fwd"], one_fwd):
            h = want.shape[2] // SP_WORLD
            fwd_err = max(fwd_err, (got - want[:, :, r["s"] * h:
                                               (r["s"] + 1) * h])
                          .abs().max().item())
    serve = {name: [serve_agreement(r[name], one_serve, unique)
                    for r in ranks] for name in ("serve_space", "serve_data")}
    layouts, launches = sp_layouts_report(ranks, one_layouts, ims, tag)
    launches["sp_one_process"] = one_launches
    prof = [r["bf16_prof"] for r in ranks]
    print(f"phase 18a: 1x2 space grid, {SP_WORLD} gloo ranks sharing cuda:0, "
          f"flagship (L=16, C=64, 384x384, eval) at bs{SP_FWD_BATCH}: fp32 "
          f"forward (TF32 off) of every rank's 192 rows vs one process: max "
          f"|diff| {fwd_err:.3g} over the 8 outputs (<= {SP_FWD_ATOL}); bf16 "
          f"forward a rank: {[round(r['bf16_ms'], 3) for r in ranks]} ms on "
          f"the host clock, {[p['kernels'] for p in prof]} device "
          f"operations, busy {[round(p['busy_ms'], 3) for p in prof]} ms, "
          f"{[r['collectives'] for r in ranks]} all-reduces; top by device "
          f"time {prof[0]['top'][:4]} {tag}")
    for name, what in (("serve_space", "18a: Predictor(mesh=1x2)"),
                       ("serve_data", "18b: Predictor(mesh=2x1)")):
        print(f"phase {what} fp32 on {SP_SERVE_IMAGES} images, pose scales "
              f"{SP_POSE_SCALES}, vs the unsharded Predictor: per rank (crop "
              f"label share, image label share, keypoint max|diff| px over "
              f"the {int(unique.sum())} of {unique.size} joints with a unique "
              f"peak, score max|diff|) {serve[name]} (>= {LABEL_SHARE}, <= "
              f"{KP_ATOL}) {tag}")
    cm_equal = all(np.array_equal(r["testval_cm"], one_cm) for r in ranks)
    print(f"phase 18b: multi-scale testval (tiny, 2 images, scales "
          f"{SP_MS_SCALES}, flip) with the windows split over 2 ranks: "
          f"confusion matrices equal to one process's: {cm_equal}; python -m "
          f"torch.distributed.run --nproc_per_node=1 test_lip --synthetic "
          f"--tiny --mesh --limit 2 (NCCL): pixel_acc "
          f"{cli_out['pixel_acc']:.6f} {tag}")
    tiny = [r["tiny"] for r in ranks]
    mean_loss = {k: statistics.mean(t["losses"][k] for t in tiny)
                 for k in one_tiny["losses"]}
    loss_rel = max(abs(mean_loss[k] - v) / abs(v)
                   for k, v in one_tiny["losses"].items())
    g_worst, g_key, g_norm = grad_rule(tiny[0]["grads"], one_tiny["grads"])
    s1 = stats_err(tiny[0]["stats"], one_tiny["stats"])
    lg = max(((tiny[0]["lamda_grads"][k] - v).abs() / v.abs()).max().item()
             for k, v in one_tiny["lamda_grads"].items())
    same = all(torch.equal(t, tiny[1][f][n]) for f in ("grads", "params",
                                                       "stats")
               for n, t in tiny[0][f].items())
    fl = [r["flagship"] for r in ranks]
    print(f"phase 18: seconds by section, per rank "
          f"{[r['seconds'] for r in ranks]}; the one process's references "
          f"and test_lip --mesh meanwhile {main_s:.1f} s")
    print(f"phase 18c: 1x2 space grid train: tiny fp32 step (L=8, C=8, "
          f"128x128, bs4, each rank 64 rows) vs one process: mean losses "
          f"relative {loss_rel:.3g} (<= 1e-5), gradients worst tensor "
          f"{g_worst:.3g} (<= {TINY_GRAD_TENSOR}; {g_key}), norm "
          f"{g_norm:.3g} (<= {TINY_GRAD_NORM}), running stats {s1:.3g} of "
          f"1e-4 x max|ref| + {STATS_ATOL}, lambda gradients {lg:.3g} (<= "
          f"1e-5), the ranks' state equal: {same}; flagship bf16 step at bs2 "
          f"(rank batch {fl[0]['rows']}): median "
          f"{[round(f['step_ms'], 3) for f in fl]} ms over {SP_TIMED} "
          f"warm steps a rank, {[f['kernels'] for f in fl]} device "
          f"operations, busy {[round(f['busy_ms'], 3) for f in fl]} ms, idle "
          f"share {[round(f['idle_share'], 3) for f in fl]}, peak "
          f"{[round(f['peak_gib'], 3) for f in fl]} GiB; top by device time "
          f"{fl[0]['top'][:4]} {tag}")
    if not fwd_err <= SP_FWD_ATOL:
        raise AssertionError("phase 18a: the sharded forward disagrees")
    for name, rows in serve.items():
        for crop, full, kp, _ in rows:
            if not (crop >= LABEL_SHARE and full >= LABEL_SHARE
                    and kp <= KP_ATOL):
                raise AssertionError(f"phase 18: {name} disagrees")
    if not (cm_equal and math.isfinite(cli_out["pixel_acc"])):
        raise AssertionError("phase 18b: testval with mesh= disagrees")
    if not (loss_rel <= 1e-5 and g_worst <= TINY_GRAD_TENSOR
            and g_norm <= TINY_GRAD_NORM and s1 <= 1.0 and lg <= 1e-5
            and same):
        raise AssertionError("phase 18c: the sp train step disagrees")
    if not all(math.isfinite(f["step_ms"]) for f in fl):
        raise AssertionError("phase 18c: the flagship sp step failed")
    return dict(fwd_err=fwd_err, bf16_fwd_ms=[r["bf16_ms"] for r in ranks],
                bf16_fwd_kernels=[p["kernels"] for p in prof],
                bf16_fwd_busy_ms=[p["busy_ms"] for p in prof],
                collectives=[r["collectives"] for r in ranks],
                serve=serve, testval_equal=cm_equal, tiny_loss_rel=loss_rel,
                tiny_grad=(g_worst, g_norm), flagship=fl,
                layouts=layouts, seconds=[r["seconds"] for r in ranks],
                main_s=main_s), \
        sum(r["launches"] for r in ranks), launches


def int8_agreement(got: list, ref: list, unique: np.ndarray, ims) -> tuple:
    """(crop label share, keypoint max|diff| in crop px over the joints
    with a unique peak)."""
    crop = float(np.mean([np.mean(a["parsing_crop"] == b["parsing_crop"])
                          for a, b in zip(got, ref)]))
    scale = np.array([384.0 / max(im.shape[:2]) for im in ims])
    kp = np.stack([np.abs(a["keypoints"][:, :2] - b["keypoints"][:, :2])
                   .max(axis=1) for a, b in zip(got, ref)]) * scale[:, None]
    return crop, float(kp[unique].max()) if unique.any() else 0.0


def leading_equal(got: torch.Tensor, want: torch.Tensor) -> int:
    """How many calls from the first on take ``want``'s scales bit for
    bit."""
    same = got == want
    return len(want) if bool(same.all()) else int(same.int().argmin())


def sp_layouts_report(ranks, one, ims, tag) -> tuple[dict, dict]:
    """18b's layouts: each rank's predictions against the one process's of
    that layout (the data grid's and the fused fp32 ones at the fp bounds,
    the space grid's int8 ones at the int8 noise bound), the dynamic
    layout's per-rank-scale control against the same bound; the launch,
    all-reduce and timing rows; the int8 conv launch, call scale and grid
    quantize checks. Returns (the numbers, the int8 launches by path,
    summed over the ranks)."""
    out, launches = {}, {}
    for grid in ("space", "data"):
        for name, kw in SP_LAYOUTS.items():
            rows = [r[f"layouts_{grid}"][name] for r in ranks]
            ref = one[name]
            int8 = "quantize" in kw
            if int8 and grid == "space":
                noise = 1.0 - int8_agreement(ref["serve"],
                                             one["fused"]["serve"],
                                             ref["unique"], ims)[0]

                def agreement(serve):
                    return int8_agreement(serve, ref["serve"], ref["unique"],
                                          ims)

                def within(a):
                    return 1.0 - a[0] <= SP_INT8_NOISE_X * noise

                bound = ("(crop label share, keypoint max|diff| crop px over "
                         f"{int(ref['unique'].sum())} unique peaks) vs labels "
                         f"apart on at most {SP_INT8_NOISE_X} x {noise:.6f}, "
                         f"the share on which the one process's int8 labels "
                         f"part from its fp32 ones")
            else:
                def agreement(serve):
                    return serve_agreement(serve, ref["serve"], ref["unique"])

                def within(a):
                    return (a[0] >= LABEL_SHARE and a[1] >= LABEL_SHARE
                            and a[2] <= KP_ATOL)

                bound = (f"(crop, image label share, keypoint px, score) vs "
                         f">= {LABEL_SHARE}, <= {KP_ATOL}")
            agree = [agreement(r["serve"]) for r in rows]
            ok = all(within(a) for a in agree)
            got = [r["launches"] for r in rows]
            path = f"sp_{grid}_{name}"
            launches[path] = {k: sum(g[k] for g in got) for k in got[0]}
            # The grid's dynamic scale: one absmax launch and one MAX
            # all-reduce per int8 conv launch; none once calibrated.
            scale = None if not int8 else (
                "static" if name == "int8_calibrated" else "grid")
            for g, r in zip(got, rows):
                check_int8_counts(path, g, scale)
                if int8 and r["all_max"] != (
                        0 if scale == "static" else g["conv"]):
                    raise AssertionError(f"phase 18b: {path}: {r['all_max']} "
                                         f"MAX all-reduces for {g['conv']} "
                                         f"int8 conv launches")
            out[path] = dict(agreement=agree, ms=[r["ms"] for r in rows],
                             all_reduces=[r["all_reduces"] for r in rows],
                             all_max=[r["all_max"] for r in rows],
                             launches=got)
            fp_pair = out[f"sp_{grid}_fused"]["agreement"]
            where = "1x2 space" if grid == "space" else "2x1 data"
            print(f"phase 18b: {path} ({where} grid, {len(ims)} images, "
                  f"fp32, flip {SP_LAYOUT_FLIP}, scales "
                  f"{SP_LAYOUT_SCALES}) vs the one "
                  f"process's Predictor of the layout: per rank {agree} "
                  f"{bound}"
                  + ("" if name == "fused" else
                     f"; the fused fp32 pair's own {fp_pair}")
                  + f"; ms a batch "
                  f"{[round(r['ms'], 3) for r in rows]}, all-reduces a batch "
                  f"{out[path]['all_reduces']} (MAX {out[path]['all_max']})"
                  f", int8 launches a batch a rank {got} {tag}")
            if name == "int8_dynamic":
                control = [agreement(r["own"]["serve"]) for r in rows]
                missed = not all(within(a) for a in control)
                out[path]["control"] = dict(agreement=control, missed=missed)
                print(f"phase 18b: {path} control (each rank's own max as "
                      f"its scale, no MAX all-reduce): per rank {control}; "
                      f"misses the bound: {missed} {tag}")
                if grid == "data" and not missed:
                    raise AssertionError("phase 18b: the per-rank-scale "
                                         "control meets the data grid's "
                                         "bound")
            if int8 and name == "int8_calibrated":
                cal = [r["cal_launches"] for r in rows]
                for g, r in zip(cal, rows):
                    check_int8_counts(f"{path} calibration", g, "grid")
                    if r["cal_all_max"] != g["conv"]:
                        raise AssertionError(f"phase 18b: calibration: "
                                             f"{r['cal_all_max']} MAX "
                                             f"all-reduces for {g}")
                launches[f"sp_{grid}_calibrate"] = {
                    k: sum(g[k] for g in cal) for k in cal[0]}
                print(f"phase 18b: sp_{grid}_calibrate ({len(ims)} images, "
                      f"one batch): int8 launches a rank {cal}, all-reduces "
                      f"{[r['cal_all_reduces'] for r in rows]} (MAX "
                      f"{[r['cal_all_max'] for r in rows]}) {tag}")
            if not ok:
                raise AssertionError(f"phase 18b: {path} disagrees with one "
                                     f"process")
    quant = {g: [r[f"quantize_{g}"] for r in ranks] for g in ("space",
                                                             "data")}
    # The dynamic scales call by call against the one process's (whole
    # canvases, no flip): on the space grid the stems bit for bit, on the
    # data grid every call; each rank's own max (the control) misses that.
    n_stem, want = one["stem_convs"], one["scales"]
    checks = {}
    for grid in ("space", "data"):
        dyn = [r[f"layouts_{grid}"]["int8_dynamic"] for r in ranks]
        checks[grid] = dict(
            calls=[d["windows"]["calls"] for d in dyn],
            equal=[d["windows"]["equal"] for d in dyn],
            err=[d["windows"]["err"] for d in dyn],
            folded=[d["windows"]["folded"] for d in dyn],
            leading_equal=[leading_equal(d["windows"]["scales"], want)
                           for d in dyn],
            drift=[(d["windows"]["scales"] / want - 1).abs().max().item()
                   for d in dyn],
            control_leading_equal=[leading_equal(d["own"]["scales"], want)
                                   for d in dyn])
    print(f"phase 18b: grid-scale quantize of a {SP_QUANT_SHAPE} bf16 "
          f"activation (the absmax kernel, one MAX all-reduce, the static "
          f"kernel) vs the one-device dynamic kernel on the whole, per rank "
          f"(relu: bit for bit, per-rank scale's int8 values one quantum / "
          f"more apart of n): {quant}; a rank's int8 conv launches of one "
          f"forward (space: row windows; data: its shard) vs "
          f"conv_s8_reference on the same input, their dynamic scales "
          f"against the one process's ({len(want)} calls, {n_stem} stem "
          f"convs; calls bit for bit from the first, worst relative drift), "
          f"the control's, and the calls that fold the ReLU (one process: "
          f"{one['folded']}): {checks} {tag}")
    if not all(c["equal"] for rows in quant.values() for r in rows
               for c in r.values()):
        raise AssertionError("phase 18b: the grid quantize is not the "
                             "one-device dynamic quantize")
    for grid, c in checks.items():
        if not (min(c["calls"]) > 0 and c["equal"] == c["calls"]):
            raise AssertionError(f"phase 18b: an int8 conv launch on the "
                                 f"{grid} grid disagrees with its plain "
                                 f"version")
        if not all(f == one["folded"] > 0 for f in c["folded"]):
            raise AssertionError(f"phase 18b: the {grid} grid's int8 convs "
                                 f"fold the ReLU at other calls than one "
                                 f"process's")
        need = n_stem if grid == "space" else len(want)
        if not (n_stem >= 4 and min(c["leading_equal"]) >= need):
            raise AssertionError(f"phase 18b: the {grid} grid's dynamic "
                                 f"scales are not the one process's")
        if not min(c["control_leading_equal"]) < need:
            raise AssertionError(f"phase 18b: the per-rank-scale control "
                                 f"takes the one process's scales on the "
                                 f"{grid} grid")
    out["quantize"] = quant
    out["scales"] = dict(stem_convs=n_stem, calls=len(want), **checks)
    return out, launches


# Phase 19: tensor parallelism, four gloo ranks sharing cuda:0 (NCCL
# refuses two ranks on one device). 19c: a 2x1x2 grid at the tiny width;
# then two 1x1x2 grids side by side: 19a (ranks 2-3) the tiny fp32 TP
# train and eval steps, 19b (ranks 0-1) the flagship bf16 step. 19a is
# held to the one process by phase 6's rules and 18c's bounds (losses at
# 1e-5, gradients by TINY_GRAD_TENSOR / TINY_GRAD_NORM, running stats,
# lambda gradients at 1e-5), its eval step by its loss at 1e-5, the
# confusion matrix's count and LABEL_SHARE of the labels (a near-tie
# argmax may move); 19c's moments by phase 6's gradient rule on
# m / (1 - beta1) and sqrt(v / (1 - beta2)) (each |g|: the card's backward
# is not bit-stable, so ZeRO and plain TP agree by the rules, as in 17a).
TP_WORLD = 4
TP_TIMEOUT_S = 300      # a rank that has not ended by then fails the phase
TP_TIMED = 1            # 19b's timed flagship steps a rank
TP_POSE_SHARE = 0.98    # 19a's decoded joints equal within KP_ATOL (ties)


def tp_whole(state, grid) -> dict:
    """A TP train state's gathered snapshot (``train_snapshot``'s keys)."""
    tp = tensor.sharding_of(state.model)
    cpu = lambda t: t.detach().float().cpu().clone()
    whole = lambda k, t: cpu(mesh.all_concat(t, grid.model_group)
                             if k in tp.sharded else t)
    sd = tensor.whole_state_dict(state.model)
    return {"params": {n: cpu(sd[n])
                       for n, _ in state.model.named_parameters()},
            "grads": {n: whole(n, p.grad)
                      for n, p in state.model.named_parameters()},
            "stats": {n: cpu(t) for n, t in sd.items() if "running" in n},
            "lamdas": {k: cpu(p) for k, p in state.lamdas.items()},
            "lamda_grads": {k: cpu(p.grad) for k, p in state.lamdas.items()}}


def tp_tiny_step(device, grid=None, zero_=False) -> dict:
    """One tiny fp32 train step on phase 6's batch (every model rank of a
    data shard takes the same batch; with ``zero_`` the hybrid ZeRO x TP
    optimizer): the gathered snapshot, the losses and the whole Adam
    moments where this rank holds them (rank 0 alone under ZeRO)."""
    hp = augment_lip.TINY_TRAIN
    state = T.init_train_state(
        generator=torch.Generator().manual_seed(SEED), device=device,
        base_lr=hp["lr"], lr_step=hp["lr_step"], lr_factor=hp["lr_factor"],
        steps_per_epoch=1, dtype=torch.float32, grid=grid, zero=zero_,
        **eval_lip.TINY)
    batch = tiny_batch(device)
    if grid is not None:
        batch = spatial.shard_batch_spatial(batch, grid)
    step = T.make_train_step(class_weights=LIP_CLASS_WEIGHTS,
                             ignore_index=eval_lip.IGNORE,
                             ohem_thres=hp["ohem_thres"],
                             ohem_keep=hp["ohem_keep"], grid=grid)
    metrics = step(state, batch)
    out = train_snapshot(state) if grid is None else tp_whole(state, grid)
    out["losses"] = {k: v.item() for k, v in metrics.items()}
    opt = zero.optimizer_state_dict(state.optimizer, state.model)
    if opt is not None:
        out["moments"] = {i: {k: v.float().cpu() for k, v in s.items()
                              if k in ("exp_avg", "exp_avg_sq")}
                          for i, s in opt["state"].items()}
    return out


def tp_tiny_eval(device, grid=None) -> dict:
    """The tiny fp32 flip-TTA eval step on phase 6's batch (the model
    converted on ``grid``): its loss, confusion matrix and predictions."""
    model = build_nppnet(device=device, generator=torch.Generator()
                         .manual_seed(SEED), dtype=torch.float32,
                         **eval_lip.TINY)
    tensor.convert_tensor_parallel(model, grid)
    batch = tiny_batch(device)
    ds = SyntheticDataset(length=len(batch["image"]), crop_size=(128, 128),
                          seed=SEED, device_normalize=True)
    host = L.collate([ds[i] for i in range(len(batch["image"]))])
    batch.update(scale=torch.from_numpy(host["scale"]).to(device),
                 crop_param=torch.from_numpy(host["crop_param"]).to(device))
    step = E.make_eval_step(model, num_classes=20,
                            class_weights=LIP_CLASS_WEIGHTS,
                            ignore_index=eval_lip.IGNORE,
                            decode_hw=(128, 128))
    out = step(init_criterion_params(2, device), batch)
    return {k: v.float().cpu() for k, v in out.items()}


def repeated_gathers(model, image) -> tuple[int, int]:
    """(gathers, gathers of a ReLU or a channel mean of a tensor whose same
    op an earlier gather of the forward moved) in one eval forward of a
    TP ``model``: each edge that reads a cell node gathers its own ReLU of
    it, each SE block its own squeeze. The autograd graph names each
    gathered block's source, so the forward keeps it (no update follows).
    """
    seen, repeated, count = [], 0, 0
    real = tensor._GatherChannels.forward

    def forward(ctx, x, tp):
        nonlocal repeated, count
        count += 1
        fn = x.grad_fn
        if type(fn).__name__ in ("ReluBackward0", "MeanBackward1"):
            key = (type(fn).__name__, fn.next_functions[0][0])
            repeated += any(k[0] == key[0] and k[1] is key[1] for k in seen)
            seen.append(key)
        return real(ctx, x, tp)

    tensor._GatherChannels.forward = staticmethod(forward)
    model.eval()
    try:
        model(image)
    finally:
        tensor._GatherChannels.forward = staticmethod(real)
        model.train()
    return count, repeated


def tp_flagship(device, grid) -> dict:
    """19b: the flagship bf16 channels_last TP train step at bs2 (the whole
    batch on both model ranks): timed and profiled (``timed_train_step``),
    its gathers, copies and all-reduces a step (the mean over those
    steps), and the parameter and Adam-moment bytes this rank holds."""
    hp = dict(augment_lip.FLAGSHIP_TRAIN, batch_size=2)
    renderer = L.make_target_renderer(stride=4, sigma=eval_lip.SIGMA,
                                      num_joints=eval_lip.NUM_JOINTS,
                                      ignore=eval_lip.IGNORE,
                                      normalize_images=True)
    loader = L.DataLoader(SyntheticDataset(length=8, crop_size=(384, 384),
                                           device_normalize=True),
                          2, device=device, shuffle=True, drop_last=True,
                          num_workers=4, renderer=renderer, grid=grid)
    batches = take(loader, 2)
    state = T.init_train_state(
        generator=torch.Generator().manual_seed(SEED), device=device,
        base_lr=hp["lr"], lr_step=hp["lr_step"], lr_factor=hp["lr_factor"],
        steps_per_epoch=len(loader), dtype=torch.bfloat16, grid=grid,
        **eval_lip.FLAGSHIP)
    step = T.make_train_step(class_weights=LIP_CLASS_WEIGHTS,
                             ignore_index=eval_lip.IGNORE,
                             ohem_thres=hp["ohem_thres"],
                             ohem_keep=hp["ohem_keep"], grid=grid)
    tp = tensor.sharding_of(state.model)
    tp.counts.update(gather=0, copy=0)
    out, all_reduces = count_collectives(
        lambda: timed_train_step(step, state, batches, TP_TIMED))
    steps = TP_TIMED + 2  # the warm-up, the timed and the profiled steps
    out["all_reduces"] = all_reduces / steps
    out["gathers"], out["copies"] = (tp.counts["gather"] / steps,
                                     tp.counts["copy"] / steps)
    # The leaves the model axis keeps whole, after the steps (the main
    # process holds both model ranks' copies equal).
    out["whole_leaves"] = [t.detach().float().cpu() for t in (
        [p for k, p in state.model.named_parameters() if k not in tp.sharded]
        + list(state.lamdas.values())
        + [b for k, b in state.model.named_buffers()
           if k not in tp.sharded and b.is_floating_point()])]
    out["forward_gathers"], out["repeated_gathers"] = repeated_gathers(
        state.model, batches[0]["image"])
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    out["param_bytes"] = nbytes(list(state.model.parameters()))
    out["moment_bytes"] = nbytes([v for s in state.optimizer.state.values()
                                  for k, v in s.items()
                                  if k in ("exp_avg", "exp_avg_sq")])
    return out


def tp_rank(rank: int, port: int, out_dir: str) -> None:
    """A phase 19 rank (spawned): joins the gloo group of TP_WORLD ranks on
    cuda:0, runs 19c on the 2x1x2 grid, then 19a (ranks 2-3) or 19b
    (ranks 0-1) on its 1x1x2 grid, and saves its results and its heatmap
    kernel launches."""
    line_buffered()
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(TP_WORLD),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if not mesh.initialize_distributed("cuda:0", backend="gloo"):
        raise RuntimeError("the gloo group did not start")
    try:
        heatmaps.render_heatmaps.launches = 0
        hybrid = mesh.make_grid(2, 1, 2)
        pairs = [mesh.make_grid(1, 1, 2, ranks=[0, 1]),
                 mesh.make_grid(1, 1, 2, ranks=[2, 3])]
        pair = pairs[0] or pairs[1]
        out = {"d": hybrid.d, "m": hybrid.m,
               "tp": tp_tiny_step("cuda:0", hybrid),
               "hybrid": tp_tiny_step("cuda:0", hybrid, zero_=True)}
        if rank >= 2:
            out["tiny"] = tp_tiny_step("cuda:0", pair)
            out["eval"] = tp_tiny_eval("cuda:0", pair)
        else:
            wait_file(os.path.join(out_dir, "flagship.go"), GO_TIMEOUT_S)
            out["flagship"] = tp_flagship("cuda:0", pair)
        out["launches"] = heatmaps.render_heatmaps.launches
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def moment_rule(got: dict, ref: dict) -> tuple:
    """(worst tensor share, norm error) of phase 6's gradient rule on
    Adam's first moments as gradients: m / (1 - beta1) and
    sqrt(v / (1 - beta2)), each |g| after one step."""
    as_grads = lambda ms: {
        f"{i}.{k}": (v / 0.1 if k == "exp_avg" else (v / 1e-3).sqrt())
        for i, s in ms.items() for k, v in s.items()}
    worst, _, norm = grad_rule(as_grads(got), as_grads(ref))
    return worst, norm


class TpRanks:
    """Phase 19's TP_WORLD gloo ranks on cuda:0 (``tp_rank``), spawned
    while phase 18's ranks work: their tiny steps (19c, 19a) run beside
    phase 18, and ranks 0-1 take 19b's timed flagship step once ``go``
    says that phase 18 has ended (before phase 23 came they were spawned
    after it)."""

    def __init__(self):
        self.tmp = tempfile.TemporaryDirectory()
        port = free_port()
        ctx = torch.multiprocessing.get_context("spawn")
        self.procs = [ctx.Process(target=tp_rank,
                                  args=(r, port, self.tmp.name))
                      for r in range(TP_WORLD)]
        for p in self.procs:
            p.start()

    def go(self) -> None:
        open(os.path.join(self.tmp.name, "flagship.go"), "w").close()

    def wait_tiny(self) -> None:
        """Wait until the tiny steps are done: ranks 2-3 save their
        results after 19c and 19a, which ranks 0-1 share up to their
        wait for ``go``."""
        paths = [os.path.join(self.tmp.name, f"rank{r}.pt")
                 for r in range(2, TP_WORLD)]
        deadline = time.monotonic() + TP_TIMEOUT_S
        while not all(os.path.exists(x) for x in paths):
            codes = [p.exitcode for p in self.procs]
            if time.monotonic() > deadline or any(codes):
                raise AssertionError(f"phase 19: the tiny steps gave no "
                                     f"results (exit codes {codes})")
            time.sleep(0.2)

    def stop(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join()
        self.tmp.cleanup()

    def results(self) -> list:
        deadline = time.monotonic() + TP_TIMEOUT_S
        for p in self.procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        codes = [p.exitcode for p in self.procs]
        if codes != [0] * TP_WORLD:
            self.stop()
            raise AssertionError(f"phase 19: the ranks exited with {codes}")
        out = [torch.load(os.path.join(self.tmp.name, f"rank{r}.pt"),
                          weights_only=False) for r in range(TP_WORLD)]
        self.stop()
        return out


def tp_references() -> tuple[dict, dict]:
    """Phase 19's one-process references: the tiny step and eval (TF32
    off, as in the ranks), taken while the ranks' tiny work runs."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return tp_tiny_step("cuda"), tp_tiny_eval("cuda")


def tensor_parallel(tag: str, tp_ranks: TpRanks,
                    refs: tuple[dict, dict]) -> tuple[dict, int]:
    """Phase 19 (see the constants above) on ``tp_ranks``, against the
    one-process references ``refs`` (``tp_references``). Returns the
    numbers and the ranks' heatmap kernel launches on the TP train
    path."""
    tp_ranks.go()
    one, one_eval = refs
    ranks = tp_ranks.results()
    lr = augment_lip.TINY_TRAIN["lr"]

    def held(got, ref, tp_ranks) -> dict:
        """A tiny TP step (each rank's gathered snapshot and losses)
        against ``ref`` by phase 6's and 18c's rules."""
        first = got[0]
        loss = {k: statistics.mean(g["losses"][k] for g in tp_ranks)
                for k in ref["losses"]}
        worst, key, norm = grad_rule(first["grads"], ref["grads"])
        return dict(
            loss_rel=max(abs(loss[k] - v) / abs(v)
                         for k, v in ref["losses"].items()),
            grad=(worst, key, norm), stats=stats_err(first["stats"],
                                                     ref["stats"]),
            lamda=max(((first["lamda_grads"][k] - v).abs() / v.abs())
                      .max().item() for k, v in ref["lamda_grads"].items()),
            weights=adam_first_step_err(first, ref, lr),
            same=all(torch.equal(t, o[f][n]) for o in got[1:]
                     for f in ("grads", "params", "stats")
                     for n, t in first[f].items()))

    def ok(h) -> bool:
        return (h["loss_rel"] <= 1e-5 and h["grad"][0] <= TINY_GRAD_TENSOR
                and h["grad"][2] <= TINY_GRAD_NORM and h["stats"] <= 1.0
                and h["lamda"] <= 1e-5 and h["weights"] <= 1.0
                and h["same"])

    # 19c: the 2x1x2 TP step against the one process, and hybrid ZeRO x TP
    # against it.
    tp212 = held([r["tp"] for r in ranks], one,
                 [r["tp"] for r in ranks if r["m"] == 0])
    hyb, plain = ranks[0]["hybrid"], ranks[0]["tp"]
    h_loss = max(abs(hyb["losses"][k] - v) / abs(v)
                 for k, v in plain["losses"].items())
    h_grad = grad_rule(hyb["grads"], plain["grads"])
    h_moments = moment_rule(hyb["moments"], plain["moments"])
    h_weights = adam_first_step_err(hyb, plain, lr)
    only_rank0 = all("moments" not in r["hybrid"] for r in ranks[1:])
    print(f"phase 19c: 2x1x2 grid, {TP_WORLD} gloo ranks sharing cuda:0, "
          f"tiny fp32 step (L=8, C=8, 128x128, bs4, bs2 a data shard) vs "
          f"one process: mean losses relative {tp212['loss_rel']:.3g} (<= "
          f"1e-5), gradients (gathered) worst tensor {tp212['grad'][0]:.3g} "
          f"(<= {TINY_GRAD_TENSOR}; {tp212['grad'][1]}), norm "
          f"{tp212['grad'][2]:.3g} (<= {TINY_GRAD_NORM}), running stats "
          f"{tp212['stats']:.3g}, lambda gradients {tp212['lamda']:.3g}, "
          f"weights {tp212['weights']:.3g} of Adam's first-step bound, the "
          f"ranks' state equal: {tp212['same']}; hybrid ZeRO x TP vs the TP "
          f"step: losses relative {h_loss:.3g} (0), gradients "
          f"{h_grad[0]:.3g} / norm {h_grad[2]:.3g}, consolidated moments "
          f"(rank 0 only: {only_rank0}) as |g| {h_moments[0]:.3g} / norm "
          f"{h_moments[1]:.3g} (<= {TINY_GRAD_TENSOR} / {TINY_GRAD_NORM}), "
          f"weights {h_weights:.3g} of Adam's first-step bound {tag}")
    # 19a: the tiny 1x1x2 steps against the one process.
    tiny = held([r["tiny"] for r in ranks[2:]], one,
                [r["tiny"] for r in ranks[2:]])
    ev = ranks[2]["eval"]
    e_loss = abs(ev["loss"].item() - one_eval["loss"].item()) / abs(
        one_eval["loss"].item())
    e_cm = ev["cm"].sum().item() == one_eval["cm"].sum().item()
    e_labels = (ev["par_pred"] == one_eval["par_pred"]).float().mean().item()
    e_pose = ((ev["pose_pred"][..., :2] - one_eval["pose_pred"][..., :2])
              .abs().amax(-1) <= KP_ATOL).float().mean().item()
    e_same = all(torch.equal(v, ranks[3]["eval"][k]) for k, v in ev.items())
    print(f"phase 19a: 1x1x2 grid (2 of the gloo ranks), tiny fp32 TP train "
          f"step vs one process: losses relative {tiny['loss_rel']:.3g} (<= "
          f"1e-5), gradients worst tensor {tiny['grad'][0]:.3g} (<= "
          f"{TINY_GRAD_TENSOR}; {tiny['grad'][1]}), norm "
          f"{tiny['grad'][2]:.3g} (<= {TINY_GRAD_NORM}), running stats "
          f"{tiny['stats']:.3g} of 1e-4 x max|ref| + {STATS_ATOL}, lambda "
          f"gradients {tiny['lamda']:.3g} (<= 1e-5), weights "
          f"{tiny['weights']:.3g} of Adam's first-step bound, the model "
          f"ranks' state equal: {tiny['same']}; flip-TTA eval step: loss "
          f"relative {e_loss:.3g} (<= 1e-5), confusion-matrix count equal "
          f"{e_cm}, labels equal {e_labels:.7f} (>= {LABEL_SHARE}), joints "
          f"within {KP_ATOL} px {e_pose:.4f} (>= {TP_POSE_SHARE}), both "
          f"model ranks' outputs equal {e_same} {tag}")
    # 19b: the flagship step on the other 1x1x2 grid.
    fl = [r["flagship"] for r in ranks[:2]]
    with torch.device("meta"):
        flagship = NPPNet(**eval_lip.FLAGSHIP)
    whole_params = sum(p.numel() * 4 for p in flagship.parameters())
    whole_moments = 2 * (whole_params + 16)  # two fp32 moments, lambdas
    share = [(f["param_bytes"] / whole_params,
              f["moment_bytes"] / whole_moments) for f in fl]
    whole_leaves = len(fl[0]["whole_leaves"])
    whole_same = whole_leaves > 0 and all(
        torch.equal(a, b) for a, b in zip(fl[0]["whole_leaves"],
                                          fl[1]["whole_leaves"]))
    print(f"phase 19b: 1x1x2 grid (2 of the gloo ranks), flagship bf16 "
          f"channels_last TP train step at bs2 (L=16, C=64, 384x384; every "
          f"model rank the whole batch): per rank one step's gathers "
          f"{[f['gathers'] for f in fl]}, copies' all-reduces "
          f"{[f['copies'] for f in fl]}, all-reduces in all "
          f"{[f['all_reduces'] for f in fl]}; median "
          f"{[round(f['step_ms'], 3) for f in fl]} ms over {TP_TIMED} "
          f"warm step, {[f['kernels'] for f in fl]} device operations, "
          f"busy {[round(f['busy_ms'], 3) for f in fl]} ms, idle share "
          f"{[round(f['idle_share'], 3) for f in fl]}, peak "
          f"{[round(f['peak_gib'], 3) for f in fl]} GiB; parameter bytes "
          f"{[f['param_bytes'] for f in fl]} and Adam-moment bytes "
          f"{[f['moment_bytes'] for f in fl]} a rank beside the unconverted "
          f"model's {whole_params} and {whole_moments} (shares "
          f"{[(round(a, 4), round(b, 4)) for a, b in share]}); the "
          f"{whole_leaves} leaves the model axis keeps whole equal on both "
          f"model ranks after the steps: {whole_same}; one eval forward's "
          f"gathers {[f['forward_gathers'] for f in fl]}, of which "
          f"{[f['repeated_gathers'] for f in fl]} move a block an earlier "
          f"gather moved; top by "
          f"device time {fl[0]['top'][:4]} {tag}")
    if not ok(tp212):
        raise AssertionError("phase 19c: the 2x1x2 TP step disagrees")
    if not (h_loss == 0.0 and h_grad[0] <= TINY_GRAD_TENSOR
            and h_grad[2] <= TINY_GRAD_NORM and h_weights <= 1.0
            and h_moments[0] <= TINY_GRAD_TENSOR
            and h_moments[1] <= TINY_GRAD_NORM and only_rank0):
        raise AssertionError("phase 19c: hybrid ZeRO x TP differs")
    if not ok(tiny):
        raise AssertionError("phase 19a: the TP train step disagrees")
    if not (e_loss <= 1e-5 and e_cm and e_labels >= LABEL_SHARE
            and e_pose >= TP_POSE_SHARE and e_same):
        raise AssertionError("phase 19a: the TP eval step disagrees")
    if not (whole_same and all(
            math.isfinite(f["step_ms"]) and 0.45 <= a <= 0.55
            and 0.45 <= b <= 0.55 for f, (a, b) in zip(fl, share))):
        raise AssertionError("phase 19b: the flagship TP step failed, "
                             "holds more than its share or let its whole "
                             "leaves drift apart")
    return dict(tiny=tiny, hybrid=dict(loss=h_loss, grad=h_grad[::2],
                                       moments=h_moments),
                grid_212=tp212, eval=dict(loss_rel=e_loss, labels=e_labels,
                                          pose=e_pose),
                flagship=[{k: v for k, v in f.items()
                           if k not in ("top", "whole_leaves")} for f in fl],
                whole_bytes=(whole_params, whole_moments)), \
        sum(r["launches"] for r in ranks)


# Phase 22: the library around the model. The context heads at npp_tpu's
# default widths on a bs8 batch of the flagship's 1/4-resolution grid.
HEAD_INPUT = (8, 256, 96, 96)
HEAD_CASES = {
    "strip_pooling": lambda: H.StripPooling(256, (20, 12)),
    "sphead": lambda: H.SPHead(256, 20, (20, 12)),
    "psp": lambda: H.PSPModule(256, 512, (1, 2, 3, 6)),
    "aspp": lambda: H.ASPP(256, 256, (12, 24, 36)),
    "pmsf": lambda: H.PMSF(256, 256),
}
HEAD_CALLS = 10          # timed forwards a head (device_us)
HEAD_CPU_RTOL = 1e-4     # card fp32 vs CPU fp32 at batch 1, x max|ref|


def seeded_head(make, seed: int):
    """A head with seeded weights: convs ~ N(0, 1/fan_in), biases and
    running means ~ N(0, 0.1), BN scales and running variances in
    [0.5, 1.5]."""
    head = make()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in head.modules():
            if isinstance(m, torch.nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                               / math.sqrt(fan_in))
                if m.bias is not None:
                    m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
            elif isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(0.5 + torch.rand(c, generator=g))
                m.bias.copy_(0.1 * torch.randn(c, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                m.running_var.copy_(0.5 + torch.rand(c, generator=g))
    return head


def norm_rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    got, ref = got.detach().float(), ref.detach().float()
    return float((got - ref).norm() / ref.norm())


def check_head(name: str, make, x_cpu: torch.Tensor, tag: str) -> dict:
    """Phase 22a, one head: fp32 on the card (TF32 off) in eval and train
    mode; the same in bf16 under autocast, channels_last, with one
    backward; both against the fp32 ones; the card's fp32 eval forward
    against the CPU's at batch 1; device times of the forwards."""
    ref = seeded_head(make, SEED)
    cpu_ref = copy.deepcopy(ref).eval()
    ref = ref.cuda().to(memory_format=torch.channels_last)
    x = x_cpu.cuda().contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        e32 = ref.eval()(x)
        t32 = copy.deepcopy(ref).train()(x)
        one32 = ref(x[:1]).cpu()
        one_cpu = cpu_ref(x_cpu[:1])
    cpu_err = float((one32 - one_cpu).abs().max() / one_cpu.abs().max())
    bf = copy.deepcopy(ref)
    with torch.autocast("cuda", dtype=torch.bfloat16):
        with torch.no_grad():
            e16 = bf.eval()(x)
        xg = x.detach().clone().requires_grad_(True)
        t16 = bf.train()(xg)
        t16.float().square().mean().backward()
    grads = [p.grad for p in bf.parameters()] + [xg.grad]
    finite = all(g is not None and bool(torch.isfinite(g).all())
                 for g in grads)
    bf.eval()

    def fwd16():
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            return bf(x)

    def fwd32():
        with torch.no_grad():
            return ref(x)

    us16, q16 = device_us(fwd16, HEAD_CALLS)
    us32, q32 = device_us(fwd32, HEAD_CALLS)
    out = dict(eval_rel=norm_rel(e16, e32), train_rel=norm_rel(t16, t32),
               cpu_err=cpu_err, grads_finite=finite,
               shape=tuple(e16.shape), bf16_ms=us16 / 1e3,
               fp32_ms=us32 / 1e3, queued=q16 and q32,
               params=SM.count_parameters(ref))
    print(f"phase 22a: {name} on x{tuple(x.shape)}: out {out['shape']}, "
          f"{out['params']:,} parameters; bf16 vs fp32 (||diff|| / ||fp32||) "
          f"eval {out['eval_rel']:.3g}, train {out['train_rel']:.3g} (<= "
          f"{BF16_MAP_RTOL}); one bf16 train backward, gradients finite "
          f"{finite}; card fp32 vs CPU fp32 at batch 1 {cpu_err:.3g} of "
          f"max|ref| (<= {HEAD_CPU_RTOL}); forward device time bf16 "
          f"{out['bf16_ms']:.3f} ms, fp32 {out['fp32_ms']:.3f} ms "
          f"({HEAD_CALLS} calls, queued {out['queued']}) {tag}")
    if not (out["eval_rel"] <= BF16_MAP_RTOL
            and out["train_rel"] <= BF16_MAP_RTOL and finite
            and cpu_err <= HEAD_CPU_RTOL and e16.shape == e32.shape):
        raise AssertionError(f"phase 22a: the {name} head failed: {out}")
    return out


def flops_line(what: str, flops: float, tag: str) -> None:
    print(f"phase 22b: model_flops of {what}: {flops:,.0f} "
          f"({flops / 1e12:.4f} TFLOP; convolutions and matrix products, 2 "
          f"a multiply-add, FlopCounterMode) {tag}")


def model_summary(tag: str, model) -> dict:
    """Phase 22b on phase 5's flagship (bf16, channels_last): its
    parameter count and the FLOPs of the bs8 384x384 eval forward and of
    one flip-TTA serving batch of 8 images (two forwards and the
    decode's blur); the train step's count comes after phase 21a
    (``train_flops``)."""
    x = torch.randn((BATCH, 3, 384, 384), generator=torch.Generator()
                    .manual_seed(SEED)).cuda().contiguous(
                        memory_format=torch.channels_last)
    with torch.no_grad():
        eval_fwd = SM.model_flops(model, x)
    pred = Predictor(model, crop_size=(384, 384))
    ims = serve_images(BATCH, SERVE_SIZES)
    with torch.no_grad():
        serve = SM.model_flops(pred.predict_batch, ims)
    params = SM.count_parameters(model)
    print(f"phase 22b: flagship NPPNet (L=16, C=64, 20 classes, 16 joints): "
          f"{params:,} parameters ({SM.count_parameters_in_mb(model):.4f} "
          f"x 2^20) {tag}")
    flops_line(f"the bs{BATCH} 384x384 eval forward", eval_fwd, tag)
    flops_line(f"one flip-TTA serving batch of {BATCH} images "
               f"(Predictor.predict_batch)", serve, tag)
    print(f"phase 22b: the serving batch / (2 x the eval forward) = "
          f"{serve / (2 * eval_fwd):.6f} {tag}")
    # two forwards, and the decode's blur and fusion on top
    if not (eval_fwd > 0 and 2 * eval_fwd <= serve < 2.1 * eval_fwd):
        raise AssertionError(f"phase 22b: the serving batch counts {serve} "
                             f"against the forward's {eval_fwd}")
    return dict(params=params, eval_forward_bs8=eval_fwd,
                serve_batch_bs8=serve)


def train_flops(tag: str, ctx: dict, eval_fwd: float) -> float:
    """Phase 22b after 21a: the FLOPs of one flagship bs16 train step
    (forward, backward; Adam's elementwise update counts nothing) on
    phase 7's state and loader."""
    batch = take(ctx["loaders"][0], 1)
    flops = SM.model_flops(ctx["steps"], ctx["state"], batch)
    flops_line("one bs16 384x384 train step (forward and backward)", flops,
               tag)
    print(f"phase 22b: the train step / (2 x the bs8 eval forward) = "
          f"{flops / (2 * eval_fwd):.4f} (a backward counts about twice its "
          f"forward) {tag}")
    if not 4 * eval_fwd < flops < 8 * eval_fwd:
        raise AssertionError(f"phase 22b: the train step counts {flops}, "
                             f"the bs8 forward {eval_fwd}: the backward was "
                             f"not counted")
    return flops


def per_image_ms(fn, n: int) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3 / n


def host_helpers(tag: str, model, res: dict) -> dict:
    """Phase 22c on phase 4/5's first flagship batch, without cv2: the
    affine decode of the model's heatmaps, crops of its images, the
    drawings on its predictions, a debug dump read back, and the zip
    reader on the committed LIP fixtures."""
    ds = SyntheticDataset(length=N_IMAGES, crop_size=(384, 384), seed=SEED,
                          device_normalize=True)
    items = [ds[i] for i in range(BATCH)]
    images = np.stack([it["image"] for it in items])  # (B, H, W, 3) uint8
    mean, std = np.asarray(IMAGENET_MEAN), np.asarray(IMAGENET_STD)
    norm = (images / 255.0 - mean) / std
    x = torch.from_numpy(norm.astype(np.float32)).permute(0, 3, 1, 2)
    x = x.cuda().contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        pose_list, par_list = model(x)
        hm = pose_list[-1][0][:, :16].float().cpu().numpy()
        par = F.interpolate(par_list[-1][0].float(), size=(384, 384),
                            mode="bilinear", align_corners=True)
        labels = par.argmax(1).cpu().numpy()
    out, ms = {}, {}
    n = len(images)
    t0 = time.perf_counter()
    lib_path, _ = imgproc.build_library()  # the first use in the script
    build_s = time.perf_counter() - t0
    center = np.tile(np.float32([192, 192]), (n, 1))
    scale = np.full(n, 384 / 200.0)
    ms["get_final_preds"] = per_image_ms(
        lambda: out.update(dec=TR.get_final_preds(hm, center, scale)), n)
    preds, maxvals = out["dec"]
    coords = M._np_max_preds(hm)[0]
    # this box maps the 96x96 map onto the 384x384 image by x -> 4x, and
    # the quarter offset moves a peak by a quarter of a map pixel at most
    off = np.abs(preds - 4 * coords).max()
    if not (preds.shape == (n, 16, 2) and np.isfinite(preds).all()
            and off <= 4 * 0.25 + 1e-6):
        raise AssertionError(f"phase 22c: get_final_preds {preds.shape}, "
                             f"{off} px from the argmax's image position")
    ms["crop"] = per_image_ms(lambda: out.update(crops=[
        TR.crop(im, np.float32([192, 192]), 384 / 200.0, (384, 384))
        for im in images]), n)
    rotated = [TR.crop(im, np.float32([180, 200]), 1.5, (256, 256), 30.0)
               for im in images]
    identity = all(np.array_equal(c, im)
                   for c, im in zip(out["crops"], images))
    if not (identity and all(r.shape == (256, 256, 3) for r in rotated)):
        raise AssertionError("phase 22c: the identity crop is not the image")
    joints = res["pose_preds"][:n, :, :2]  # phase 5's decoded joints
    ms["draw_skeleton"] = per_image_ms(lambda: out.update(drawn=[
        vis.draw_skeleton(im, j) for im, j in zip(images, joints)]), n)
    ms["overlay_parsing"] = per_image_ms(lambda: out.update(parsed=[
        vis.overlay_parsing(im, lab) for im, lab in zip(images, labels)]), n)
    ms["overlay_heatmap"] = per_image_ms(lambda: out.update(heated=[
        vis.overlay_heatmap(im, h[0]) for im, h in zip(images, hm)]), n)
    same = all(np.array_equal(vis.overlay_parsing(im, lab, alpha=0.0), im)
               for im, lab in zip(images[:2], labels[:2]))
    changed = sum(int((d != im).any()) for d, im in zip(out["drawn"], images))
    with tempfile.TemporaryDirectory() as tmp:
        gt = np.stack([it["joints"] for it in items])
        gv = np.stack([it["visibility"] for it in items])
        ms["save_debug_batch"] = per_image_ms(lambda: out.update(
            paths=vis.save_debug_batch(norm, gt, tmp, visibility=gv,
                                       mean=mean, std=std)), n)
        back = [vis.read_png(p)[0] for p in out["paths"]]
        want = [vis.draw_skeleton(np.clip((im * std + mean) * 255, 0, 255)
                                  .astype(np.uint8), j, v)
                for im, j, v in zip(norm, gt, gv)]
        dumped = all(np.array_equal(a, b) for a, b in zip(back, want))
        # the zip reader on the committed LIP fixtures
        names = sorted(f for f in os.listdir(FIXTURES)
                       if f.endswith((".jpg", ".png")))
        archive = os.path.join(tmp, "lip.zip")
        with zipfile.ZipFile(archive, "w") as z:
            for f in names:
                z.write(os.path.join(FIXTURES, f), f"images/{f}")
            z.writestr("ann.xml", "<annotation><person>1</person>"
                                  "</annotation>")
        got = {}
        ms["zip_imread"] = per_image_ms(lambda: got.update(
            {f: zipreader.imread(f"{archive}@images/{f}") for f in names}),
            len(names))
        zipped = all(np.array_equal(
            got[f][:, :, ::-1],
            imgproc.read_jpeg(os.path.join(FIXTURES, f)) if f.endswith(".jpg")
            else vis.read_image(os.path.join(FIXTURES, f))) for f in names)
        grey = all(np.array_equal(
            zipreader.imread(f"{archive}@images/{f}", 0),
            vis.read_png(os.path.join(FIXTURES, f))[0])
            for f in names if f.endswith(".png"))
        xml = zipreader.xmlread(f"{archive}@ann.xml").find("person").text
    checks = dict(library=lib_path.name, build_s=round(build_s, 2),
                  identity_crop=identity, overlay_alpha0=same,
                  drawn_changed=changed, debug_round_trip=dumped,
                  zip_equal=zipped, zip_grey_equal=grey, xml=xml == "1",
                  zip_members=len(names))
    print(f"phase 22c: host helpers on phase 4/5's first batch ({n} images, "
          f"384x384) without cv2: ms an image {json.dumps({k: round(v, 3) for k, v in ms.items()})}; "
          f"checks {checks} {tag}")
    if not (same and dumped and zipped and grey and checks["xml"]
            and changed == n):
        raise AssertionError(f"phase 22c: a host helper failed: {checks}")
    return dict(ms_per_image=ms, **checks)


def library_slice(tag: str, model, res: dict) -> dict:
    """Phase 22: the heads (22a), the summary (22b) and the host helpers
    (22c), on phase 5's model and phase 4/5's batch; each section's
    seconds."""
    seconds, t0 = {}, time.perf_counter()
    x = torch.randn(HEAD_INPUT, generator=torch.Generator().manual_seed(SEED))
    heads_out = {name: check_head(name, make, x, tag)
                 for name, make in HEAD_CASES.items()}
    torch.cuda.empty_cache()
    seconds["22a"], t0 = time.perf_counter() - t0, time.perf_counter()
    flops = model_summary(tag, model)
    seconds["22b"], t0 = time.perf_counter() - t0, time.perf_counter()
    helpers = host_helpers(tag, model, res)
    seconds["22c"] = time.perf_counter() - t0
    print(f"phase 22: seconds by section "
          f"{json.dumps({k: round(v, 1) for k, v in seconds.items()})} {tag}")
    return dict(heads=heads_out, flops=flops, helpers=helpers,
                seconds=seconds)


# Phase 23: npp_tpu's one-dispatch programs as CUDA graphs
# (``core/graphs.py``): K train steps a replay, the eval epoch a replay.
SCAN_K = 4               # the flagship's steps a dispatch (--steps-per-dispatch)
SCAN_TINY_K = 3          # the tiny check: dispatches of 3 and 3, a tail of 2
SCAN_TINY_STEPS = 8
SCAN_TINY_LR_STEP = 4    # the schedule's boundary at update 4: inside the
                         # second dispatch (updates 3-5)
SCAN_TWINS = 3           # eager runs: the first is the reference, the others'
                         # distance from it the card's run-to-run spread
SCAN_EVAL_BATCHES = 2    # flagship bs8 batches of the timed eval epochs
SCAN_TINY_VAL = 5        # tiny eval set: batches of 2, 2 and a tail of 1


def scan_snapshot(state, losses) -> dict:
    """A tiny train run's end: its losses, and flat float64 copies of the
    weights with the lambdas (as phase 21's ``step_apart``), the BN
    statistics, Adam's moments, the lambdas' gradient sum, and the
    counts and learning rates."""
    opt = state.optimizer

    def flat(ts):
        return torch.cat([t.detach().double().reshape(-1).cpu() for t in ts])

    entries = [opt.state[p] for g in opt.param_groups for p in g["params"]]
    return dict(
        losses=[float(x) for x in losses],
        weights=flat([*state.model.parameters(), *state.lamdas.values()]),
        stats=flat([t for n, t in state.model.state_dict().items()
                    if "running" in n]),
        exp_avg=flat([e["exp_avg"] for e in entries]),
        exp_avg_sq=flat([e["exp_avg_sq"] for e in entries]),
        accum=flat([p.grad for p in state.lamdas.values()]),
        accum_by={k: flat([p.grad]) for k, p in state.lamdas.items()},
        counts=sorted({float(e["step"]) for e in entries}),
        lrs=[float(x) for x in state.scheduler.get_last_lr()],
        step=state.step)


SCAN_NORMS = ("weights", "stats", "exp_avg", "exp_avg_sq", "accum")
# The parts held to the eager twins' spread: norms over many values (the
# weights with the lambdas and each moment, 1,107,150 values at L=8, C=8;
# the BN statistics, 13,184).
SCAN_GATED = ("weights", "stats", "exp_avg", "exp_avg_sq")
# The lambdas' gradient sum is four values, too few for a spread of two
# twins to bound: its captured distance came out 0.65-2.4 x the twins'
# largest in the phase's first three runs (NVIDIA H100 80GB HBM3, 700 W).
# It is held to its own size instead, each lambda's sum within
# SCAN_ACCUM_RTOL of the eager one in norm. On the CPU the sums after the
# 8 steps are about (-76, -87) for lamda_pose and (5.9, 5.4) for
# lamda_par, and the captured and twin distances on the card were
# 0.007-0.030 for all four together: at most 0.4% of lamda_par's norm.
# A sum that restarted at each dispatch, or that a replay did not add to
# in place, would miss by the sum of the earlier dispatches' gradients,
# tens of percent of it; the phase measures that distance on the eager
# run and fails if the bound would not catch it.
SCAN_ACCUM_RTOL = 1e-2


def scan_apart(a: dict, b: dict) -> dict:
    """Two tiny runs apart: the first two steps' |loss difference| (each a
    forward from weights that are equal where the runs are
    deterministic), the norm of the later losses' differences, and the
    norm of each state part's difference."""
    d = [abs(x - y) for x, y in zip(a["losses"], b["losses"])]
    out = {"loss1": d[0], "loss2": d[1],
           "losses3+": math.sqrt(sum(x * x for x in d[2:]))}
    out.update({k: float((a[k] - b[k]).norm()) for k in SCAN_NORMS})
    return out


def scanned_tiny_train(tag: str) -> dict:
    """23a: the tiny configuration in fp32 (TF32 off), SCAN_TINY_STEPS
    updates from the seeded state: captured (dispatches of SCAN_TINY_K,
    the second across the schedule's boundary, then a tail) against
    SCAN_TWINS eager runs of the same steps with the same Adam
    (``train.make_capturable``: its arithmetic differs from the plain
    Adam's in the last bits, which ``adam_capturable_gap`` measures), so
    that only the graph differs. The first loss is a forward from equal
    weights and the counts and learning rates are host arithmetic: equal.
    The state's norms over many values (SCAN_GATED) within SPREAD_MARGIN
    x the eager twins' largest distance from the first eager run, as
    phase 21's; each lambda's gradient sum within SCAN_ACCUM_RTOL of its
    own norm. A single later loss follows updates that differ by the
    spread, which the OHEM pixel selection magnifies (in one run a
    loss's twins came out 0.00113 apart and the captured run 0.00421;
    the second loss, after one update, came out equal on both twins and
    3.8e-6 off on the captured run in one run, and 3.8e-6 off on a twin
    in another): those are reported."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    hp = dict(augment_lip.TINY_TRAIN, lr_step=(SCAN_TINY_LR_STEP,))
    batches = [tiny_batch("cuda", seed=SEED + 20 + i)
               for i in range(SCAN_TINY_STEPS)]

    # One state, given the seeded one's values anew for each run through
    # the port's checkpoint blob (as phase 21's twins): the runs start from
    # equal values without a model build each.
    st = augment_lip.init_state(eval_lip.TINY, hp, device="cuda",
                                dtype=torch.float32, seed=SEED,
                                steps_per_epoch=1)
    blob = copy.deepcopy(checkpoint.state_dict(st))

    def fresh():
        checkpoint.load_state_dict(st, copy.deepcopy(blob))
        return st

    eager = augment_lip.make_train_step(hp)
    last = (SCAN_TINY_STEPS - 1) // SCAN_TINY_K * SCAN_TINY_K
    runs, t0 = [], time.perf_counter()
    for twin in range(SCAN_TWINS):
        fresh()
        T.make_capturable(st)
        losses = []
        for i, b in enumerate(batches):
            if twin == 0 and i == last:  # where the last dispatch starts
                before_last = {k: p.grad.detach().double().norm().item()
                               for k, p in st.lamdas.items()}
            losses.append(eager(st, b)["loss"])
        runs.append(scan_snapshot(st, losses))
    eager_s, t0 = time.perf_counter() - t0, time.perf_counter()
    fresh()
    scanned = augment_lip.make_train_step(hp, scanned=True)
    keys = [k for k in batches[0] if k not in ("names", "index")]
    losses, sizes = [], []
    for i in range(0, SCAN_TINY_STEPS, SCAN_TINY_K):
        chunk = batches[i:i + SCAN_TINY_K]
        sizes.append(len(chunk))
        out = scanned(st, {k: graphs.stack([b[k] for b in chunk])
                           for k in keys})
        losses += out["loss"].tolist()
    captured = scan_snapshot(st, losses)
    captured_s = time.perf_counter() - t0
    graphs_made = len(scanned.programs)
    del st, scanned
    ref = runs[0]
    twins = [scan_apart(r, ref) for r in runs[1:]]
    spread = {k: max(t[k] for t in twins) for k in twins[0]}
    got = scan_apart(captured, ref)
    # Gated: the norms over many values. The later losses are single
    # numbers after updates that differ by the spread: reported with the
    # twins' spread, as phase 21 reports a loss it cannot gate.
    gated = list(SCAN_GATED)
    over = {k: (got[k], SPREAD_MARGIN * spread[k]) for k in gated
            if got[k] > SPREAD_MARGIN * spread[k]}
    # Each lambda's sum within SCAN_ACCUM_RTOL of its own size; a sum
    # restarted at each dispatch would be the earlier dispatches' sum
    # (``before_last``, in norm) away from the eager one.
    accum = {k: (float((captured["accum_by"][k] - r).norm()),
                 SCAN_ACCUM_RTOL * float(r.norm()), before_last[k])
             for k, r in ref["accum_by"].items()}
    over.update({f"accum {k}": (d, b) for k, (d, b, _) in accum.items()
                 if d > b})
    powerless = {k: (f, b) for k, (_, b, f) in accum.items() if f <= b}
    accum_s = ", ".join(f"{k} ({d:.3g}, {b:.3g}, {f:.3g})"
                        for k, (d, b, f) in accum.items())
    exact = (captured["losses"][0] == ref["losses"][0]
             and captured["counts"] == ref["counts"] == [SCAN_TINY_STEPS]
             and captured["lrs"] == ref["lrs"]
             and captured["step"] == ref["step"] == SCAN_TINY_STEPS)
    print(f"phase 23a: tiny fp32 train (L=8, C=8, 128x128, bs4, TF32 off), "
          f"{SCAN_TINY_STEPS} updates as captured dispatches of {sizes} "
          f"({graphs_made} graphs; lr_step at update {SCAN_TINY_LR_STEP}, "
          f"inside the second) vs {SCAN_TWINS} eager runs: losses "
          f"{['%.6f' % x for x in captured['losses']]} vs "
          f"{['%.6f' % x for x in ref['losses']]}; first loss, counts "
          f"{captured['counts']}, learning rates {captured['lrs']} equal "
          f"{exact}; captured vs eager "
          f"{', '.join(f'{k} {v:.3g}' for k, v in got.items())}; the twins' "
          f"spread {', '.join(f'{k} {v:.3g}' for k, v in spread.items())} "
          f"({', '.join(gated)} <= {SPREAD_MARGIN} x); each lambda's "
          f"gradient sum (captured distance, bound {SCAN_ACCUM_RTOL} x its "
          f"norm, a sum restarted at each dispatch) {accum_s}; the eager "
          f"runs {eager_s:.1f} s, the captured one "
          f"{captured_s:.1f} s {tag}")
    if not exact:
        raise AssertionError("phase 23a: the captured run's first loss, "
                             "counts or learning rates differ from eager")
    if powerless:
        raise AssertionError(f"phase 23a: a gradient sum restarted at each "
                             f"dispatch would pass the bound (distance, "
                             f"bound): {powerless}")
    if over or not all(math.isfinite(x) for x in captured["losses"]):
        raise AssertionError(f"phase 23a: the captured train run leaves the "
                             f"eager twins' spread (value, bound): {over}")
    return dict(sizes=sizes, apart=got, spread=spread, accum=accum)


def adam_capturable_gap(state) -> dict:
    """Capturable Adam (device counts, a tensor learning rate) against the
    eager foreach Adam on copies of ``state``'s parameters, three updates
    from the same seeded gradients: max |difference| in units of lr, and
    the share of elements that differ."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = [p.detach().float().clone() for p in state.model.parameters()]
    grads = [[torch.randn(p.shape, generator=gen, device="cuda")
              for p in params] for _ in range(3)]
    a = [torch.nn.Parameter(p.clone()) for p in params]
    b = [torch.nn.Parameter(p.clone()) for p in params]
    lr = 1e-3
    opt_a = torch.optim.Adam(a, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    opt_b = torch.optim.Adam(b, lr=torch.tensor(lr, device="cuda"),
                             betas=(0.9, 0.999), eps=1e-8, capturable=True)
    for g in grads:
        for pa, pb, gi in zip(a, b, g):
            pa.grad, pb.grad = gi.clone(), gi.clone()
        opt_a.step()
        opt_b.step()
    with torch.no_grad():
        diff = [(x - y).abs() for x, y in zip(a, b)]
    n = sum(d.numel() for d in diff)
    out = dict(max_lr=max(float(d.max()) for d in diff) / lr,
               differ=sum(int((d > 0).sum()) for d in diff) / n, elements=n)
    del a, b, opt_a, opt_b, grads, params, diff
    torch.cuda.empty_cache()
    return out


# The hand-written kernels' names on the device's record (each wrapper
# launches one of these a call), by the keys of ``int8_counts``.
INT8_KERNEL_NAMES = {
    "conv": r"\bint8_conv(_tiny)?_kernel\b",
    "quantize": r"\bquantize_(nhwc|flat|nchw_dynamic|nchw_static)_kernel\b",
    "absmax": r"\babsmax_kernel\b"}


# The profiler's record of a run can miss an event: one profiled replay
# of the bs8 int8 eval epoch listed 2,207 of the 2,208 quantize launches
# its capture recorded, with every output bit for bit (so each kernel
# ran), and the same per-batch pass lists 6,700-6,712 device operations
# from run to run (NVIDIA H100 80GB HBM3, 700 W). A replay's int8 kernels
# on the record are held to at least REPLAY_SEEN of the calls recorded
# into the graph, and to no more: a graph whose int8 nodes were dropped
# or replaced would list far fewer.
REPLAY_SEEN = 0.99


def graph_profile(fn, per: int) -> dict:
    """``profile_step`` of ``fn()``, each count and time per one of its
    ``per`` steps or batches; ``int8`` holds the int8 kernels that ran in
    all, counted by name on the device's record (INT8_KERNEL_NAMES)."""
    prof = profile_step(lambda s, b: fn(), None, None,
                        counted=INT8_KERNEL_NAMES)
    return dict(kernels=prof["kernels"] / per, busy_ms=prof["busy_ms"] / per,
                top=prof["top"][:4], int8=prof["counted"])


def scanned_flagship_train(tag: str, ctx: dict, train: dict) -> dict:
    """23a: phase 7's flagship bs16 bf16 state, one dispatch of SCAN_K
    captured steps (the capture and the instantiation timed apart), timed
    and profiled, beside phase 7's eager step (``train``: its median,
    profile and peak in this call; 23a timed its own eager steps before
    the cuts that made room for it); then capturable Adam against the
    eager one."""
    state, loader = ctx["state"], ctx["loaders"][0]
    hp = augment_lip.FLAGSHIP_TRAIN
    batches = take(loader, SCAN_K)
    scanned = augment_lip.make_train_step(hp, scanned=True)
    stacked = {k: graphs.stack([b[k] for b in batches])
               for k in batches[0] if k not in ("names", "index")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = scanned(state, stacked)["loss"]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    prog = next(iter(scanned.programs.values()))[1]
    t0 = time.perf_counter()
    losses = scanned(state, stacked)["loss"]
    torch.cuda.synchronize()
    scan_ms = (time.perf_counter() - t0) * 1e3 / SCAN_K
    scan_peak = torch.cuda.max_memory_allocated() / 2**30
    s_prof = graph_profile(lambda: scanned(state, stacked), SCAN_K)
    losses = first.tolist() + losses.tolist()
    gap = adam_capturable_gap(state)
    s_idle = 1.0 - s_prof["busy_ms"] / scan_ms
    print(f"phase 23a: flagship train step (bs16, 384x384, bf16, "
          f"channels_last) on phase 7's state: eager (phase 7) "
          f"{train['step_ms']:.3f} ms a step, {train['kernels']} device "
          f"operations, busy {train['busy_ms']:.3f} ms, idle share "
          f"{train['idle_share']:.3f}, peak {train['peak_gib']:.3f} GiB; "
          f"--steps-per-dispatch {SCAN_K}: {scan_ms:.3f} ms a step (one "
          f"replay of {SCAN_K}), {s_prof['kernels']:.0f} device operations "
          f"a step, busy {s_prof['busy_ms']:.3f} ms, idle share "
          f"{s_idle:.3f}, peak {scan_peak:.3f} GiB; capture "
          f"{prog.capture_s:.3f} s, instantiate {prog.instantiate_s:.3f} s, "
          f"first dispatch {first_s:.3f} s in all; losses of the two "
          f"dispatches {['%.4f' % x for x in losses]}; capturable Adam vs "
          f"eager Adam, 3 updates of {gap['elements']:,} parameters: max "
          f"|diff| {gap['max_lr']:.3g} lr, {gap['differ']:.3g} of the "
          f"elements differ {tag}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"phase 23a: non-finite losses {losses}")
    return dict(scanned_ms=scan_ms, scanned=s_prof, scanned_idle=s_idle,
                scanned_peak_gib=scan_peak, capture_s=prog.capture_s,
                instantiate_s=prog.instantiate_s, first_s=first_s,
                adam_gap=gap)


def eval_batches(device, n: int, batch: int, crop, tiny: bool = False,
                 seed: int = SEED) -> list:
    """``n`` synthetic eval images at ``batch`` through the loader with
    ``cache_on_device`` (targets rendered by the heatmap kernel once),
    as the epoch's batch list."""
    renderer = L.make_target_renderer(stride=4, sigma=eval_lip.SIGMA,
                                      num_joints=eval_lip.NUM_JOINTS,
                                      ignore=eval_lip.IGNORE,
                                      normalize_images=True)
    ds = SyntheticDataset(length=n, crop_size=crop,
                          num_joints=eval_lip.NUM_JOINTS,
                          num_classes=eval_lip.NUM_CLASSES, seed=seed,
                          device_normalize=True)
    loader = L.DataLoader(ds, batch, device=device, num_workers=4,
                          renderer=renderer, cache_on_device=True)
    return list(loader)


def same_result(a: dict, b: dict) -> bool:
    """Two validate results equal bit for bit: matrix, loss, predictions,
    names."""
    return (np.array_equal(a["cm"], b["cm"]) and a["loss"] == b["loss"]
            and np.array_equal(a["pose_preds"], b["pose_preds"])
            and a["names"] == b["names"])


def timed_pass(run, n_images: int) -> tuple[float, dict]:
    """(img/s of ``run()`` on the host clock after a warm call, its
    result)."""
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    return n_images / (time.perf_counter() - t0), res


def scanned_eval(tag: str, model) -> tuple[dict, dict]:
    """23b: the tiny eval epoch with a tail batch against ``validate``;
    the flagship bs8 flip-TTA eval (phase 11's bf16 model) per batch
    against ``--scanned`` in fp and int8 (dynamic scales): every output
    bit for bit, img/s, device operations, busy time and idle share a
    batch, the graphs' capture and instantiation; the int8 kernels'
    launches inside the graph. Returns the numbers and the int8 launch
    counts of the scanned int8 path."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tiny = build_nppnet(device="cuda", dtype=torch.float32,
                        generator=torch.Generator().manual_seed(SEED),
                        **eval_lip.TINY).to(memory_format=torch.channels_last)
    kw = dict(num_classes=eval_lip.NUM_CLASSES,
              class_weights=LIP_CLASS_WEIGHTS, ignore_index=eval_lip.IGNORE,
              flip_pairs=LIP.flip_pairs)
    crit = init_criterion_params(2, "cuda")
    tb = eval_batches("cuda", SCAN_TINY_VAL, 2, (128, 128), tiny=True)
    quiet = dict(num_classes=eval_lip.NUM_CLASSES, log_fn=lambda s: None)
    plain = E.validate(E.make_eval_step(tiny, decode_hw=(128, 128), **kw),
                       crit, tb, **quiet)
    scan = E.validate_scanned(E.make_eval_epoch(tiny, decode_hw=(128, 128),
                                                **kw), crit, tb, **quiet)
    tiny_same = same_result(scan, plain)
    del tiny
    batches = eval_batches("cuda", SCAN_EVAL_BATCHES * BATCH, BATCH,
                           (384, 384))
    n = len(batches) * BATCH
    crit = init_criterion_params(model.refine_layers + 1, "cuda")
    out, counts = {}, {}
    for mode in ("fp", "int8"):
        q = "int8" if mode == "int8" else None
        step = E.make_eval_step(model, decode_hw=(384, 384), quantize=q, **kw)
        epoch = E.make_eval_epoch(model, decode_hw=(384, 384), quantize=q,
                                  **kw)
        rate_b, res_b = timed_pass(
            lambda: E.validate(step, crit, batches, **quiet), n)
        p_b = graph_profile(lambda: E.validate(step, crit, batches, **quiet),
                            len(batches))
        # The wrappers count the first call's warm-up (eager launches)
        # and record the capture; a replay goes through no wrapper, so
        # its int8 launches are counted by name on the profiled replay's
        # device record and held against what the capture recorded.
        reset_int8_counts()
        t0 = time.perf_counter()
        E.validate_scanned(epoch, crit, batches, **quiet)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        first = int8_counts()
        rate_s, res_s = timed_pass(
            lambda: E.validate_scanned(epoch, crit, batches, **quiet), n)
        p_s = graph_profile(
            lambda: E.validate_scanned(epoch, crit, batches, **quiet),
            len(batches))
        eager_after = int8_counts()  # no wrapper ran in the replays
        prog = next(iter(epoch.programs.values()))
        recorded = dict(zip(("heatmap", "conv", "quantize", "absmax"),
                            prog.captured))
        replayed = p_s["int8"]
        counts[mode] = dict(launched=first, replayed=replayed)
        same = same_result(res_s, res_b)
        ms_b, ms_s = 1e3 * BATCH / rate_b, 1e3 * BATCH / rate_s
        out[mode] = dict(
            batch_img_s=rate_b, scanned_img_s=rate_s, same=same,
            batch=p_b, scanned=p_s, batch_idle=1 - p_b["busy_ms"] / ms_b,
            scanned_idle=1 - p_s["busy_ms"] / ms_s, capture_s=prog.capture_s,
            instantiate_s=prog.instantiate_s, first_s=first_s,
            captured=recorded, first_counts=first, replayed=replayed)
        print(f"phase 23b: flagship flip-TTA eval ({mode}, bs{BATCH}, "
              f"{n} images, phase 11's bf16 model): per batch "
              f"{rate_b:.2f} img/s, {p_b['kernels']:.0f} device operations "
              f"and busy {p_b['busy_ms']:.3f} ms a batch, idle share "
              f"{out[mode]['batch_idle']:.3f}; --scanned {rate_s:.2f} img/s, "
              f"{p_s['kernels']:.0f} operations and busy "
              f"{p_s['busy_ms']:.3f} ms a batch, idle share "
              f"{out[mode]['scanned_idle']:.3f}; capture "
              f"{prog.capture_s:.3f} s, instantiate {prog.instantiate_s:.3f}"
              f" s; calls recorded into the graph {recorded}; int8 kernels "
              f"on the device's record of one replay {replayed}; the "
              f"wrappers' launches (the warm-up) {first}, after the replays "
              f"{eager_after}; every output equal to the per-batch pass "
              f"{same} {tag}")
        if not same:
            raise AssertionError(f"phase 23b: the scanned {mode} eval "
                                 f"differs from the per-batch one")
        if eager_after != first:
            raise AssertionError(f"phase 23b: the {mode} replays went "
                                 f"through the wrappers {eager_after} "
                                 f"(after the warm-up {first})")
        if not all(REPLAY_SEEN * recorded[k] <= replayed[k] <= recorded[k]
                   for k in replayed):
            raise AssertionError(f"phase 23b: the {mode} replay ran the int8 "
                                 f"kernels {replayed} on the device; the "
                                 f"capture recorded {recorded}")
        del step, epoch, prog
        torch.cuda.empty_cache()
    print(f"phase 23b: tiny fp32 eval epoch ({SCAN_TINY_VAL} images: "
          f"batches of 2, 2 and a tail of 1, TF32 off), validate_scanned "
          f"vs validate: every output equal {tiny_same} {tag}")
    if not tiny_same:
        raise AssertionError("phase 23b: the tiny scanned eval differs")
    for kind in ("launched", "replayed"):
        check_int8_counts(f"scanned_eval_int8 ({kind})",
                          counts["int8"][kind], "dynamic")
        check_int8_counts(f"scanned_eval_fp ({kind})", counts["fp"][kind],
                          None)
    return dict(out, tiny_same=tiny_same), counts["int8"]


def scanned_train_cli(tag: str) -> dict:
    """23c: ``augment_lip --synthetic --steps-per-dispatch SCAN_K`` over
    two epochs of SCAN_K steps (the synthetic set's 4 batches), one
    dispatch each: a finite loss that falls from the first dispatch to
    the second. It keeps no times, so it runs beside phase 18's ranks."""
    with tempfile.TemporaryDirectory() as tmp:
        res = augment_lip.main(["--synthetic", "--steps", str(SCAN_K),
                                "--epochs", "2", "--steps-per-dispatch",
                                str(SCAN_K), "--out", tmp])
        means = []  # each dispatch's logged mean (the meter is per epoch)
        for root, _, files in os.walk(tmp):
            for f in sorted(files):
                if f.endswith(".log"):
                    with open(os.path.join(root, f)) as fh:
                        means += [float(line.split("Loss: ")[1].split()[0])
                                  for line in fh if "steps/dispatch" in line]
    out = dict(train_loss=res["train_loss"], dispatch_means=means)
    print(f"phase 23c: python -m npp_tpu_torch.tools.augment_lip --synthetic "
          f"--steps {SCAN_K} --epochs 2 --steps-per-dispatch {SCAN_K}: "
          f"mean loss of each dispatch {['%.4f' % x for x in means]}, train "
          f"loss {res['train_loss']:.6f}, "
          f"{eval_lip.result_line(res['result'])} {tag}")
    if not (len(means) == 2 and all(math.isfinite(x) for x in means)
            and means[1] < means[0]):
        raise AssertionError(f"phase 23c: the scanned train CLI's loss "
                             f"{means} is not finite and falling")
    return out


def scanned_eval_clis(tag: str) -> dict:
    """23c: ``eval_lip --synthetic --scanned`` and ``--scanned --int8``,
    with their wrappers' int8 launches (the graph's warm-up: a replay
    goes through no wrapper; 23b counts a replay's on the device)."""
    out = {}
    for name, extra in (("eval", []), ("eval_int8", ["--int8"])):
        reset_int8_counts()
        res = eval_lip.main(["--synthetic", "--scanned", *extra])
        counts = int8_counts()
        check_int8_counts(f"eval_lip --scanned {' '.join(extra)}", counts,
                          "dynamic" if extra else None)
        out[name] = dict(loss=res["loss"], mean_iou=res["mean_iou"],
                         int8=counts)
        print(f"phase 23c: python -m npp_tpu_torch.tools.eval_lip "
              f"--synthetic --scanned {' '.join(extra)}: "
              f"{eval_lip.result_line(res)}; the wrappers' int8 launches "
              f"(the warm-up) {counts} {tag}")
        if not (math.isfinite(res["loss"]) and len(res["names"]) == 16):
            raise AssertionError(f"phase 23c: {name} failed")
    return out


class PhaseClock:
    """Prints each phase's wall time on the host clock, and the total."""

    def __init__(self):
        self.start = self.last = time.perf_counter()
        self.seconds = {}

    def done(self, phase) -> None:
        now = time.perf_counter()
        self.seconds[phase] = now - self.last
        print(f"phase {phase}: {now - self.last:.1f} s (total "
              f"{now - self.start:.1f} s)")
        self.last = now


def main() -> int:
    line_buffered()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    clock = PhaseClock()
    # Phase 1: device.
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi()
    tag = f"[{smi}]"
    print(f"phase 1: {name}, compute capability {cap[0]}.{cap[1]}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"nvidia-smi: {smi}")
    clock.done(1)

    # Phase 2: build the kernels from this checkout's sources, one nvcc
    # each, side by side.
    t0 = time.perf_counter()

    def timed_build(build):
        start = time.perf_counter()
        lib, log = build()
        return lib, log, time.perf_counter() - start

    with ThreadPoolExecutor(3) as pool:
        builds = list(pool.map(timed_build, (
            heatmaps.build_kernels, Q.build_conv, Q.build_quantize)))
    for lib, log, build_s in builds:
        print(f"phase 2: built {lib.name} in {build_s:.2f} s "
              f"({time.perf_counter() - t0:.2f} s for all three)")
        for line in log.strip().splitlines():
            if ("registers" in line or "spill" in line
                    or "warning" in line.lower()):
                print(f"phase 2: ptxas: {line.strip()}")
    clock.done(2)

    # Phase 3: the kernel against its plain version on the card.
    kernel = check_kernel(tag)
    clock.done(3)

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
    clock.done(4)

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
    clock.done(5)

    # Phase 22: the library around the model, on phase 5's model and phase
    # 4/5's batch (the train step's FLOPs come after phase 21a).
    library = library_slice(tag, model, res16)
    del model
    torch.cuda.empty_cache()
    clock.done(22)

    # Phases 7 and 9 leave their CLI runs here for phase 11.
    runs = tempfile.TemporaryDirectory()

    # Phase 7: the flagship train slice in bf16 + channels_last.
    heatmaps.render_heatmaps.launches = 0  # the train path's count
    train, train_ctx = flagship_train(tag, runs.name)
    launches["train"] = heatmaps.render_heatmaps.launches
    clock.done(7)

    # Phase 21a: phase 7's train state to npp_tpu's tree and back.
    heatmaps.render_heatmaps.launches = 0  # the exchange path's count
    exchange = {"train": state_exchange(tag, "21a", train_ctx)}
    launches["exchange"] = heatmaps.render_heatmaps.launches
    clock.done("21a")

    # Phase 22b: the FLOPs of one flagship train step, on phase 7's state.
    library["flops"]["train_step_bs16"] = train_flops(
        tag, train_ctx, library["flops"]["eval_forward_bs8"])
    clock.done("22b")

    # Phase 23a: K train steps a dispatch (one CUDA graph replay), the tiny
    # run against eager twins, then on phase 7's state (which it leaves
    # with a capturable Adam).
    heatmaps.render_heatmaps.launches = 0  # the scanned train path's count
    scanned = {"train": scanned_flagship_train(tag, train_ctx, train)}
    launches["scanned_train"] = heatmaps.render_heatmaps.launches
    del train_ctx
    torch.cuda.empty_cache()
    clock.done("23a")

    # Phase 9: the search slice at the reference scale.
    heatmaps.render_heatmaps.launches = 0  # the search path's count
    search, search_ctx = flagship_search(tag, runs.name)
    launches["search"] = heatmaps.render_heatmaps.launches
    clock.done(9)

    # Phase 21b: phase 9's search state to npp_tpu's tree and back.
    heatmaps.render_heatmaps.launches = 0  # the exchange path's count
    exchange["search"] = state_exchange(tag, "21b", search_ctx)
    launches["exchange"] += heatmaps.render_heatmaps.launches
    del search_ctx
    torch.cuda.empty_cache()
    clock.done("21b")

    # Phase 11: the serving slice at the flagship width. It renders no
    # targets, so the heatmap kernel must not run on it.
    heatmaps.render_heatmaps.launches = 0  # the serving path's count
    serve, serve_ctx = flagship_serve(tag, train["checkpoints"],
                                      search["genotype"])
    launches["serve"] = heatmaps.render_heatmaps.launches
    clock.done(11)

    # Phase 20: npp_tpu's serving layouts on phase 11's model and images;
    # it counts the int8 kernel's launches by path itself, and the eval
    # CLI's heatmap kernel launches.
    layouts, int8_entry, quant_entry = serving_layouts(tag, serve_ctx,
                                                       serve)
    launches["eval_int8"] = layouts.pop("heatmap_launches")
    clock.done(20)

    # Phase 23b-c: the eval epoch as one CUDA graph replay, on phase 11's
    # model, fp and int8 (its int8 launches by path), then the CLIs.
    heatmaps.render_heatmaps.launches = 0  # the scanned eval path's count
    scanned["eval"], scanned_int8 = scanned_eval(tag, serve_ctx["model"])
    del serve_ctx
    torch.cuda.empty_cache()
    clock.done("23b")
    reset_int8_counts()
    scanned["cli"] = scanned_eval_clis(tag)
    launches["scanned_eval"] = heatmaps.render_heatmaps.launches
    clock.done("23c eval CLIs")
    reset_int8_counts()  # phases 12-19 are fp paths

    # Phase 13: the PPP path at the flagship width; it counts the kernel's
    # launches on the PPP train and search paths itself.
    ppp, ppp_launches = flagship_ppp(tag, runs.name)
    launches.update(ppp_launches)
    clock.done(13)

    # Phase 15: the LIP reader and the paths fed from a LIP tree on disk.
    trees = tempfile.TemporaryDirectory()
    lip_root = os.path.join(trees.name, "lip")
    heatmaps.render_heatmaps.launches = 0  # the LIP-from-disk path's count
    from_disk = lip_from_disk(tag, runs.name, lip_root)
    launches["lip_disk"] = heatmaps.render_heatmaps.launches
    clock.done(15)

    # Phase 16: the PPP reader and the fused warp; it counts the kernel's
    # launches on the PPP-from-disk and fused-LIP paths itself.
    more_disk, disk_launches = ppp_and_fused_from_disk(
        tag, runs.name, lip_root, from_disk)
    launches.update(disk_launches)
    clock.done(16)
    trees.cleanup()

    # Phase 17b's first part: NCCL at world size 1 in this process, the
    # DDP step timed on a quiet card; it counts the launches on the DDP
    # train path.
    nccl, launches["ddp_train"], loss32 = nccl_world_one(tag, train)
    clock.done("17b DDP step")
    # Phases 17a and 18 share one pair of gloo ranks on the card (one
    # spawn), and 19's four ranks are spawned as 18 begins. What has no
    # times to keep runs beside the ranks' tiny work: 17b's CLIs under
    # torchrun, the card-against-CPU checks of phases 6, 8, 10 and 12 and
    # 23a's tiny check beside 17a's, phase 14's chain and 23c's train CLI
    # beside 18's untimed work, 19's tiny steps beside 18 (before phase 23
    # came each ran alone, in the order of its number). A rank takes its
    # timed flagship step, and 18's ranks their timed sections, only once
    # this process has said the card is quiet (``go``). The ranks count the
    # heatmap kernel's launches themselves (18's on the sp train path,
    # and the int8 kernels' on the mesh serving paths; its one-process
    # references count theirs), the CLIs theirs on the DDP paths.
    clis, pair, tp_ranks = DdpClis(), RankPair(), None
    side = {}

    def beside_17a():
        clock.done("17a one process")
        side["tiny"] = check_tiny_train(tag)
        clock.done(6)
        side["tiny_search"] = check_tiny_search(tag)
        clock.done(8)
        side["tiny_serve"] = check_tiny_serve(tag)
        clock.done(10)
        side["tiny_ppp"] = check_tiny_ppp(tag)
        clock.done(12)
        side["scanned_tiny"] = scanned_tiny_train(tag)
        clock.done("23a tiny")
        side["cli"], side["cli_launches"] = clis.finish(tag, loss32)
        clock.done("17b CLIs")

    try:
        shared, launches["ddp_shared_card"] = shared_card(
            tag, train, pair, before_flagship=beside_17a)
        nccl.update(side["cli"])
        launches["ddp_train"] += side["cli_launches"].pop("ddp_train")
        launches.update(side["cli_launches"])
        clock.done("17a")
        tp_ranks = TpRanks()
        tp_refs = tp_references()
        # Phase 14: the search -> train -> eval chain on phase 9's
        # artifacts.
        heatmaps.render_heatmaps.launches = 0  # the chain's count
        chained = chain(tag, runs.name, search["genotype"],
                        search["search_checkpoints"])
        launches["chain"] = heatmaps.render_heatmaps.launches
        runs.cleanup()
        clock.done(14)
        heatmaps.render_heatmaps.launches = 0  # 23c's train CLI's count
        scanned["train_cli"] = scanned_train_cli(tag)
        launches["scanned_train"] += heatmaps.render_heatmaps.launches
        scanned["tiny_train"] = side["scanned_tiny"]
        clock.done("23c train CLI")
        fp_counts = int8_counts()
        check_int8_counts("phases 12-17", fp_counts, None)
        sp, launches["sp_train"], sp_int8 = spatial_parallel(
            tag, pair, before_timed=tp_ranks.wait_tiny)
        clock.done(18)
        reset_int8_counts()  # phase 19 is an fp path
        # Phase 19: tensor parallelism; its ranks count the heatmap
        # kernel's launches on the TP paths (19a-c's batches).
        tp, launches["tp_train"] = tensor_parallel(tag, tp_ranks, tp_refs)
        clock.done(19)
    finally:
        clis.stop()
        pair.stop()
        if tp_ranks is not None:
            tp_ranks.stop()
    tp_counts = int8_counts()
    check_int8_counts("phase 19", tp_counts, None)
    for entry, key in ((int8_entry, "conv"), (quant_entry, "quantize")):
        # Launched by a graph's replay, without the wrapper: one profiled
        # replay's kernels by name (phase 23b), apart from ``launches``.
        entry["replay_launches_by_path"] = {
            "scanned_eval_int8": scanned_int8["replayed"][key]}
    for path, got in (("scanned_eval_int8", scanned_int8["launched"]),
                      ("eval_scanned_int8_cli", scanned["cli"]["eval_int8"]
                       ["int8"]),
                      ("phases_12_17", fp_counts), ("phase_19", tp_counts),
                      *sp_int8.items()):
        int8_entry["launches_by_path"][path] = got["conv"]
        quant_entry["launches_by_path"][path] = (got["quantize"]
                                                 + got["absmax"])
        quant_entry["quantize_launches_by_path"][path] = got["quantize"]
        quant_entry["absmax_launches_by_path"][path] = got["absmax"]
    seconds = {k: round(v, 1) for k, v in clock.seconds.items()}
    summary = {"tiny_train": side["tiny"], "train_step": train,
               "tiny_search": side["tiny_search"], "search_pair": search,
               "tiny_serve": side["tiny_serve"], "serve": serve,
               "serving_layouts": layouts,
               "tiny_ppp": side["tiny_ppp"], "ppp": ppp, "chain": chained,
               "lip_disk": from_disk, "ppp_and_fused_disk": more_disk,
               "ddp_shared_card": shared, "ddp_nccl": nccl,
               "spatial": sp, "tensor": tp, "state_exchange": exchange,
               "library": library, "scanned": scanned}
    print(f"summary: heatmap kernel launches on the main paths: {launches}; "
          f"phase seconds {json.dumps(seconds)}; "
          f"summary {json.dumps(summary)}")
    for path in ("eval", "train", "search", "ppp_train", "ppp_search",
                 "chain", "lip_disk", "ppp_disk", "lip_fast_disk",
                 "ddp_shared_card", "ddp_train", "ddp_search", "ddp_eval",
                 "sp_train", "tp_train", "eval_int8", "exchange",
                 "scanned_train", "scanned_eval"):
        if launches[path] == 0:
            raise AssertionError(f"the {path} path never launched the "
                                 f"heatmap kernel")
    if launches["serve"] != 0:
        raise AssertionError("the serving path launched the heatmap kernel")

    print(json.dumps({"kernels": [{
        "name": "render_heatmaps", "route": "cuda",
        "source": "npp_tpu_torch/ops/csrc/render_heatmaps.cu",
        "replaces": "npp_tpu/ops/pallas_kernels.py:71",
        "launches": sum(launches.values()), "launches_by_path": launches,
        **kernel}, {
        "launches": sum(int8_entry["launches_by_path"].values()),
        **int8_entry}, {
        "launches": sum(quant_entry["launches_by_path"].values()),
        **quant_entry}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cli"]:  # a rank of phase 17b's torchrun CLIs
        sys.exit(cli_rank(sys.argv[2], sys.argv[3], sys.argv[4:]))
    sys.exit(main())
