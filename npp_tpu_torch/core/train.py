"""Augment-phase training: the optimizer and its schedule, the train state
and the train step.

Port of ``npp_tpu/core/train.py:33-176, 218-247, 281-293``:

- Adam (optax's defaults: betas 0.9 / 0.999, eps 1e-8, no weight decay)
  over three parameter groups with the labels of ``_label_params``:
  ``backbone`` (the stems and both encoder cell stacks, at 0.2x the
  learning rate), ``weights`` (every other model parameter) and
  ``criterion`` (the two learned loss lambdas, at a constant 1e-4);
- the torch ``MultiStepLR`` of the reference as a per-iteration
  ``LambdaLR``: update t (counted from 0) runs at lr * factor^n, n the
  number of boundaries (epoch * steps_per_epoch) at or below t, as optax's
  ``piecewise_constant_schedule``;
- the reference's lambda-gradient accumulation (``TrainState.crit_accum``
  in the JAX package): each step zeroes the model's gradients only, so
  autograd adds each step's lambda gradient to ``.grad`` and Adam sees
  their running sum.

The step runs eagerly and mutates the state in place; its metrics stay
device tensors (the host reads nothing inside a step). Not ported: the
batch-tiling warning, a TPU workaround.

``make_train_step_scanned`` is npp_tpu's K steps a dispatch
(``train.py:250-264``, a ``lax.scan`` of the step body): on a card the K
steps are one CUDA graph replay (``core/graphs.Program``), on the CPU
the same body runs K times. For the capture, Adam becomes
``capturable`` (its counts on the device) with a device tensor for each
group's learning rate, which the graph sets at each step from a (K,
groups) table filled before each replay from the schedule, so a
dispatch that straddles an ``lr_step`` boundary steps as K single steps
do; the lambdas' gradient sum is a tensor made before the capture and
added to in place. One process only: under a process group it refuses
(gloo's collectives cannot be captured; npp_tpu's ZeRO path with
``steps_per_dispatch`` is not ported).

Under a process group (``init_train_state(group=)``, ``parallel/``) the
model's BNs take cross-rank moments (more than one rank), DDP wraps it
(``TrainState.net``, which the step calls; ``TrainState.model`` stays the
bare module, so state_dict keys carry no ``module.``), the loss is the
global batch's, and ``backward`` averages the lambdas' gradient of this
step over the ranks before it joins their running sum. With ``zero``
the optimizer is ZeRO-1 (``parallel/zero.py``).

On a ``data x space`` grid (``init_train_state(grid=)``,
``make_train_step(grid=)``, ``parallel/spatial.py``) the model runs on
this rank's rows (``spatial.convert_spatial``), DDP, the cross-rank BN
and the criterion span the grid's ranks, and each rank's batch is its
data shard's rows (``spatial.shard_batch_spatial``); the step is
npp_tpu's one-device step on the global batch, as under a data group. On
a ``data x space x model`` grid the model is built whole from the seed,
converted to compute this rank's channel blocks
(``tensor.convert_tensor_parallel``), and DDP, the cross-rank BN, the
criterion and the lambdas' gradient mean span the grid's replica group
(the ranks that hold the same blocks; the world at n_model 1); every
model rank of a (d, s) takes the same batch. With ``zero`` on such a
grid the optimizer is the hybrid ZeRO-1 of ``parallel/zero.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch
import torch.nn as nn
from torch.optim.lr_scheduler import LambdaLR

from npp_tpu_torch.core import criterion, graphs
from npp_tpu_torch.models.augment import build_nppnet
from npp_tpu_torch.parallel import mesh, zero as Z
from npp_tpu_torch.parallel.spatial import convert_spatial
from npp_tpu_torch.parallel.sync_bn import convert_sync_bn
from npp_tpu_torch.parallel.tensor import (convert_tensor_parallel,
                                           share_replicated)

BACKBONE_LR_SCALE = 0.2     # augment_lip_sync.py:193-202 in the reference
CRITERION_LR = 1e-4         # search_lip_sync.py:277-278
_BACKBONE_MODULES = ("cells1", "cells2", "stem")
TASKS = ("both", "pose", "par")


def multistep_lr(lr_step: Sequence[int], lr_factor: float,
                 steps_per_epoch: int) -> Callable[[int], float]:
    """The learning-rate factor of update t (``LambdaLR``'s lambda)."""
    boundaries = sorted({int(e) * steps_per_epoch for e in lr_step})

    def factor(t: int) -> float:
        return lr_factor ** sum(t >= b for b in boundaries)

    return factor


def _constant(t: int) -> float:
    return 1.0


def param_group(name: str) -> str:
    """The optimizer group of model parameter ``name`` (a state_dict key):
    the JAX package's label of the same leaf (``_label_params``); a DDP
    wrapper's ``module.`` prefix is seen through."""
    top = name.removeprefix("module.").split(".", 1)[0]
    return "backbone" if top.startswith(_BACKBONE_MODULES) else "weights"


def make_train_optimizer(model: nn.Module, lamdas: dict, *, base_lr: float,
                         lr_step: Sequence[int], lr_factor: float,
                         steps_per_epoch: int, zero: bool = False,
                         grid=None):
    """Adam over the ``weights``, ``backbone`` and ``criterion`` groups
    (ZeRO-1 with ``zero``; on a ``grid`` with a model axis, over its data
    group), and its per-iteration schedule. Returns (optimizer,
    scheduler)."""
    groups: dict[str, list] = {"weights": [], "backbone": []}
    for name, p in model.named_parameters():
        groups[param_group(name)].append(p)
    optimizer = Z.adam(
        [{"params": groups["weights"], "lr": base_lr, "name": "weights"},
         {"params": groups["backbone"], "lr": BACKBONE_LR_SCALE * base_lr,
          "name": "backbone"},
         {"params": list(lamdas.values()), "lr": CRITERION_LR,
          "name": "criterion"}],
        zero=zero, grid=grid, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=0.0)
    factor = multistep_lr(lr_step, lr_factor, steps_per_epoch)
    scheduler = LambdaLR(optimizer, [factor, factor, _constant])
    return optimizer, scheduler


@dataclasses.dataclass
class TrainState:
    """The model, the learned loss lambdas (``lamda_pose``, ``lamda_par``
    as ``nn.Parameter``s), Adam, its schedule and the count of updates.
    With ``criterion_grad_accum`` the lambdas' ``.grad`` is the running
    sum of their gradients, as the reference's (module docstring).
    ``net`` is the module the step calls (DDP over ``model`` under a
    process group, else ``model``); ``group`` is the process group the
    loss and the lambda gradients span (None on one rank)."""
    model: nn.Module
    lamdas: dict
    optimizer: torch.optim.Optimizer
    scheduler: LambdaLR
    step: int = 0
    criterion_grad_accum: bool = True
    net: nn.Module | None = None
    group: object = None

    def __post_init__(self):
        if self.net is None:
            self.net = self.model

    def zero_grad(self) -> None:
        """The model's gradients to None; without accumulation the
        lambdas' to zero, in place (0 + g is g), so that a captured step
        keeps writing the tensor it recorded."""
        self.model.zero_grad(set_to_none=True)
        if not self.criterion_grad_accum:
            for p in self.lamdas.values():
                if p.grad is not None:
                    p.grad.zero_()

    def apply_update(self) -> None:
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1


def distribute(model: nn.Module, group):
    """(the module a step calls, the group its loss spans) for ``model``
    under the process group ``group``: with more than one rank its BNs
    become cross-rank ones; DDP wraps it whenever ``group`` is given."""
    if group is None:
        return model, None
    loss_group = mesh.multi_rank(group)
    if loss_group is not None:
        convert_sync_bn(model, loss_group)
    return mesh.wrap_model(model, group), loss_group


def init_train_state(*, generator: torch.Generator, device, base_lr: float,
                     lr_step: Sequence[int], lr_factor: float,
                     steps_per_epoch: int, criterion_grad_accum: bool = True,
                     group=None, zero: bool = False, grid=None,
                     **model_kw) -> TrainState:
    """A fresh train state: NPPNet in train mode with weights drawn from
    ``generator`` (``build_nppnet``; channels_last on a card), the lambdas
    at their reference inits, and the optimizer over both. Under the
    process group ``group`` the model is distributed (``distribute``),
    with ``zero`` the optimizer is ZeRO-1. On a ``grid`` (``mesh.
    make_grid``) the model runs on this rank's rows and channel blocks and
    is distributed over the grid's replica group (``group`` must then be
    None)."""
    if grid is not None:
        if group is not None:
            raise ValueError("give a grid or a group, not both")
        group = grid.replica_group
    model = build_nppnet(device=device, generator=generator, train=True,
                         **model_kw)
    if torch.device(device).type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    convert_spatial(model, grid)
    convert_tensor_parallel(model, grid)
    net, loss_group = distribute(model, group)
    init = criterion.init_criterion_params(model.refine_layers + 1, device)
    lamdas = {k: nn.Parameter(v) for k, v in init.items()}
    optimizer, scheduler = make_train_optimizer(
        model, lamdas, base_lr=base_lr, lr_step=lr_step, lr_factor=lr_factor,
        steps_per_epoch=steps_per_epoch, zero=zero, grid=grid)
    return TrainState(model=model, lamdas=lamdas, optimizer=optimizer,
                      scheduler=scheduler,
                      criterion_grad_accum=criterion_grad_accum, net=net,
                      group=loss_group)


def backward(loss: torch.Tensor, lamdas: dict, group=None) -> None:
    """``loss.backward()``; with ``group``, the lambdas' gradient of this
    step is averaged over its ranks before it is added to what their
    ``.grad`` held (the running sum of ``criterion_grad_accum``), so the
    sum grows by the global gradient on every rank."""
    if group is None:
        loss.backward()
        return
    held = {k: p.grad for k, p in lamdas.items()}
    for p in lamdas.values():
        p.grad = None
    loss.backward()
    flat = mesh.all_sum(torch.cat([p.grad for p in lamdas.values()]), group)
    flat = flat / torch.distributed.get_world_size(group)
    for (k, p), g in zip(lamdas.items(),
                         flat.split([p.numel() for p in lamdas.values()])):
        p.grad = g if held[k] is None else held[k] + g


def compute_losses(model: nn.Module, lamdas: dict, batch: dict, *,
                   class_weights, ignore_index: int = 255,
                   ohem_thres: float = 0.9, ohem_keep: int = 131072,
                   use_target_weight: bool = False, task: str = "both",
                   group=None, grid=None):
    """Forward (in the model's current mode) + dual-task loss; with
    ``group`` the parsing losses are the global batch's, with ``grid``
    from every rank's rows (``core/criterion.py``).

    ``task`` is ``both`` (the joint loss), ``pose`` or ``par`` (the
    single-task variants). Returns (loss, metrics, (pose_list,
    par_list)); the metrics are detached device tensors."""
    if task not in TASKS:
        raise ValueError(f"task must be one of {TASKS}, got {task!r}")
    pose_list, par_list = model(batch["image"])
    tw = batch["pose_weight"] if use_target_weight else None
    loss_pose = criterion.pose_loss(pose_list, batch["pose"],
                                    batch["pose_aux"], lamdas["lamda_pose"],
                                    target_weight=tw, grid=grid)
    loss_par = criterion.parsing_loss(par_list, batch["par"], batch["edge"],
                                      lamdas["lamda_par"],
                                      class_weights=class_weights,
                                      ignore_index=ignore_index,
                                      thres=ohem_thres, min_kept=ohem_keep,
                                      group=group, grid=grid)
    loss = {"pose": loss_pose, "par": loss_par}.get(task,
                                                     loss_pose + loss_par)
    metrics = {"loss": loss.detach(), "loss_pose": loss_pose.detach(),
               "loss_par": loss_par.detach()}
    return loss, metrics, (pose_list, par_list)


def make_train_step(*, class_weights, ignore_index: int = 255,
                    ohem_thres: float = 0.9, ohem_keep: int = 131072,
                    use_target_weight: bool = False, task: str = "both",
                    grid=None):
    """Returns ``step(state, batch) -> metrics``: the model in train mode,
    the gradients zeroed (the model's; the lambdas' too without
    accumulation), forward, loss, backward, one Adam update and one
    schedule step. ``batch`` is a rendered device batch
    (``data/loader.py``; on a ``grid``, this rank's rows of it, as the
    state's). ``use_target_weight`` masks the pose loss by
    ``pose_weight``; both released CLIs leave it off."""
    loss_kw = dict(class_weights=class_weights, ignore_index=ignore_index,
                   ohem_thres=ohem_thres, ohem_keep=ohem_keep,
                   use_target_weight=use_target_weight, task=task,
                   grid=grid)

    def step(state: TrainState, batch: dict) -> dict:
        state.net.train()
        metrics = train_update(state, batch, **loss_kw)
        state.scheduler.step()
        state.step += 1
        return metrics

    return step


def train_update(state: TrainState, batch: dict, lrs=None,
                 **loss_kw) -> dict:
    """The body of one train step, shared by the eager step
    (``make_train_step``) and each step of the scanned one, captured or
    not: the gradients zeroed (``TrainState.zero_grad``), forward, loss,
    backward, one Adam update. With ``lrs`` (a row of ``lr_table``) each
    group's learning rate is set from it first: written in place where
    the group's rate is a device tensor (a capturable Adam), else as a
    Python float. The schedule's step and the count of updates stay on
    the host, with the caller."""
    state.zero_grad()
    loss, metrics, _ = compute_losses(state.net, state.lamdas, batch,
                                      group=state.group, **loss_kw)
    backward(loss, state.lamdas, state.group)
    share_replicated(state.model, state.lamdas.values())
    if lrs is not None:
        for group, lr in zip(state.optimizer.param_groups, lrs):
            if isinstance(group["lr"], torch.Tensor):
                group["lr"].copy_(lr)
            else:
                group["lr"] = float(lr)
    state.optimizer.step()
    return metrics


def make_capturable(state: TrainState) -> list:
    """Make ``state``'s Adam capturable, in place, and return its learning
    rate tensors (one a group): each group's ``lr`` becomes a float32
    device tensor and ``capturable`` is set, every parameter gets its
    state (a device ``step`` count, the two moments; zero where it had
    none, as Adam's first step would make them), and the lambdas' running
    gradient sum exists (zeros where it was None; 0 + g is g). Adam's
    arithmetic is then the capturable one, whose bias corrections run on
    the device in float32: it may differ from the eager one in the last
    bits."""
    opt = state.optimizer
    if not isinstance(opt, torch.optim.Adam):
        raise ValueError(f"the scanned step captures a plain Adam, not "
                         f"{type(opt).__name__}")
    for p in state.lamdas.values():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    lrs = []
    for group in opt.param_groups:
        dev = group["params"][0].device
        lr = group["lr"]
        if not (isinstance(lr, torch.Tensor) and lr.device == dev
                and lr.dtype == torch.float32):  # a restored one: on the CPU
            group["lr"] = torch.tensor(float(lr), dtype=torch.float32,
                                       device=dev)
        group["capturable"] = True
        lrs.append(group["lr"])
        for p in group["params"]:
            st = opt.state[p]
            if "step" not in st:
                st["step"] = torch.zeros((), dtype=torch.float32, device=dev)
                st["exp_avg"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                st["exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
            else:
                st["step"] = st["step"].to(device=dev, dtype=torch.float32)
    return lrs


def _state_tensors(state: TrainState) -> list:
    """Every tensor a train step updates: weights, buffers (BN
    statistics), the lambdas and their gradient sum, Adam's state and
    learning rates."""
    out = [*state.model.parameters(), *state.model.buffers()]
    for p in state.lamdas.values():
        out += [p, p.grad]
    for st in state.optimizer.state.values():
        out += [v for v in st.values() if isinstance(v, torch.Tensor)]
    out += [g["lr"] for g in state.optimizer.param_groups]
    return out


def lr_table(state: TrainState, k: int) -> torch.Tensor:
    """(k, groups) float64 on the host: each group's learning rate at the
    state's next k updates, as ``LambdaLR`` would set it before each (a
    capturable Adam's float32 rates take it rounded)."""
    sched = state.scheduler
    t0 = sched.last_epoch
    return torch.tensor(
        [[base * fn(t0 + i) for base, fn in zip(sched.base_lrs,
                                                sched.lr_lambdas)]
         for i in range(k)], dtype=torch.float64)


def make_train_step_scanned(*, class_weights, ignore_index: int = 255,
                            ohem_thres: float = 0.9, ohem_keep: int = 131072,
                            use_target_weight: bool = False,
                            task: str = "both"):
    """Returns ``step(state, stacked) -> metrics``: K steps of
    ``train_update`` on a batch stacked on a leading axis of K
    (``graphs.stack`` of K loader batches), the metrics (K,) tensors,
    each step's learning rates read from ``lr_table``, so that a dispatch
    across an ``lr_step`` boundary steps as K single steps. On a CUDA
    device the K steps are one replay of a CUDA graph captured at the
    first call of each K and batch shape (module docstring; its
    ``programs`` are kept on the step); on the CPU the same body runs K
    times eagerly with the plain Adam (the plain version). The state
    moves by K updates."""
    loss_kw = dict(class_weights=class_weights, ignore_index=ignore_index,
                   ohem_thres=ohem_thres, ohem_keep=ohem_keep,
                   use_target_weight=use_target_weight, task=task)
    programs: dict = {}

    def body(state: TrainState, inputs: dict, k: int) -> dict:
        metrics = [train_update(state,
                                {n: v[i] for n, v in inputs.items()
                                 if n != "lr"}, inputs["lr"][i], **loss_kw)
                   for i in range(k)]
        return {n: torch.stack([m[n] for m in metrics]) for n in metrics[0]}

    def program(state: TrainState, stacked: dict, k: int) -> graphs.Program:
        key = (id(state), k, tuple((n, tuple(v.shape), v.dtype)
                                   for n, v in sorted(stacked.items())))
        if key in programs:
            return programs[key][1]
        lrs = make_capturable(state)
        inputs = dict(stacked, lr=torch.zeros((k, len(lrs)),
                                              dtype=torch.float32,
                                              device=stacked["image"].device))
        prog = graphs.Program(lambda x: body(state, x, k), inputs,
                              warmup=lambda x: body(state, x, 1),
                              restore=_state_tensors(state))
        state.model.zero_grad(set_to_none=True)
        programs[key] = (state, prog)  # the state kept: its id stays its own
        return prog

    def step(state: TrainState, stacked: dict) -> dict:
        graphs.one_process("the scanned train step",
                           "npp_tpu's ZeRO steps_per_dispatch")
        k = stacked["image"].shape[0]
        state.net.train()
        inputs = dict(stacked, lr=lr_table(state, k))
        if stacked["image"].device.type == "cuda":
            out = {n: v.clone() for n, v in
                   program(state, stacked, k)(inputs).items()}
        else:
            out = body(state, inputs, k)
        for _ in range(k):
            state.scheduler.step()
        state.step += k
        return out

    step.programs = programs
    return step
