"""Bi-level search: the search state and the alternating weight and
architecture steps.

Port of ``npp_tpu/core/search.py``:

- the weight optimizer is Adam (betas 0.9 / 0.999, eps 1e-8) over every
  model weight at ``w_lr`` with the per-iteration MultiStep schedule
  (``core/train.multistep_lr``), plus the two loss lambdas at a constant
  1e-4; the architecture parameters are not in it;
- the arch optimizer is Adam over the 12 architecture parameters alone,
  at ``alpha_lr`` with betas (0.5, 0.999), eps 1e-8 and L2 weight decay
  1e-3 added to the gradient (optax's ``add_decayed_weights`` +
  ``scale_by_adam``);
- the weight step's loss is the dual-task loss; the arch step's is
  ``2 * loss + 2 * entropy * entropy_coef`` (the reference's
  ``train_with_alpha``), with ``entropy_coef`` 1 after the entropy epoch.

Every step sets the gradient of every parameter (weights, architecture
parameters, lambdas) to None before its backward: JAX takes fresh
gradients each step, so the arch optimizer must never see the weight
step's gradients. The backward reaches every parameter, so both Adams
update all of theirs each step, as optax updates every leaf. A weight step
advances the schedule and the step count; an arch step advances neither.
The steps run eagerly, mutate the state in place and return their metrics
as device tensors.

Under a process group the supernet is distributed as the train state's
model is (``core/train.distribute``): the architecture parameters are
model parameters, so DDP averages their gradients with the weights'; the
loss is the global batch's and the lambdas' gradient is averaged over the
ranks (``core/train.backward``). With ``zero`` both optimizers are
ZeRO-1.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn as nn
from torch.optim.lr_scheduler import LambdaLR

from npp_tpu_torch.core import criterion
from npp_tpu_torch.core.train import (CRITERION_LR, _constant, backward,
                                      compute_losses, distribute,
                                      multistep_lr)
from npp_tpu_torch.models.genotype_parse import loss_entropy
from npp_tpu_torch.models.search import SearchNet, build_search_model
from npp_tpu_torch.parallel import zero as Z

ALPHA_BETAS = (0.5, 0.999)
ALPHA_WEIGHT_DECAY = 1e-3  # the JAX search CLI's, not the yaml's 1e-4


@dataclasses.dataclass
class SearchState:
    """The supernet, the loss lambdas (``nn.Parameter``s), the weight
    optimizer and its schedule, the arch optimizer, and the count of
    weight updates; ``net`` and ``group`` as in ``TrainState``."""
    model: SearchNet
    lamdas: dict
    w_optimizer: torch.optim.Optimizer
    w_scheduler: LambdaLR
    a_optimizer: torch.optim.Optimizer
    step: int = 0
    net: nn.Module | None = None
    group: object = None

    def __post_init__(self):
        if self.net is None:
            self.net = self.model

    def zero_grad(self) -> None:
        self.model.zero_grad(set_to_none=True)
        for p in self.lamdas.values():
            p.grad = None


def make_search_optimizers(model: SearchNet, lamdas: dict, *, w_lr: float,
                           alpha_lr: float, lr_step: Sequence[int],
                           lr_factor: float, steps_per_epoch: int,
                           zero: bool = False):
    """(weight optimizer, its scheduler, arch optimizer); both ZeRO-1
    with ``zero``."""
    w_opt = Z.adam(
        [{"params": model.weight_parameters(), "lr": w_lr,
          "name": "weights"},
         {"params": list(lamdas.values()), "lr": CRITERION_LR,
          "name": "criterion"}],
        zero=zero, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)
    w_sched = LambdaLR(w_opt, [multistep_lr(lr_step, lr_factor,
                                            steps_per_epoch), _constant])
    a_opt = Z.adam(
        [{"params": list(model.arch_parameters().values()), "name": "arch"}],
        zero=zero, lr=alpha_lr, betas=ALPHA_BETAS, eps=1e-8,
        weight_decay=ALPHA_WEIGHT_DECAY)
    return w_opt, w_sched, a_opt


def init_search_state(*, generator: torch.Generator, device, w_lr: float,
                      alpha_lr: float, lr_step: Sequence[int],
                      lr_factor: float, steps_per_epoch: int,
                      group=None, zero: bool = False,
                      **model_kw) -> SearchState:
    """A fresh search state: the supernet in train mode with weights drawn
    from ``generator`` (``build_search_model``), the lambdas at their
    reference inits, and both optimizers; distributed over ``group``
    (``core/train.distribute``), ZeRO-1 with ``zero``."""
    model = build_search_model(device=device, generator=generator,
                               train=True, **model_kw)
    net, loss_group = distribute(model, group)
    init = criterion.init_criterion_params(model.refine_layers + 1, device)
    lamdas = {k: nn.Parameter(v) for k, v in init.items()}
    w_opt, w_sched, a_opt = make_search_optimizers(
        model, lamdas, w_lr=w_lr, alpha_lr=alpha_lr, lr_step=lr_step,
        lr_factor=lr_factor, steps_per_epoch=steps_per_epoch, zero=zero)
    return SearchState(model=model, lamdas=lamdas, w_optimizer=w_opt,
                       w_scheduler=w_sched, a_optimizer=a_opt, net=net,
                       group=loss_group)


def make_search_steps(*, class_weights, ignore_index: int = 255,
                      ohem_thres: float = 0.9, ohem_keep: int = 131072,
                      use_target_weight: bool = False):
    """Returns (weight_step, arch_step).

    ``weight_step(state, batch)`` trains the weights and lambdas on a
    train batch; ``arch_step(state, batch, entropy_coef)`` the architecture
    parameters on a mini batch. Both return {loss, loss_pose, loss_par,
    entropy} (the dual-task loss before the arch step's scaling)."""
    loss_kw = dict(class_weights=class_weights, ignore_index=ignore_index,
                   ohem_thres=ohem_thres, ohem_keep=ohem_keep,
                   use_target_weight=use_target_weight)

    def forward_backward(state: SearchState, batch, scale: float,
                         entropy_coef: float) -> dict:
        state.net.train()
        state.zero_grad()
        loss, metrics, _ = compute_losses(state.net, state.lamdas, batch,
                                          group=state.group, **loss_kw)
        ent = loss_entropy(state.model.arch_parameters())
        total = scale * loss
        if entropy_coef:
            total = total + 2.0 * ent * entropy_coef
        backward(total, state.lamdas, state.group)
        metrics["entropy"] = ent.detach()
        return metrics

    def weight_step(state: SearchState, batch) -> dict:
        metrics = forward_backward(state, batch, 1.0, 0.0)
        state.w_optimizer.step()
        state.w_scheduler.step()
        state.step += 1
        return metrics

    def arch_step(state: SearchState, batch, entropy_coef: float) -> dict:
        metrics = forward_backward(state, batch, 2.0, float(entropy_coef))
        state.a_optimizer.step()
        return metrics

    return weight_step, arch_step


def get_arch_params(state: SearchState) -> dict:
    """The architecture parameters as float32 numpy arrays by name."""
    return {k: p.detach().float().cpu().numpy()
            for k, p in state.model.arch_parameters().items()}

