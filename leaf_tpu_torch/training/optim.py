"""Optimizer and learning-rate schedules, as the JAX package builds them.

Capability parity with ``leaf_tpu.training.optim`` (after reference
utilities/training_utils.py:39-78):

- Adam, or SGD with momentum (Nesterov by default), over *all* parameters
  with classic coupled L2 weight decay (``grad += wd·param`` before the
  moments: ``torch.optim``'s ``weight_decay``, optax's
  ``add_decayed_weights`` first in the chain). optax decays every leaf,
  BatchNorm and PCEN included, and so does this.
- schedules 'warmupcosine' (linear warm-up, then cosine to 0) and 'step'
  (StepLR per train step), as ``LambdaLR`` stepped once per batch. The
  step k-th update uses lr(k), k from 0, so lr is 0 on the first update
  under warm-up — optax's ``scale_by_schedule`` reads its count before it
  increments it.
- 'reduce': a host-side ReduceLROnPlateau (max mode) whose lr the caller
  writes into the optimizer's ``param_groups`` once per epoch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional, Tuple

import torch

__all__ = ["optimization_helper", "ReduceLROnPlateau",
           "warmup_cosine_schedule", "step_schedule"]


def warmup_cosine_schedule(base_lr: float, warmup_steps: int,
                           total_steps: int) -> Callable[[int], float]:
    """HF get_cosine_schedule_with_warmup: linear 0→lr over the warm-up,
    then 0.5·(1+cos(π·progress))·lr decaying to 0."""

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return base_lr * step / max(1.0, warmup_steps)
        progress = (step - warmup_steps) / max(1.0, total_steps - warmup_steps)
        return base_lr * 0.5 * (1.0 + math.cos(
            math.pi * min(max(progress, 0.0), 1.0)))

    return schedule


def step_schedule(base_lr: float, step_size_epochs: int, gamma: float,
                  steps_per_epoch: int) -> Callable[[int], float]:
    """torch StepLR, lr·gamma^(epoch // step_size), per train step."""

    def schedule(step: int) -> float:
        epoch = step // max(1, steps_per_epoch)
        return base_lr * gamma ** math.floor(epoch / step_size_epochs)

    return schedule


@dataclass
class ReduceLROnPlateau:
    """Host-side ReduceLROnPlateau, max mode (reference
    training_utils.py:60-64: factor=gamma, patience, min_lr=1e-6,
    threshold=5e-3 relative)."""

    base_lr: float
    factor: float = 0.1
    patience: int = 15
    min_lr: float = 1e-6
    threshold: float = 5e-3
    lr: float = field(init=False)
    best: float = field(init=False)
    num_bad_epochs: int = field(init=False, default=0)

    def __post_init__(self):
        self.lr = self.base_lr
        self.best = -math.inf

    def step(self, metric: float) -> float:
        """Feed the epoch metric; returns the (possibly reduced) lr."""
        # torch's 'rel' threshold in max mode: better is metric >
        # best·(1+eps); the −inf start makes the first epoch better
        if metric > self.best * (1.0 + self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        return {"lr": self.lr, "best": self.best,
                "num_bad_epochs": self.num_bad_epochs}

    def load_state_dict(self, state: dict) -> None:
        self.lr = state["lr"]
        self.best = state["best"]
        self.num_bad_epochs = state["num_bad_epochs"]


def _base_optimizer(name: str, cfg_opt: dict,
                    params: Iterable[torch.nn.Parameter],
                    lr: float, capturable: bool) -> torch.optim.Optimizer:
    wd = float(cfg_opt.get("weight_decay", 0.0))
    params = list(params)
    if capturable:
        # the lr as a 0-d tensor on the parameters' device, which a CUDA
        # graph reads at replay (a float would be captured as a constant)
        lr = torch.tensor(lr, device=params[0].device)
    if name == "Adam":
        # optax.scale_by_adam defaults: b1 0.9, b2 0.999, eps 1e-8
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=wd, capturable=capturable)
    if name == "SGD":
        if capturable:
            raise ValueError("capturable=True takes Adam (torch's SGD "
                             "reads a tensor lr on the host)")
        return torch.optim.SGD(params, lr=lr,
                               momentum=float(cfg_opt.get("momentum", 0.9)),
                               nesterov=bool(cfg_opt.get("nesterov", True)),
                               weight_decay=wd)
    raise ValueError(f"Unsupported optimizer {name}")


def optimization_helper(
    cfg: dict,
    params: Iterable[torch.nn.Parameter],
    num_tr_steps_per_epoch: Optional[int] = None,
    num_epochs: Optional[int] = None,
    capturable: bool = False,
    num_devices: int = 1,
    per_device_lr_scaling: bool = False,
) -> Tuple[torch.optim.Optimizer,
           Optional[torch.optim.lr_scheduler.LambdaLR],
           Optional[ReduceLROnPlateau], str]:
    """Build (optimizer, per-batch scheduler or None, plateau controller
    or None, scheduler name) from the cfg's ``opt`` section.

    'warmupcosine' and 'step' return a ``LambdaLR`` to step once per
    batch, after ``optimizer.step()``; 'reduce' returns a controller whose
    ``step(metric)`` gives the lr for every parameter group, once per
    epoch.

    ``capturable=True`` builds the optimizer that a CUDA graph of train
    steps can hold (``make_train_multistep`` on the card): Adam with
    ``capturable=True`` (its step counts on the device) and each group's
    lr a 0-d device tensor that the schedule and the plateau controller
    write in place (``state.set_group_lr``).

    ``per_device_lr_scaling`` multiplies the cfg's lr by ``num_devices``
    (the linear scaling rule for a global batch that grows with the
    devices), as the JAX helper does; off by default.
    """
    cfg_opt = cfg["opt"]
    name = cfg_opt.get("optimizer", "Adam")
    lr = float(cfg_opt.get("lr", 1e-3))
    if per_device_lr_scaling:
        lr = lr * num_devices
    optimizer = _base_optimizer(name, cfg_opt, params, lr, capturable)

    scheduler_name = cfg_opt.get("scheduler", "reduce")
    if scheduler_name == "warmupcosine":
        if num_tr_steps_per_epoch is None or num_epochs is None:
            raise ValueError("'warmupcosine' needs num_tr_steps_per_epoch "
                             "and num_epochs")
        total = num_tr_steps_per_epoch * num_epochs
        warmup = num_tr_steps_per_epoch * int(cfg_opt.get("warmup_epochs", 10))
        schedule = warmup_cosine_schedule(lr, warmup, total)
    elif scheduler_name == "step":
        if num_tr_steps_per_epoch is None:
            raise ValueError("'step' needs num_tr_steps_per_epoch")
        schedule = step_schedule(
            lr, int(cfg_opt.get("step_size", 30)),
            float(cfg_opt.get("gamma", 0.1)), num_tr_steps_per_epoch)
    elif scheduler_name == "reduce":
        controller = ReduceLROnPlateau(
            base_lr=lr,
            factor=float(cfg_opt.get("gamma", 0.1)),
            patience=int(cfg_opt.get("patience", 15)),
        )
        return optimizer, None, controller, scheduler_name
    else:
        raise ValueError(f"Unsupported scheduler {scheduler_name}")
    # LambdaLR multiplies the base lr by the factor it returns; a float
    # base keeps its per-step lr writes free of host syncs under a tensor lr
    for group in optimizer.param_groups:
        group["initial_lr"] = lr
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: schedule(step) / lr if lr else 0.0)
    return optimizer, scheduler, None, scheduler_name
