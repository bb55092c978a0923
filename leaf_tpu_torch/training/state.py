"""Train state: the model, its optimizer, the per-batch lr scheduler and
the step counter, held together.

The JAX package keeps one functional ``TrainState`` PyTree (params,
batch_stats, optax state, step); PyTorch keeps the same state in the
module (parameters and BatchNorm buffers) and the optimizer, updated in
place by the train step. The class keeps the JAX class's name so a
reader finds the counterpart.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

__all__ = ["TrainState", "rewind_steps", "set_group_lr", "schedule_lrs",
           "set_schedule_clock"]


def set_group_lr(group: dict, lr: float) -> None:
    """Write ``lr`` into an optimizer param group: in place where the lr
    is a tensor (a capturable optimizer's, which a CUDA graph reads), as a
    float otherwise."""
    if torch.is_tensor(group["lr"]):
        group["lr"].fill_(lr)
    else:
        group["lr"] = lr


def schedule_lrs(sched: torch.optim.lr_scheduler.LambdaLR,
                 clock: int) -> list:
    """Each param group's lr at schedule step ``clock``."""
    return [base * fn(clock) for base, fn in zip(sched.base_lrs,
                                                 sched.lr_lambdas)]


def set_schedule_clock(sched: torch.optim.lr_scheduler.LambdaLR,
                       clock: int) -> None:
    """Move a per-batch ``LambdaLR`` to step ``clock`` (never below 0) and
    write that step's lr into its optimizer's groups."""
    sched.last_epoch = max(clock, 0)
    lrs = schedule_lrs(sched, sched.last_epoch)
    for group, lr in zip(sched.optimizer.param_groups, lrs):
        set_group_lr(group, lr)
    sched._last_lr = lrs


@dataclass
class TrainState:
    model: nn.Module
    optimizer: Optional[torch.optim.Optimizer]   # None: evaluation only
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None
    step: int = 0   # train steps taken (the JAX state's ``step``)

    def apply_gradients(self) -> None:
        """One optimizer update from the gradients in ``.grad``, then the
        per-batch schedule, then the step counter."""
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()
        self.step += 1


def rewind_steps(state: TrainState, n: int) -> TrainState:
    """Rewind the schedule clock by ``n`` steps, in place; returns ``state``.

    ``state.step``, every parameter's optimizer ``step`` (Adam's bias
    correction; SGD keeps none) and the per-batch scheduler's clock
    (``last_epoch``, with the lr recomputed from it) move back by ``n``,
    never below 0; the moments stay as they are. This is
    ``leaf_tpu.training.state.rewind_steps``, which rewinds ``step`` and
    every optax ``count`` and keeps ``mu``/``nu``.

    Used by the preemption save: resume redoes the interrupted epoch from
    its start, so without the rewind a step-indexed schedule (warmupcosine)
    would run ahead by the mid-epoch steps already taken.
    """
    state.step = max(state.step - n, 0)
    for param_state in state.optimizer.state.values():
        step = param_state.get("step")
        if torch.is_tensor(step):
            step.copy_(torch.clamp(step - n, min=0))
        elif step is not None:
            param_state["step"] = max(step - n, 0)
    if state.scheduler is not None:
        set_schedule_clock(state.scheduler, state.scheduler.last_epoch - n)
    return state
