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

__all__ = ["TrainState", "rewind_steps"]


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
    sched = state.scheduler
    if sched is not None:
        sched.last_epoch = max(sched.last_epoch - n, 0)
        lrs = [base * fn(sched.last_epoch)
               for base, fn in zip(sched.base_lrs, sched.lr_lambdas)]
        for group, lr in zip(state.optimizer.param_groups, lrs):
            group["lr"] = lr
        sched._last_lr = lrs
    return state
