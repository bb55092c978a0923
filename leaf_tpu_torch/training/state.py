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

__all__ = ["TrainState"]


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None
    step: int = 0   # train steps taken (the JAX state's ``step``)

    def apply_gradients(self) -> None:
        """One optimizer update from the gradients in ``.grad``, then the
        per-batch schedule, then the step counter."""
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()
        self.step += 1
