"""BatchNorm statistics re-estimation.

EfficientNet's torch-parity BN momentum is 0.99, so running statistics
need O(1000) steps to catch up with the parameters: short runs evaluate
with stale statistics. This re-walks data in train mode with frozen
parameters to refresh the running stats — ``leaf_tpu.training
.bn_recalibrate``'s recipe, on the statistics the port's ``BatchNorm2d``
keeps (Flax's biased variance, ``leaf_tpu_torch.models.common``).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch

from leaf_tpu_torch.parallel.sync_batch_norm import sync_batch_norm
from leaf_tpu_torch.training.state import TrainState

__all__ = ["recalibrate_batch_stats"]


def recalibrate_batch_stats(state: TrainState, batches: Iterable,
                            generator: Optional[torch.Generator],
                            momentum_passes: int = 1,
                            preprocess: Optional[Callable] = None,
                            process_group=None) -> TrainState:
    """Refresh the BatchNorm running stats of ``state.model`` from data.

    Args:
      state: TrainState; its parameters stay as they are.
      batches: iterable of (x, y) or x batches on the model's device
        (labels ignored).
      generator: ``torch.Generator`` on the model's device for dropout /
        drop-connect (and ``preprocess``) during the passes.
      momentum_passes: walk the iterable this many times.
      preprocess: optional ``(generator, x) -> x`` run before the forward
        — pass the train step's wire decode + device augment so the stats
        are estimated on the input distribution the parameters saw.
      process_group: under data parallelism, the group whose global batch
        gives the statistics (``parallel.sync_batch_norm``), as the train
        step takes them; every rank walks the same number of batches.

    With the momentum 0.99, N batches move the stats (1 − 0.99^N) of the
    way to the fresh estimate: ~100 batches recover 63 %, ~400 recover
    98 %. Runs under ``torch.no_grad`` in train mode and restores the
    model's mode; returns ``state``, updated in place.
    """
    model = state.model
    was_training = model.training
    model.train()
    try:
        with torch.no_grad(), sync_batch_norm(model, process_group):
            for _ in range(momentum_passes):
                for batch in batches:
                    x = batch[0] if isinstance(batch, (tuple, list)) else batch
                    if preprocess is not None:
                        x = preprocess(generator, x)
                    model(x, generator)
    finally:
        model.train(was_training)
    return state
