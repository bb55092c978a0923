"""The explicit per-replica data-parallel train step.

``leaf_tpu.parallel.shard_step`` in the port. The JAX package's
``shard_map`` step runs the body on each device's shard with its own
BatchNorm statistics (the reference's torch-xla per-replica behaviour),
then takes the mean over the 'data' axis of the gradients, the loss and
the running statistics, and the sums of ``correct`` and ``count``
(reference: train_xla.py:283). Here each rank runs the single-device
body on its rows, and one flat ``all_reduce`` sums all of those at once.
Each rank draws its randomness from a generator folded by its rank and
the step, as the JAX step folds its key by ``axis_index`` and
``state.step``.

The default data-parallel step (``make_train_step(process_group=...)``)
is the GSPMD semantic instead: BatchNorm over the global batch.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from leaf_tpu_torch.parallel.data_parallel import flat_all_reduce_
from leaf_tpu_torch.training.state import TrainState
from leaf_tpu_torch.training.steps import _train_step_body

__all__ = ["make_shard_map_train_step", "fold_generator"]

_FOLD = 1_000_003   # a prime: distinct (seed, rank, step) → distinct seeds


def fold_generator(generator: Optional[torch.Generator], *values: int
                   ) -> Optional[torch.Generator]:
    """A new generator on ``generator``'s device seeded from its initial
    seed and ``values`` (``jax.random.fold_in``'s role); None stays None."""
    if generator is None:
        return None
    seed = generator.initial_seed()
    for v in values:
        seed = (seed * _FOLD + int(v)) % (2 ** 63)
    return torch.Generator(device=generator.device).manual_seed(seed)


def make_shard_map_train_step(mesh, model_type: str = "multiclass",
                              mixup_alpha: Optional[float] = None,
                              augment_fn: Optional[Callable] = None
                              ) -> Callable:
    """(state, x, y, generator) → metrics, x and y this rank's rows of the
    batch over ``mesh``'s 'data' dim; ``state`` is updated in place."""
    group = mesh.get_group("data")
    body = _train_step_body(model_type, mixup_alpha, augment_fn)

    def step(state: TrainState, x: torch.Tensor, y: torch.Tensor,
             generator: Optional[torch.Generator] = None):
        world, r = dist.get_world_size(group), dist.get_rank(group)
        metrics = body(state, x, y, fold_generator(generator, r, state.step))
        model = state.model
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        stats = [b for m in model.modules()
                 if isinstance(m, torch.nn.BatchNorm2d)
                 for b in (m.running_mean, m.running_var)]
        loss = metrics["loss"]
        extra = torch.stack([loss.float(), metrics["correct"].float(),
                             metrics["count"].float()])
        flat_all_reduce_(grads + stats + [extra], group)
        for t in grads + stats:
            t.div_(world)
        state.apply_gradients()
        return {"loss": (extra[0] / world).to(loss.dtype),
                "correct": extra[1].round().to(torch.int32),
                "count": extra[2].round().to(torch.int32)}

    return step
