"""Training stack of the port: optimizer and schedules, train state, and
the train and eval steps (``leaf_tpu.training``'s counterparts)."""

from leaf_tpu_torch.training.optim import (  # noqa: F401
    ReduceLROnPlateau,
    optimization_helper,
    step_schedule,
    warmup_cosine_schedule,
)
from leaf_tpu_torch.training.state import TrainState  # noqa: F401
from leaf_tpu_torch.training.steps import (  # noqa: F401
    bce_logits_loss,
    cross_entropy_loss,
    make_eval_step,
    make_train_step,
    mixup,
    pad_batch_to_multiple,
    waveform_from_wire,
)

__all__ = [
    "optimization_helper",
    "ReduceLROnPlateau",
    "step_schedule",
    "warmup_cosine_schedule",
    "TrainState",
    "make_train_step",
    "make_eval_step",
    "mixup",
    "cross_entropy_loss",
    "bce_logits_loss",
    "pad_batch_to_multiple",
    "waveform_from_wire",
]
