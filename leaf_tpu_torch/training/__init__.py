"""Training stack of the port: config, optimizer and schedules, train
state, the train and eval steps, checkpoints, BN recalibration, metrics
and loggers (``leaf_tpu.training``'s counterparts)."""

from leaf_tpu_torch.training.config import get_config  # noqa: F401

from leaf_tpu_torch.training.optim import (  # noqa: F401
    ReduceLROnPlateau,
    optimization_helper,
    step_schedule,
    warmup_cosine_schedule,
)
from leaf_tpu_torch.training.state import (  # noqa: F401
    TrainState,
    rewind_steps,
)
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
    "get_config",
    "optimization_helper",
    "ReduceLROnPlateau",
    "step_schedule",
    "warmup_cosine_schedule",
    "TrainState",
    "rewind_steps",
    "make_train_step",
    "make_eval_step",
    "mixup",
    "cross_entropy_loss",
    "bce_logits_loss",
    "pad_batch_to_multiple",
    "waveform_from_wire",
]
