"""Training stack of the port: config, optimizer and schedules, train
state, the train steps (one, or K per call) and the eval step,
checkpoints, BN recalibration, metrics, histograms and loggers
(``leaf_tpu.training``'s counterparts)."""

from leaf_tpu_torch.training.config import (  # noqa: F401
    get_config,
    parse_config,
)

from leaf_tpu_torch.training.optim import (  # noqa: F401
    ReduceLROnPlateau,
    optimization_helper,
    step_schedule,
    warmup_cosine_schedule,
)
from leaf_tpu_torch.training.state import (  # noqa: F401
    TrainState,
    rewind_steps,
    set_group_lr,
)
from leaf_tpu_torch.training.steps import (  # noqa: F401
    bce_logits_loss,
    cross_entropy_loss,
    make_eval_step,
    make_train_multistep,
    make_train_step,
    mixup,
    pad_batch_to_multiple,
    waveform_from_wire,
)

__all__ = [
    "get_config",
    "parse_config",
    "optimization_helper",
    "ReduceLROnPlateau",
    "step_schedule",
    "warmup_cosine_schedule",
    "TrainState",
    "rewind_steps",
    "set_group_lr",
    "make_train_step",
    "make_train_multistep",
    "make_eval_step",
    "mixup",
    "cross_entropy_loss",
    "bce_logits_loss",
    "pad_batch_to_multiple",
    "waveform_from_wire",
]
