"""Data pipeline of the port: so far the on-device augments of the train
step (the host pipeline is a later slice)."""

from leaf_tpu_torch.data.device_augment import (  # noqa: F401
    leaf_device_augment,
    peak_normalize,
)

__all__ = ["leaf_device_augment", "peak_normalize"]
