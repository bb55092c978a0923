"""The classifier zoo, in PyTorch (efficientnet so far)."""

from leaf_tpu_torch.models.classifier import (  # noqa: F401
    Classifier,
    get_classifier,
)
from leaf_tpu_torch.models.jax_import import load_jax_variables  # noqa: F401
