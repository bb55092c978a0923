"""The classifier zoo, in PyTorch: efficientnet, resnet (with NetVLAD),
cifar_resnet and densenet, the LEAF ``Classifier`` wrapper, and the
weight interop (reference checkpoints, published backbones, JAX
variables)."""

from leaf_tpu_torch.models.classifier import Classifier, get_classifier
from leaf_tpu_torch.models.efficientnet import (EfficientNet,
                                                efficientnet_params)
from leaf_tpu_torch.models.jax_import import load_jax_variables
from leaf_tpu_torch.models.netvlad import NetVLAD
from leaf_tpu_torch.models.pretrained import load_pretrained_backbone
from leaf_tpu_torch.models.torch_import import import_torch_classifier

__all__ = [
    "Classifier",
    "get_classifier",
    "EfficientNet",
    "efficientnet_params",
    "NetVLAD",
    "import_torch_classifier",
    "load_pretrained_backbone",
    "load_jax_variables",
]
