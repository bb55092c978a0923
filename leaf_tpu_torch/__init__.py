"""PyTorch/CUDA port of leaf_tpu: the LEAF frontend and its classifiers.

The JAX package ``leaf_tpu`` is the reference this package is held
against; nothing here imports it. Entry points (``Classifier``,
``get_frontend``, ``get_classifier``, ``ServingModel``) run on the CUDA
device unless the caller passes ``device="cpu"``; without a card they
raise instead of carrying on on the CPU. The top level exports what
``leaf_tpu``'s does (``Leaf``, ``get_frontend``, the serving models and
their exporters, ``__version__``) and ``resolve_device``. Importing the
package builds and loads no kernel: each builds at its first launch.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__version__ = "0.2.0"

__all__ = ["resolve_device", "Leaf", "get_frontend", "ServingModel",
           "StreamingServingModel", "save_exported", "save_exported_streaming",
           "__version__"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless one is named.

    Raises RuntimeError when CUDA is asked for (explicitly or by default)
    and no card is present — the port never silently runs on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "leaf_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU explicitly")
    return dev


# after resolve_device: the frontend and serving modules import it from here
from leaf_tpu_torch.frontend import Leaf, get_frontend  # noqa: E402
from leaf_tpu_torch.serving import (  # noqa: E402
    ServingModel,
    StreamingServingModel,
    save_exported,
    save_exported_streaming,
)
