"""PyTorch/CUDA port of leaf_tpu: the LEAF frontend and its classifiers.

The JAX package ``leaf_tpu`` is the reference this package is held
against; nothing here imports it. Entry points (``Classifier``,
``get_frontend``, ``get_classifier``, ``ServingModel``) run on the CUDA
device unless the caller passes ``device="cpu"``; without a card they
raise instead of carrying on on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


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
