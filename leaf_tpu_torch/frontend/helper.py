"""Config → frontend factory.

Parity: reference leaf_pytorch/frontend_helper.py:7-54 and the JAX
package's ``get_frontend``. Reads the same config keys
(``frontend.{name, default_args, use_legacy_complex, initializer,
n_filters, min_freq, max_freq, pcen_compress, mean_var_norm, preemp,
compute_dtype, use_fused_kernel}`` and ``audio_config.{sample_rate,
window_len, window_stride}``).
"""

from __future__ import annotations

from typing import Optional

import torch

from leaf_tpu_torch import resolve_device
from leaf_tpu_torch.frontend.frontend import Leaf

__all__ = ["get_frontend", "compute_dtype_of"]

_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype_of(section: dict) -> torch.dtype:
    """A cfg section's ``compute_dtype`` (default float32) as a torch
    dtype; the JAX package's two names only."""
    name = section.get("compute_dtype", "float32")
    if name not in _COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of "
                         f"{tuple(_COMPUTE_DTYPES)}, got {name!r}")
    return _COMPUTE_DTYPES[name]


def get_frontend(opt: dict, device=None,
                 generator: Optional[torch.Generator] = None) -> Leaf:
    """Build the cfg's frontend on ``device`` (CUDA unless one is named)."""
    front_end_config = opt["frontend"]
    audio_config = opt.get("audio_config", {})
    device = resolve_device(device)

    if "leaf" not in front_end_config["name"].lower():
        raise NotImplementedError("Other front ends not implemented yet.")
    common = dict(
        use_legacy_complex=front_end_config.get("use_legacy_complex", False),
        initializer=front_end_config.get("initializer", "default"),
        use_fused_kernel=front_end_config.get("use_fused_kernel", "auto"),
        compute_dtype=compute_dtype_of(front_end_config),
        device=device, generator=generator)
    if front_end_config.get("default_args", False):
        return Leaf(**common)
    return Leaf(
        n_filters=int(front_end_config.get("n_filters", 40.0)),
        sample_rate=int(audio_config.get("sample_rate", 16000)),
        window_len=float(audio_config.get("window_len", 25.0)),
        window_stride=float(audio_config.get("window_stride", 10.0)),
        preemp=bool(front_end_config.get("preemp", False)),
        init_min_freq=float(front_end_config.get("min_freq", 60.0)),
        init_max_freq=float(front_end_config.get("max_freq", 7800.0)),
        mean_var_norm=bool(front_end_config.get("mean_var_norm", False)),
        pcen_compression=bool(front_end_config.get("pcen_compress", True)),
        **common,
    )
