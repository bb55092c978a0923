"""Hand-written CUDA kernels of the port, each beside its plain version.

Importing this package registers the kernels as ``torch.library`` ops
(``torch.ops.leaf_tpu_torch.*``), which a loaded ``torch.export``
artifact needs before it runs."""

from leaf_tpu_torch.ops.fused_frontend import (  # noqa: F401
    fused_gabor_sqmod_lowpass,
    lowpass_frames_out,
)

__all__ = ["fused_gabor_sqmod_lowpass", "lowpass_frames_out"]
