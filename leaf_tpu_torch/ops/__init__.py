"""Hand-written CUDA kernels of the port, each beside its plain version."""

from leaf_tpu_torch.ops.fused_frontend import (  # noqa: F401
    fused_gabor_sqmod_lowpass,
    lowpass_frames_out,
)
