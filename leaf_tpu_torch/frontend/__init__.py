"""The LEAF frontend, in PyTorch: the names of ``leaf_tpu.frontend``,
and ``Preemphasis``."""

from leaf_tpu_torch.frontend.convolution import (
    GaborConstraint,
    GaborConv1d,
    gabor_constraint,
)
from leaf_tpu_torch.frontend.filters import GaborParams
from leaf_tpu_torch.frontend.frontend import Leaf, Preemphasis, SquaredModulus
from leaf_tpu_torch.frontend.helper import get_frontend
from leaf_tpu_torch.frontend.impulse_responses import (
    gabor_filters,
    gabor_impulse_response,
    gaussian_lowpass,
)
from leaf_tpu_torch.frontend.initializers import GaborInit, make_initializer
from leaf_tpu_torch.frontend.melbanks import melscale_fbanks
from leaf_tpu_torch.frontend.pooling import GaussianLowPass
from leaf_tpu_torch.frontend.postprocessing import (
    ExponentialMovingAverage,
    PCENLayer,
    ema_scan,
)
from leaf_tpu_torch.frontend.streaming import (
    LeafStreamer,
    StreamingLeafCell,
    streaming_geometry,
)

__all__ = [
    "GaborConstraint",
    "GaborConv1d",
    "gabor_constraint",
    "GaborParams",
    "Leaf",
    "Preemphasis",
    "SquaredModulus",
    "get_frontend",
    "gabor_filters",
    "gabor_impulse_response",
    "gaussian_lowpass",
    "GaborInit",
    "make_initializer",
    "melscale_fbanks",
    "GaussianLowPass",
    "ExponentialMovingAverage",
    "PCENLayer",
    "ema_scan",
    "LeafStreamer",
    "StreamingLeafCell",
    "streaming_geometry",
]
