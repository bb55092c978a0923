"""The LEAF frontend, in PyTorch."""

from leaf_tpu_torch.frontend.frontend import (  # noqa: F401
    Leaf,
    Preemphasis,
    SquaredModulus,
)
from leaf_tpu_torch.frontend.helper import get_frontend  # noqa: F401
from leaf_tpu_torch.frontend.streaming import (  # noqa: F401
    LeafStreamer,
    StreamingLeafCell,
    streaming_geometry,
)
