"""The port's device rows by what they compute (a frozen copy of
``leaf_tpu_torch.scripts._measure.CATEGORIES`` / ``categorize``), matched
in order by lower-case patterns of the kernel names the H100's trace
prints; the first category that matches wins. Added to the copy: cuDNN's
FFT convolution kernels (``DSE::*fft*``, ``pointwise_mult_and_sum_complex``),
which ResNet-18 runs at the AudioSet cfg's shape."""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

FRONTEND = "fused frontend kernels"
DEPTHWISE = "depthwise convolutions"
BATCHNORM = "BatchNorm"
CONV_GEMM = "cuDNN/cuBLAS convolutions and GEMMs"
OTHER = "other"

CATEGORIES = (
    (FRONTEND, ("fused_fwd", "fused_bwd")),
    ("NCCL", ("nccl",)),
    (DEPTHWISE, ("depthwise",)),
    (BATCHNORM, ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "bn_",
                 "welford")),
    ("optimizer (foreach Adam)", ("multi_tensor_apply", "adam", "foreach")),
    (CONV_GEMM,
     ("conv", "gemm", "xmma", "cudnn", "cutlass", "nvjet", "fprop", "dgrad",
      "wgrad", "sm90_", "sm80_", "ampere_", "hopper_", "fft",
      "pointwise_mult_and_sum_complex")),
    ("copies/casts", ("memcpy", "memset", "copy_kernel", "batchedcopy",
                      "transpose", "permute")),
    ("elementwise/reductions", ("elementwise", "reduce", "scan", "sort",
                                "index", "gather", "scatter", "softmax",
                                "pool", "pad", "fill", "where",
                                "distribution", "random")),
)

# the backbone's work: its convolutions (depthwise and cuDNN/cuBLAS) and
# its BatchNorms
BACKBONE = (DEPTHWISE, BATCHNORM, CONV_GEMM)


def category(name: str) -> str:
    low = name.lower()
    for cat, patterns in CATEGORIES:
        if any(p in low for p in patterns):
            return cat
    return OTHER


def categorize(rows: Iterable[Tuple[str, float]]) -> Dict[str, float]:
    """Sum of the values of ``rows`` ((name, value) pairs) per category:
    every category of CATEGORIES and OTHER, in that order."""
    out = {name: 0.0 for name, _ in CATEGORIES}
    out[OTHER] = 0.0
    for name, value in rows:
        out[category(name)] += value
    return out
