"""Small shared utilities for the frontend."""

from __future__ import annotations

__all__ = ["tf_same_padding_1d"]


def tf_same_padding_1d(kernel_size: int) -> tuple[int, int]:
    """(left, right) TF-style SAME padding for a stride-1 conv.

    For odd kernels this is symmetric ``(k//2, k//2)`` (e.g. (200, 200) for
    k=401); for even kernels the left side gets one less. Parity: reference
    leaf_pytorch/utils.py:5-10.
    """
    half = kernel_size // 2
    return (half + (kernel_size - 2 * half) - 1, half)
