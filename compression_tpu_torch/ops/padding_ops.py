"""Padding for `same`-style convolutions (counterpart of
``compression_tpu/ops/padding_ops.py``).

A correlation kernel of length ``k`` is anchored at ``c = (k - 1) // 2``, a
convolution (flipped) kernel at ``c = k // 2``; the padding is
``(c, k - 1 - c)`` on the (possibly upsampled) grid.
"""

from __future__ import annotations

from typing import Sequence, Tuple

__all__ = ["same_padding_for_kernel"]


def same_padding_for_kernel(
    shape: Sequence[int], corr: bool
) -> Tuple[Tuple[int, int], ...]:
    """``(pad_lo, pad_hi)`` per spatial dim for a centered "same" conv."""
    padding = []
    for k in shape:
        if k < 1:
            raise ValueError(f"Kernel support must be >= 1, got {k}.")
        c = (k - 1) // 2 if corr else k // 2
        padding.append((c, k - 1 - c))
    return tuple(padding)
