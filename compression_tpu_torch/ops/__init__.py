"""Bounded-gradient math and padding helpers."""

from compression_tpu_torch.ops.math_ops import lower_bound, upper_bound
from compression_tpu_torch.ops.padding_ops import same_padding_for_kernel

__all__ = ["lower_bound", "upper_bound", "same_padding_for_kernel"]
