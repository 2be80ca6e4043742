"""Bounded-gradient math, rounding and padding helpers."""

from compression_tpu_torch.ops.math_ops import (
    clip,
    lower_bound,
    perturb_and_apply,
    upper_bound,
)
from compression_tpu_torch.ops.padding_ops import same_padding_for_kernel
from compression_tpu_torch.ops.round_ops import (
    round_st,
    soft_round,
    soft_round_conditional_mean,
    soft_round_inverse,
)

__all__ = [
    "clip",
    "lower_bound",
    "upper_bound",
    "perturb_and_apply",
    "same_padding_for_kernel",
    "round_st",
    "soft_round",
    "soft_round_inverse",
    "soft_round_conditional_mean",
]
