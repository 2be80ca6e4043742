"""Distributions for entropy modeling (the main path's subset)."""

from compression_tpu_torch.distributions.base import Distribution
from compression_tpu_torch.distributions.deep_factorized import DeepFactorized
from compression_tpu_torch.distributions.helpers import (
    estimate_tails,
    lower_tail,
    quantization_offset,
    upper_tail,
)
from compression_tpu_torch.distributions.scalar import Normal
from compression_tpu_torch.distributions.uniform_noise import (
    NoisyNormal,
    UniformNoiseAdapter,
)

__all__ = [
    "Distribution",
    "DeepFactorized",
    "Normal",
    "NoisyNormal",
    "UniformNoiseAdapter",
    "estimate_tails",
    "quantization_offset",
    "lower_tail",
    "upper_tail",
]
