"""Distributions for entropy modeling: Normal, Logistic, mixtures,
DeepFactorized, the uniform-noise and round adapters, and the grid helpers."""

from compression_tpu_torch.distributions.base import Distribution
from compression_tpu_torch.distributions.deep_factorized import DeepFactorized
from compression_tpu_torch.distributions.helpers import (
    estimate_tails,
    lower_tail,
    quantization_offset,
    upper_tail,
)
from compression_tpu_torch.distributions.round_adapters import (
    MonotonicAdapter,
    NoisyRoundAdapter,
    NoisyRoundedDeepFactorized,
    NoisyRoundedNormal,
    NoisySoftRoundAdapter,
    NoisySoftRoundedDeepFactorized,
    NoisySoftRoundedNormal,
    RoundAdapter,
    SoftRoundAdapter,
)
from compression_tpu_torch.distributions.scalar import (
    Logistic,
    MixtureSameFamily,
    Normal,
)
from compression_tpu_torch.distributions.uniform_noise import (
    NoisyDeepFactorized,
    NoisyLogistic,
    NoisyLogisticMixture,
    NoisyMixtureSameFamily,
    NoisyNormal,
    NoisyNormalMixture,
    UniformNoiseAdapter,
)

__all__ = [
    "Distribution",
    "DeepFactorized",
    "Normal",
    "Logistic",
    "MixtureSameFamily",
    "UniformNoiseAdapter",
    "NoisyNormal",
    "NoisyLogistic",
    "NoisyDeepFactorized",
    "NoisyNormalMixture",
    "NoisyLogisticMixture",
    "NoisyMixtureSameFamily",
    "MonotonicAdapter",
    "RoundAdapter",
    "SoftRoundAdapter",
    "NoisyRoundAdapter",
    "NoisySoftRoundAdapter",
    "NoisyRoundedNormal",
    "NoisyRoundedDeepFactorized",
    "NoisySoftRoundedNormal",
    "NoisySoftRoundedDeepFactorized",
    "estimate_tails",
    "quantization_offset",
    "lower_tail",
    "upper_tail",
]
