"""Round / soft-round distribution adapters (counterpart of
``compression_tpu/distributions/round_adapters.py``; Agustsson & Theis 2020).

``MonotonicAdapter`` is the distribution of ``Y = t(X)`` for a monotone
increasing ``t``: its CDF is ``c_X(t^{-1}(y))``. Wrapped in
:class:`UniformNoiseAdapter` (which needs only CDF-level quantities) the
adapters give the training densities of soft-rounded universal
quantization.
"""

from __future__ import annotations

import dataclasses

import torch

from compression_tpu_torch.distributions.base import Distribution
from compression_tpu_torch.distributions.deep_factorized import DeepFactorized
from compression_tpu_torch.distributions.scalar import Normal
from compression_tpu_torch.distributions.uniform_noise import UniformNoiseAdapter
from compression_tpu_torch.ops.round_ops import soft_round, soft_round_inverse

__all__ = [
    "MonotonicAdapter",
    "RoundAdapter",
    "SoftRoundAdapter",
    "NoisyRoundAdapter",
    "NoisySoftRoundAdapter",
    "NoisyRoundedNormal",
    "NoisyRoundedDeepFactorized",
    "NoisySoftRoundedNormal",
    "NoisySoftRoundedDeepFactorized",
]


@dataclasses.dataclass(frozen=True)
class MonotonicAdapter(Distribution):
    """Distribution of ``t(X)`` for a monotone increasing transform ``t``."""

    base: Distribution

    def transform(self, x):
        raise NotImplementedError

    def inverse_transform(self, y):
        raise NotImplementedError

    @property
    def batch_shape(self):
        return self.base.batch_shape

    def cdf(self, y):
        return self.base.cdf(self.inverse_transform(y))

    def log_cdf(self, y):
        return self.base.log_cdf(self.inverse_transform(y))

    def survival_function(self, y):
        return self.base.survival_function(self.inverse_transform(y))

    def log_survival_function(self, y):
        return self.base.log_survival_function(self.inverse_transform(y))

    def _log_cdf_and_survival(self, y):
        return self.base._log_cdf_and_survival(self.inverse_transform(y))

    def log_prob(self, y):
        raise NotImplementedError("Wrap in UniformNoiseAdapter for a proper density.")

    # Grid protocol: the base's grid, transformed.
    def _quantization_offset(self):
        off = self.base._quantization_offset()
        return None if off is None else self.transform(torch.as_tensor(off))

    def _lower_tail(self, tail_mass):
        t = self.base._lower_tail(tail_mass)
        return None if t is None else self.transform(torch.as_tensor(t))

    def _upper_tail(self, tail_mass):
        t = self.base._upper_tail(tail_mass)
        return None if t is None else self.transform(torch.as_tensor(t))


@dataclasses.dataclass(frozen=True)
class RoundAdapter(MonotonicAdapter):
    """Hard rounding, ``Y = round(X)``: the CDF is the exact staircase."""

    def transform(self, x):
        return torch.round(x)

    def inverse_transform(self, y):
        # P(round(X) <= y) = c_X(floor(y) + 1/2), exact for every real y.
        return torch.floor(y) + 0.5


@dataclasses.dataclass(frozen=True)
class SoftRoundAdapter(MonotonicAdapter):
    """Soft rounding, ``Y = soft_round(X, alpha)``: smooth and invertible."""

    alpha: torch.Tensor = 5.0

    def transform(self, x):
        return soft_round(x, self.alpha)

    def inverse_transform(self, y):
        return soft_round_inverse(y, self.alpha)


def NoisyRoundAdapter(base):
    return UniformNoiseAdapter(RoundAdapter(base))


def NoisySoftRoundAdapter(base, alpha=5.0):
    # A host number stays float64 (the JAX package's weakly typed scalar):
    # soft_round casts it to its input's dtype.
    if not isinstance(alpha, torch.Tensor):
        alpha = torch.tensor(alpha, dtype=torch.float64)
    return UniformNoiseAdapter(SoftRoundAdapter(base, alpha))


def NoisyRoundedNormal(loc, scale):
    return NoisyRoundAdapter(Normal(torch.as_tensor(loc), torch.as_tensor(scale)))


def NoisyRoundedDeepFactorized(**kwargs):
    return NoisyRoundAdapter(DeepFactorized.create(**kwargs))


def NoisySoftRoundedNormal(loc, scale, alpha=5.0):
    return NoisySoftRoundAdapter(
        Normal(torch.as_tensor(loc), torch.as_tensor(scale)), alpha=alpha)


def NoisySoftRoundedDeepFactorized(alpha=5.0, **kwargs):
    return NoisySoftRoundAdapter(DeepFactorized.create(**kwargs), alpha=alpha)
