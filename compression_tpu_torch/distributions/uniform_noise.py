"""Uniform-noise adapters (counterpart of
``compression_tpu/distributions/uniform_noise.py`` ``UniformNoiseAdapter``
and ``NoisyNormal``).

``UniformNoiseAdapter(base)`` is the distribution of ``Y = X + U`` with
``U ~ Uniform(-1/2, 1/2)``: ``p_Y(y) = c_X(y + 1/2) - c_X(y - 1/2)``,
evaluated in log space; left of the median the difference of CDFs is
accurate, right of it the difference of survival functions, chosen per
element.
"""

from __future__ import annotations

import dataclasses

import torch

from compression_tpu_torch.distributions.base import Distribution
from compression_tpu_torch.distributions.scalar import Normal

__all__ = ["UniformNoiseAdapter", "NoisyNormal"]


def _log_diff_exp(big, small):
    """log(exp(big) - exp(small)) for big >= small; the difference is
    floored (relative ~1e-12) so deep tails keep a tiny finite density."""
    diff = torch.clamp(small - big, max=-1e-12)
    return big + torch.log(-torch.expm1(diff))


@dataclasses.dataclass(frozen=True)
class UniformNoiseAdapter(Distribution):
    """Density of ``base + Uniform(-1/2, 1/2)``."""

    base: Distribution

    @property
    def batch_shape(self):
        return self.base.batch_shape

    def log_prob(self, y):
        logcdf_p = self.base.log_cdf(y + 0.5)
        logcdf_m = self.base.log_cdf(y - 0.5)
        logsf_p = self.base.log_survival_function(y + 0.5)
        logsf_m = self.base.log_survival_function(y - 0.5)
        use_cdf = logcdf_p + logcdf_m < logsf_p + logsf_m
        left = _log_diff_exp(logcdf_p, logcdf_m)
        right = _log_diff_exp(logsf_m, logsf_p)
        return torch.where(use_cdf, left, right)

    def log_cdf(self, y):
        return self.base.log_cdf(y)

    def log_survival_function(self, y):
        return self.base.log_survival_function(y)

    # Grid protocol: the tables are built from the base prior's tails.
    def _grid_points(self, tail_mass):
        fn = getattr(self.base, "_grid_points", None)
        return fn(tail_mass) if fn is not None else None

    def _quantization_offset(self):
        return self.base._quantization_offset()

    def _lower_tail(self, tail_mass):
        return self.base._lower_tail(tail_mass)

    def _upper_tail(self, tail_mass):
        return self.base._upper_tail(tail_mass)


def NoisyNormal(loc, scale):
    """Gaussian + U(-1/2, 1/2)."""
    return UniformNoiseAdapter(Normal(torch.as_tensor(loc), torch.as_tensor(scale)))
