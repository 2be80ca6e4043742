"""Analytic scalar distributions: Normal, Logistic and mixtures (counterpart
of ``compression_tpu/distributions/scalar.py``): stable log-CDFs and
analytic tails, the Normal's from ``torch.special`` (``log_ndtr``,
``ndtri``)."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from compression_tpu_torch.distributions.base import Distribution

__all__ = ["Normal", "Logistic", "MixtureSameFamily"]


@dataclasses.dataclass(frozen=True)
class Normal(Distribution):
    """Gaussian with location ``loc`` and scale ``scale`` (broadcastable)."""

    loc: torch.Tensor
    scale: torch.Tensor

    @property
    def batch_shape(self):
        # NumPy's broadcast: torch.broadcast_shapes imports sympy on first
        # use, seconds of a fresh process's table build.
        return np.broadcast_shapes(tuple(self.loc.shape), tuple(self.scale.shape))

    def _z(self, x):
        return (x - self.loc) / self.scale

    def log_prob(self, x):
        z = self._z(x)
        return (-0.5 * z * z - torch.log(self.scale)
                - 0.5 * math.log(2 * math.pi))

    def cdf(self, x):
        return torch.special.ndtr(self._z(x))

    def log_cdf(self, x):
        return torch.special.log_ndtr(self._z(x))

    def survival_function(self, x):
        return torch.special.ndtr(-self._z(x))

    def log_survival_function(self, x):
        return torch.special.log_ndtr(-self._z(x))

    def quantile(self, p: float):
        """Quantile at a host probability ``p``, in float64 (the JAX
        package's ``ndtri`` of a host scalar is float64 under x64, and
        promotes float32 parameters)."""
        return self.loc.double() + self.scale.double() * _ndtri64(p)

    def _quantization_offset(self):
        return self.loc

    def _lower_tail(self, tail_mass: float):
        return self.quantile(tail_mass / 2.0)

    def _upper_tail(self, tail_mass: float):
        return self.loc.double() - self.scale.double() * _ndtri64(tail_mass / 2.0)


def _ndtri64(p: float) -> float:
    return torch.special.ndtri(torch.tensor(p, dtype=torch.float64)).item()


def _logit(p: float) -> float:
    return math.log(p) - math.log1p(-p)


@dataclasses.dataclass(frozen=True)
class Logistic(Distribution):
    """Logistic distribution with location ``loc`` and scale ``scale``."""

    loc: torch.Tensor
    scale: torch.Tensor

    @property
    def batch_shape(self):
        return np.broadcast_shapes(tuple(self.loc.shape), tuple(self.scale.shape))

    def _z(self, x):
        return (x - self.loc) / self.scale

    def log_prob(self, x):
        z = self._z(x)
        # softplus as jax.nn.softplus, logaddexp(-z, 0), with no threshold.
        softplus = torch.logaddexp(-z, torch.zeros_like(z))
        return -z - 2.0 * softplus - torch.log(self.scale)

    def cdf(self, x):
        return torch.sigmoid(self._z(x))

    def log_cdf(self, x):
        return F.logsigmoid(self._z(x))

    def survival_function(self, x):
        return torch.sigmoid(-self._z(x))

    def log_survival_function(self, x):
        return F.logsigmoid(-self._z(x))

    def quantile(self, p: float):
        """Quantile at a host probability ``p``, in the parameters' dtype
        (the JAX package's host scalar is weakly typed there)."""
        return self.loc + self.scale * _logit(p)

    def _quantization_offset(self):
        return self.loc

    def _lower_tail(self, tail_mass: float):
        return self.quantile(tail_mass / 2.0)

    def _upper_tail(self, tail_mass: float):
        return self.loc - self.scale * _logit(tail_mass / 2.0)


@dataclasses.dataclass(frozen=True)
class MixtureSameFamily(Distribution):
    """Mixture of a batch of same-family components: ``components`` has
    batch shape ``batch_shape + (k,)``, ``logits`` broadcasts against it.
    CDF-level quantities are exact mixtures, so the uniform-noise adapter
    over a mixture stays exact."""

    logits: torch.Tensor
    components: Distribution

    @property
    def batch_shape(self):
        return tuple(self.components.batch_shape[:-1])

    @property
    def _log_weights(self):
        return torch.log_softmax(self.logits, dim=-1)

    def _mix(self, per_component_log):
        return torch.logsumexp(self._log_weights + per_component_log, dim=-1)

    def log_prob(self, x):
        return self._mix(self.components.log_prob(torch.as_tensor(x)[..., None]))

    def cdf(self, x):
        return torch.exp(self.log_cdf(x))

    def log_cdf(self, x):
        return self._mix(self.components.log_cdf(torch.as_tensor(x)[..., None]))

    def survival_function(self, x):
        return torch.exp(self.log_survival_function(x))

    def log_survival_function(self, x):
        return self._mix(
            self.components.log_survival_function(torch.as_tensor(x)[..., None]))

    def _quantization_offset(self):
        # The mode has no closed form: the weight-averaged component offset.
        off = self.components._quantization_offset()
        if off is None:
            return None
        return torch.sum(torch.exp(self._log_weights) * off, dim=-1)

    def _lower_tail(self, tail_mass: float):
        # The least component tail covers the mixture.
        t = self.components._lower_tail(tail_mass)
        return None if t is None else torch.amin(torch.as_tensor(t), dim=-1)

    def _upper_tail(self, tail_mass: float):
        t = self.components._upper_tail(tail_mass)
        return None if t is None else torch.amax(torch.as_tensor(t), dim=-1)
