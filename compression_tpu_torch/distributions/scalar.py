"""The Normal distribution (counterpart of
``compression_tpu/distributions/scalar.py`` ``Normal``; Logistic and the
mixtures are not ported yet): the log-CDFs and quantiles the table build
needs, from ``torch.special`` (``log_ndtr``, ``ndtri``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from compression_tpu_torch.distributions.base import Distribution

__all__ = ["Normal"]


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

    def log_cdf(self, x):
        return torch.special.log_ndtr(self._z(x))

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
