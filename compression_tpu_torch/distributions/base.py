"""Minimal distribution protocol for entropy modeling (counterpart of
``compression_tpu/distributions/base.py``).

A distribution is a small immutable object holding tensors: a *batch* of
scalar distributions (``batch_shape``); density evaluation broadcasts its
input against the batch shape. Entropy models need:

  * ``log_prob`` / ``prob``, ``log_cdf`` / ``log_survival_function``;
  * the grid protocol ``_quantization_offset()``, ``_lower_tail(mass)``,
    ``_upper_tail(mass)`` (None requests the numerical fallback in
    :mod:`compression_tpu_torch.distributions.helpers`).

Type promotion follows the JAX package's (x64) rules where the table build
depends on it: a float32 parameter meets a float64 evaluation grid by being
computed in float32 first and then promoted.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["Distribution"]


class Distribution:
    """Base class of the port's distributions."""

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        raise NotImplementedError

    def log_prob(self, x):
        raise NotImplementedError

    def prob(self, x):
        return torch.exp(self.log_prob(x))

    def log_cdf(self, x):
        raise NotImplementedError

    def log_survival_function(self, x):
        raise NotImplementedError

    def _quantization_offset(self):
        return None

    def _lower_tail(self, tail_mass: float):
        return None

    def _upper_tail(self, tail_mass: float):
        return None
