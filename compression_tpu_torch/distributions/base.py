"""Minimal distribution protocol for entropy modeling (counterpart of
``compression_tpu/distributions/base.py``).

A distribution is a small immutable object holding tensors: a *batch* of
scalar distributions (``batch_shape``); density evaluation broadcasts its
input against the batch shape. Entropy models need:

  * ``log_prob`` / ``prob``, ``cdf`` / ``log_cdf``,
    ``survival_function`` / ``log_survival_function``;
  * the grid protocol ``_quantization_offset()``, ``_lower_tail(mass)``,
    ``_upper_tail(mass)`` (None requests the numerical fallback in
    :mod:`compression_tpu_torch.distributions.helpers`).

Type promotion follows the JAX package's (x64) rules where the table build
depends on it: a float32 parameter meets a float64 evaluation grid by being
computed in float32 first and then promoted.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

__all__ = ["Distribution", "map_tensors", "tensors"]


class Distribution:
    """Base class of the port's distributions."""

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        raise NotImplementedError

    def log_prob(self, x):
        raise NotImplementedError

    def prob(self, x):
        return torch.exp(self.log_prob(x))

    def cdf(self, x):
        raise NotImplementedError

    def log_cdf(self, x):
        return torch.log(self.cdf(x))

    def survival_function(self, x):
        return 1.0 - self.cdf(x)

    def log_survival_function(self, x):
        return torch.log1p(-self.cdf(x))

    def _log_cdf_and_survival(self, x):
        """``(log_cdf(x), log_survival_function(x))``; a distribution that
        computes both from one quantity (a logit) overrides this, so the
        uniform-noise density evaluates it once (XLA merges the two
        evaluations in the JAX package)."""
        return self.log_cdf(x), self.log_survival_function(x)

    def _quantization_offset(self):
        return None

    def _lower_tail(self, tail_mass: float):
        return None

    def _upper_tail(self, tail_mass: float):
        return None


def map_tensors(fn: Callable, obj):
    """``obj`` with ``fn`` applied to every tensor it holds, in dataclass
    fields and tuples at any depth (the JAX package's ``tree_map`` over a
    distribution pytree); other values are kept."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, tuple):
        return tuple(map_tensors(fn, v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: map_tensors(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    return obj


def tensors(obj) -> list:
    """The tensors ``obj`` holds, in field order (``tree_leaves``)."""
    out = []
    map_tensors(lambda t: out.append(t) or t, obj)
    return out
