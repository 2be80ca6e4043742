"""DeepFactorized: the Ballé et al. (2018) non-parametric univariate density
(counterpart of ``compression_tpu/distributions/deep_factorized.py``).

The CDF of each (per-channel) scalar is ``sigmoid(f_K o ... o f_1 (x))``
with ``f_k(u) = g_k(softplus(H_k) u + b_k)`` and, on the inner layers,
``g_k(u) = u + tanh(a_k) * tanh(u)``. ``log_prob`` uses the closed-form
derivative of the logits, carried through the layers alongside them (the
JAX package gets the same number from one ``jax.jvp``).

Dtypes follow the JAX package under x64: ``softplus(H)`` and ``tanh(a)``
are taken in the parameters' dtype (float32) and then promoted to the
evaluation dtype, so a float64 grid sees the same promoted parameters.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from compression_tpu_torch.distributions import helpers
from compression_tpu_torch.distributions.base import Distribution

__all__ = ["DeepFactorized"]


@dataclasses.dataclass(frozen=True)
class DeepFactorized(Distribution):
    """Batch of independent scalar densities with learned CDFs.

    Fields (raw, unconstrained parameters):
      matrices: ``batch_shape + (d_out, d_in)`` each; weight ``softplus(H)``.
      biases: ``batch_shape + (d_out, 1)``.
      factors: one fewer than matrices, ``batch_shape + (d_out, 1)``;
        gate ``tanh(a)``.
    """

    matrices: Tuple[torch.Tensor, ...]
    biases: Tuple[torch.Tensor, ...]
    factors: Tuple[torch.Tensor, ...]

    @classmethod
    def create(cls, generator: Optional[torch.Generator] = None,
               batch_shape: Tuple[int, ...] = (),
               num_filters: Sequence[int] = (3, 3, 3),
               init_scale: float = 10.0, dtype=torch.float32,
               device=None) -> "DeepFactorized":
        """Fresh parameters at the JAX package's init: constant matrices
        ``log(expm1(1 / scale / d_out))`` with ``scale =
        init_scale ** (1 / layers)``, zero factors, and biases U(-1/2, 1/2)
        drawn layer by layer from ``generator`` (a fresh one seeded 0 if
        none is given)."""
        batch_shape = tuple(batch_shape)
        filters = (1,) + tuple(num_filters) + (1,)
        scale = init_scale ** (1.0 / (len(num_filters) + 1))
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        matrices, biases, factors = [], [], []
        for i in range(len(num_filters) + 1):
            init = math.log(math.expm1(1.0 / scale / filters[i + 1]))
            matrices.append(torch.full(
                batch_shape + (filters[i + 1], filters[i]), init, dtype=dtype))
            biases.append(torch.rand(
                batch_shape + (filters[i + 1], 1), generator=generator,
                dtype=dtype) - 0.5)
            if i < len(num_filters):
                factors.append(torch.zeros(batch_shape + (filters[i + 1], 1),
                                           dtype=dtype))
        return cls(*(tuple(t.to(device) for t in f)
                     for f in (matrices, biases, factors)))

    @property
    def batch_shape(self):
        return tuple(self.matrices[0].shape[:-2])

    @property
    def dtype(self):
        return self.matrices[0].dtype

    @property
    def device(self):
        return self.matrices[0].device

    def _layers(self, dtype):
        """Effective (weight, bias, gate) per layer, promoted to ``dtype``."""
        for i, matrix in enumerate(self.matrices):
            gate = (
                torch.tanh(self.factors[i]).to(dtype)
                if i < len(self.factors) else None
            )
            yield F.softplus(matrix).to(dtype), self.biases[i].to(dtype), gate

    def _logits_cumulative(self, x):
        """Logit of the CDF, broadcast against the batch dims."""
        x = torch.as_tensor(x)
        dtype = torch.promote_types(x.dtype, self.dtype)
        u = x.to(dtype)[..., None, None]
        for weight, bias, gate in self._layers(dtype):
            u = torch.matmul(weight, u) + bias
            if gate is not None:
                u = u + gate * torch.tanh(u)
        return u[..., 0, 0]

    def _logits_and_derivative(self, x):
        dtype = torch.promote_types(x.dtype, self.dtype)
        u = x.to(dtype)[..., None, None]
        du = torch.ones_like(u)
        for weight, bias, gate in self._layers(dtype):
            u = torch.matmul(weight, u) + bias
            du = torch.matmul(weight, du)
            if gate is not None:
                t = torch.tanh(u)
                u = u + gate * t
                du = du * (1.0 + gate * (1.0 - t * t))
        return u[..., 0, 0], du[..., 0, 0]

    def cdf(self, x):
        return torch.sigmoid(self._logits_cumulative(x))

    def log_cdf(self, x):
        return F.logsigmoid(self._logits_cumulative(x))

    def survival_function(self, x):
        return torch.sigmoid(-self._logits_cumulative(x))

    def log_survival_function(self, x):
        return F.logsigmoid(-self._logits_cumulative(x))

    def _log_cdf_and_survival(self, x):
        logits = self._logits_cumulative(x)
        return F.logsigmoid(logits), F.logsigmoid(-logits)

    def log_prob(self, x):
        x = torch.as_tensor(x)
        x = torch.broadcast_to(
            x, np.broadcast_shapes(tuple(x.shape), tuple(self.batch_shape))
        )
        logits, dlogits = self._logits_and_derivative(x)
        tiny = torch.finfo(dlogits.dtype).tiny
        # p = sigmoid(l) * sigmoid(-l) * l'
        return (
            F.logsigmoid(logits) + F.logsigmoid(-logits)
            + torch.log(torch.clamp(dlogits, min=tiny))
        )

    # Grid protocol -------------------------------------------------------
    @staticmethod
    def _tail_logit(tail_mass: float) -> float:
        return math.log(tail_mass / 2.0) - math.log1p(-tail_mass / 2.0)

    def _grid_points(self, tail_mass):
        """(offset, lower, upper) in one batched root-find: all three are
        level sets of the monotone logits (0 and -/+ logit(tail_mass/2))."""
        t = self._tail_logit(tail_mass)
        targets = torch.tensor([0.0, t, -t], dtype=self.dtype, device=self.device)
        x = helpers.estimate_tails(
            self._logits_cumulative,
            targets.reshape((3,) + (1,) * len(self.batch_shape)),
            (3,) + self.batch_shape,
            self.dtype, self.device,
        )
        return x[0], x[1], x[2]

    def _quantization_offset(self):
        return helpers.estimate_tails(
            self._logits_cumulative, 0.0, self.batch_shape, self.dtype,
            self.device,
        )

    def _lower_tail(self, tail_mass):
        return helpers.estimate_tails(
            self._logits_cumulative, self._tail_logit(tail_mass),
            self.batch_shape, self.dtype, self.device,
        )

    def _upper_tail(self, tail_mass):
        return helpers.estimate_tails(
            self._logits_cumulative, -self._tail_logit(tail_mass),
            self.batch_shape, self.dtype, self.device,
        )
