"""Holder of the factorized prior's parameters (counterpart of
``compression_tpu/layers/priors.py`` ``DeepFactorizedPrior``).

The module owns the raw ``matrices`` / ``biases`` / ``factors`` lists and
materializes the distribution object on each call.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from compression_tpu_torch.distributions.deep_factorized import DeepFactorized
from compression_tpu_torch.distributions.uniform_noise import UniformNoiseAdapter

__all__ = ["DeepFactorizedPrior"]


class DeepFactorizedPrior(nn.Module):
    """Trainable DeepFactorized parameters, one density per channel.

    ``forward(noisy=True)`` returns the uniform-noise-convolved
    distribution an entropy model codes with; ``noisy=False`` the density.
    The biases are drawn U(-1/2, 1/2) from ``generator`` (a fresh one
    seeded 0 if none is given), the rest is constant, as in
    ``DeepFactorized.create``.
    """

    def __init__(self, batch_shape: Tuple[int, ...],
                 num_filters: Sequence[int] = (3, 3, 3),
                 init_scale: float = 10.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        batch_shape = tuple(batch_shape)
        filters = (1,) + tuple(num_filters) + (1,)
        scale = init_scale ** (1.0 / (len(num_filters) + 1))
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.matrices = nn.ParameterList()
        self.biases = nn.ParameterList()
        self.factors = nn.ParameterList()
        for i in range(len(num_filters) + 1):
            init = math.log(math.expm1(1.0 / scale / filters[i + 1]))
            shape = batch_shape + (filters[i + 1], filters[i])
            self.matrices.append(
                nn.Parameter(torch.full(shape, init))
            )
            self.biases.append(nn.Parameter(
                torch.rand(batch_shape + (filters[i + 1], 1),
                           generator=generator) - 0.5
            ))
            if i < len(num_filters):
                self.factors.append(nn.Parameter(
                    torch.zeros(batch_shape + (filters[i + 1], 1))
                ))

    def forward(self, noisy: bool = True, device=None, index=None):
        """The distribution; with ``device``, over detached copies of the
        parameters there (the host table build passes ``"cpu"``); with
        ``index``, of the batch entries ``param[index]`` only (b2018 takes
        one quality's row of its (quality, channel) prior, or one row per
        example)."""
        fields = (self.matrices, self.biases, self.factors)
        if device is not None:
            fields = [[p.detach().to(device) for p in f] for f in fields]
        if index is not None:
            fields = [[p[index] for p in f] for f in fields]
        prior = DeepFactorized(*(tuple(f) for f in fields))
        return UniformNoiseAdapter(prior) if noisy else prior
