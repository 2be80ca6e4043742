"""Holder of the factorized prior's parameters (counterpart of
``compression_tpu/layers/priors.py`` ``DeepFactorizedPrior``).

The module owns the raw ``matrices`` / ``biases`` / ``factors`` lists and
materializes the distribution object on each call.
"""

from __future__ import annotations

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
        prior = DeepFactorized.create(generator, batch_shape, num_filters,
                                      init_scale)
        self.matrices = nn.ParameterList(prior.matrices)
        self.biases = nn.ParameterList(prior.biases)
        self.factors = nn.ParameterList(prior.factors)

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
