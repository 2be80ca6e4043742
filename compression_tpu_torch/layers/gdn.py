"""GDN: generalized divisive normalization (counterpart of
``compression_tpu/layers/gdn.py``).

For an input with channels ``i`` (the trailing axis)::

    norm_i = beta_i + sum_j gamma_{ji} * |x_j|^alpha
    y_i    = x_i * norm_i^(-epsilon)          (forward)
    y_i    = x_i * norm_i^(+epsilon)          (inverse / IGDN)

The classic ``alpha=2, epsilon=0.5`` form always goes through the fused
kernel K1, with or without gradients
(:func:`compression_tpu_torch.layers.gdn_kernel.gdn_autograd`: the CUDA
kernel on the card, its plain twin on the CPU, and a backward in plain
torch ops); other exponents take plain torch ops. ``beta``/``gamma`` are stored raw, in sqrt space, and
reparameterized by ``nonneg_apply`` at call time.
"""

from __future__ import annotations

import torch
from torch import nn

from compression_tpu_torch.layers import parameters
from compression_tpu_torch.layers.gdn_kernel import gdn_autograd

__all__ = ["GDN"]


class GDN(nn.Module):
    """Generalized divisive normalization over the trailing channel axis.

    Args:
      channels: size of the channel axis.
      inverse: if True, multiply by the norm pool (IGDN, synthesis side).
      rectify: if True, apply ReLU to the input first.
      alpha: exponent on the pooled activations (2 = squared pooling).
      epsilon: exponent on the norm pool (0.5 = square root).
      beta_min: lower bound for beta.
      gamma_init: gamma is initialized to ``gamma_init * I``.
    """

    def __init__(self, channels: int, *, inverse: bool = False,
                 rectify: bool = False, alpha: float = 2.0,
                 epsilon: float = 0.5, beta_min: float = 1e-6,
                 gamma_init: float = 0.1):
        super().__init__()
        self.inverse = inverse
        self.rectify = rectify
        self.alpha = alpha
        self.epsilon = epsilon
        self.beta_min = beta_min
        self.beta = nn.Parameter(
            parameters.nonneg_init(torch.ones(channels))
        )
        self.gamma = nn.Parameter(
            parameters.nonneg_init(gamma_init * torch.eye(channels))
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        beta = parameters.nonneg_apply(self.beta, self.beta_min)
        gamma = parameters.nonneg_apply(self.gamma, 0.0)
        if self.rectify:
            x = torch.relu(x)
        if self.alpha == 2.0 and self.epsilon == 0.5:
            return gdn_autograd(x, beta, gamma, self.inverse)
        if self.alpha == 1.0:
            pooled = torch.abs(x)
        else:
            pooled = torch.abs(x) ** self.alpha
        norm = torch.matmul(pooled, gamma) + beta
        if self.epsilon == 0.5:
            scale = torch.sqrt(norm) if self.inverse else torch.rsqrt(norm)
        else:
            scale = norm ** (self.epsilon if self.inverse else -self.epsilon)
        return x * scale
