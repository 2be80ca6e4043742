"""Module wrappers of the rounding ops (counterpart of
``compression_tpu/layers/soft_round.py``): parameter-free ``nn.Module``s, so
a transform can be composed as a sequence of modules."""

from __future__ import annotations

import torch
from torch import nn

from compression_tpu_torch.ops import round_ops

__all__ = ["Round", "SoftRound", "SoftRoundConditionalMean"]


class Round(nn.Module):
    """Hard rounding with straight-through gradients."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return round_ops.round_st(x)


class SoftRound(nn.Module):
    """Invertible soft rounding (``inverse=True`` applies the inverse map)."""

    def __init__(self, alpha: float = 5.0, inverse: bool = False):
        super().__init__()
        self.alpha = alpha
        self.inverse = inverse

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.inverse:
            return round_ops.soft_round_inverse(x, self.alpha)
        return round_ops.soft_round(x, self.alpha)


class SoftRoundConditionalMean(nn.Module):
    """Decoder-side conditional-mean reconstruction for soft rounding."""

    def __init__(self, alpha: float = 5.0):
        super().__init__()
        self.alpha = alpha

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return round_ops.soft_round_conditional_mean(x, self.alpha)
