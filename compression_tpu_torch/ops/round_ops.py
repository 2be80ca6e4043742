"""Rounding ops: straight-through round and the soft-round family
(counterpart of ``compression_tpu/ops/round_ops.py``).

``soft_round`` is an invertible, differentiable relaxation of rounding::

    m = floor(x) + 1/2;  r = x - m
    soft_round(x, alpha) = m + tanh(alpha * r) / (2 * tanh(alpha / 2))

As ``alpha -> 0`` it approaches the identity; as ``alpha -> inf`` it sharpens
to hard rounding. Each interval [n - 1/2, n + 1/2] maps onto itself, so the
inverse is well defined.
"""

from __future__ import annotations

import torch

from compression_tpu_torch.ops.math_ops import clip

__all__ = [
    "round_st",
    "soft_round",
    "soft_round_inverse",
    "soft_round_conditional_mean",
]

# Below this, tanh(alpha*r)/(2*tanh(alpha/2)) is numerically ~ r: use identity.
_ALPHA_EPS = 1e-3

# tanh saturates to +-1 well before |x| = 30; clamp first, as the JAX package
# does (its float64 CPU tanh returns NaN for huge arguments).
_TANH_SAT = 30.0


def _tanh(x):
    return torch.tanh(clip(x, -_TANH_SAT, _TANH_SAT))


def _alpha_like(alpha, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(alpha, dtype=x.dtype, device=x.device)


def round_st(inputs: torch.Tensor, offset=None) -> torch.Tensor:
    """Straight-through rounding: forward = round, gradient = identity.

    With ``offset``, rounds ``inputs - offset`` and adds the offset back
    (quantization grid centered at ``offset`` mod 1).
    """
    if offset is not None:
        shifted = inputs - offset
        return inputs + (torch.round(shifted) + offset - inputs).detach()
    return inputs + (torch.round(inputs) - inputs).detach()


def soft_round(x: torch.Tensor, alpha) -> torch.Tensor:
    """Differentiable approximation to round (see module docstring)."""
    alpha = _alpha_like(alpha, x)
    alpha_bounded = torch.clamp(alpha, min=_ALPHA_EPS)
    m = torch.floor(x) + 0.5
    r = x - m
    z = _tanh(alpha_bounded / 2.0) * 2.0
    y = m + _tanh(alpha_bounded * r) / z
    # For very small alpha fall back to identity (the limit): avoids 0/0.
    return torch.where(alpha < _ALPHA_EPS, x, y)


def soft_round_inverse(y: torch.Tensor, alpha) -> torch.Tensor:
    """Inverse of ``soft_round`` (maps each unit interval back onto itself)."""
    alpha = _alpha_like(alpha, y)
    alpha_bounded = torch.clamp(alpha, min=_ALPHA_EPS)
    m = torch.floor(y) + 0.5
    s = (y - m) * (_tanh(alpha_bounded / 2.0) * 2.0)
    # s lies in (-1, 1) by construction, but rounding can reach |s| = 1,
    # where atanh diverges.
    s = clip(s, -1.0 + 1e-7, 1.0 - 1e-7)
    r = torch.atanh(s) / alpha_bounded
    # Exact integers (y == m -+ 1/2) are fixed points; clip r to the interval.
    r = clip(r, -0.5, 0.5)
    return torch.where(alpha < _ALPHA_EPS, y, m + r)


def soft_round_conditional_mean(y: torch.Tensor, alpha) -> torch.Tensor:
    """Conditional mean reconstruction E[X | soft_round(X + U) = y]
    (Agustsson & Theis 2020, eq. 13): the inverse shifted by half a bin."""
    return soft_round_inverse(y - 0.5, alpha) + 0.5
