"""Nonnegative (sqrt-space) reparameterization of the GDN parameters
(counterpart of ``compression_tpu/layers/parameters.py`` ``nonneg_init`` /
``nonneg_apply``; the RDFT kernels are not ported yet).

The parameter is stored as ``sqrt(value + pedestal)`` and read back as
``lower_bound(stored, sqrt(minimum + pedestal))**2 - pedestal``.
"""

from __future__ import annotations

import torch

from compression_tpu_torch.ops.math_ops import lower_bound

__all__ = ["NONNEG_PEDESTAL", "nonneg_init", "nonneg_apply"]

# Pedestal keeping sqrt() differentiable at an effective value of zero.
_REPARAM_OFFSET = 2.0 ** -18
NONNEG_PEDESTAL = _REPARAM_OFFSET ** 2


def nonneg_init(value: torch.Tensor) -> torch.Tensor:
    """Maps an effective (>= 0) initial value into sqrt storage space."""
    return torch.sqrt(torch.clamp(value + NONNEG_PEDESTAL, min=NONNEG_PEDESTAL))


def nonneg_apply(stored: torch.Tensor, minimum: float = 0.0) -> torch.Tensor:
    """Reads back the effective value; differentiably enforces >= minimum."""
    bound = (minimum + NONNEG_PEDESTAL) ** 0.5
    stored = lower_bound(stored, bound, gradient="identity_if_towards")
    return torch.square(stored) - NONNEG_PEDESTAL
