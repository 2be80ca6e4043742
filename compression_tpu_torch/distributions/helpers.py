"""Grid placement: quantization offsets and tail quantiles (counterpart of
``compression_tpu/distributions/helpers.py``).

``estimate_tails`` is the same expanding-bracket bisection as the JAX
package's, run in the same dtype (the parameters', float32 for the
checkpoints), so both packages place the CDF tables' grids alike. A
distribution without analytic tails gets them from ``estimate_tails`` on
its ``log_cdf`` / ``log_survival_function``, in the dtype of its first
floating-point tensor, on that tensor's device.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from compression_tpu_torch.distributions.base import tensors

__all__ = ["estimate_tails", "quantization_offset", "lower_tail", "upper_tail"]


def estimate_tails(func: Callable, target, shape, dtype=torch.float32,
                   device=None):
    """Solves ``func(x) == target`` elementwise for monotone ``func``
    (increasing or decreasing, detected per element), on ``device`` (the
    CPU by default)."""
    shape = tuple(shape)
    target = torch.broadcast_to(
        torch.as_tensor(target, dtype=dtype, device=device), shape)
    probe = torch.zeros(shape, dtype=dtype, device=device)
    increasing = func(probe + 1.0) >= func(probe - 1.0)

    def enclosed(f_lo, f_hi):
        lo_ok = torch.where(increasing, f_lo <= target, f_lo >= target)
        hi_ok = torch.where(increasing, f_hi >= target, f_hi <= target)
        return lo_ok & hi_ok

    # Expanding bracket, at most 64 doublings.
    lo = torch.full(shape, -1.0, dtype=dtype, device=device)
    hi = torch.full(shape, 1.0, dtype=dtype, device=device)
    f_lo, f_hi = func(lo), func(hi)
    for _ in range(64):
        ok = enclosed(f_lo, f_hi)
        if bool(ok.all()):
            break
        width = torch.clamp(hi - lo, min=1.0)
        lo = torch.where(ok, lo, lo - width)
        hi = torch.where(ok, hi, hi + width)
        f_lo, f_hi = func(lo), func(hi)

    # Bisection: 60 halvings.
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        f_mid = func(mid)
        go_right = torch.where(increasing, f_mid < target, f_mid > target)
        lo = torch.where(go_right, mid, lo)
        hi = torch.where(go_right, hi, mid)
    return 0.5 * (lo + hi)


def quantization_offset(distribution):
    """Offset (mod 1, in [-1/2, 1/2]) centering the grid on the mode."""
    offset = distribution._quantization_offset()
    if offset is None:
        return torch.zeros(distribution.batch_shape)
    return offset - torch.round(offset)


def lower_tail(distribution, tail_mass: float):
    """Quantile at ``tail_mass / 2``: analytic where the distribution has
    it, else the root of ``log_cdf(x) = log(tail_mass / 2)``."""
    t = distribution._lower_tail(tail_mass)
    if t is not None:
        return torch.as_tensor(t)
    return estimate_tails(
        distribution.log_cdf, math.log(tail_mass / 2.0),
        distribution.batch_shape, *_tail_dtype_device(distribution))


def upper_tail(distribution, tail_mass: float):
    """Quantile at ``1 - tail_mass / 2``: analytic, else the root of
    ``log_survival_function(x) = log(tail_mass / 2)``."""
    t = distribution._upper_tail(tail_mass)
    if t is not None:
        return torch.as_tensor(t)
    return estimate_tails(
        distribution.log_survival_function, math.log(tail_mass / 2.0),
        distribution.batch_shape, *_tail_dtype_device(distribution))


def _tail_dtype(distribution) -> torch.dtype:
    """The dtype of the distribution's first floating-point tensor (float32
    if it holds none): the root-find's dtype, as in the JAX package."""
    return _tail_dtype_device(distribution)[0]


def _tail_dtype_device(distribution):
    for t in tensors(distribution):
        if t.is_floating_point():
            return t.dtype, t.device
    return torch.float32, None
