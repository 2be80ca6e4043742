"""Bound ops with configurable gradients (counterpart of
``compression_tpu/ops/math_ops.py`` ``lower_bound`` / ``upper_bound``).

Gradient modes (same semantics as the JAX package):
  * "identity_if_towards" (default): the gradient passes iff the input is
    inside the feasible set OR the gradient points into it, so an optimizer
    can pull a clipped variable back but never pushes it further out.
  * "disconnected": the plain subgradient of min/max (zero where clipped).
  * "identity": the gradient always passes unchanged.
"""

from __future__ import annotations

import torch

__all__ = ["lower_bound", "upper_bound", "clip"]

_VALID_GRADIENTS = ("identity_if_towards", "disconnected", "identity")


class _LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, inputs, bound, gradient):
        ctx.save_for_backward(inputs, bound)
        ctx.gradient = gradient
        return torch.maximum(inputs, bound)

    @staticmethod
    def backward(ctx, grad):
        inputs, bound = ctx.saved_tensors
        if ctx.gradient == "identity":
            return grad, None, None
        pass_through = inputs >= bound
        if ctx.gradient == "identity_if_towards":
            # grad < 0: descent increases the input, toward [bound, inf).
            pass_through = pass_through | (grad < 0)
        return torch.where(pass_through, grad, torch.zeros_like(grad)), None, None


class _UpperBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, inputs, bound, gradient):
        ctx.save_for_backward(inputs, bound)
        ctx.gradient = gradient
        return torch.minimum(inputs, bound)

    @staticmethod
    def backward(ctx, grad):
        inputs, bound = ctx.saved_tensors
        if ctx.gradient == "identity":
            return grad, None, None
        pass_through = inputs <= bound
        if ctx.gradient == "identity_if_towards":
            pass_through = pass_through | (grad > 0)
        return torch.where(pass_through, grad, torch.zeros_like(grad)), None, None


def _as_bound(inputs: torch.Tensor, bound) -> torch.Tensor:
    return torch.as_tensor(bound, dtype=inputs.dtype, device=inputs.device)


def lower_bound(inputs, bound, gradient: str = "identity_if_towards"):
    """``max(inputs, bound)`` with a configurable gradient (see module docs)."""
    if gradient not in _VALID_GRADIENTS:
        raise ValueError(f"Invalid gradient: {gradient!r}; use {_VALID_GRADIENTS}")
    inputs = torch.as_tensor(inputs)
    return _LowerBound.apply(inputs, _as_bound(inputs, bound), gradient)


def upper_bound(inputs, bound, gradient: str = "identity_if_towards"):
    """``min(inputs, bound)`` with a configurable gradient (see module docs)."""
    if gradient not in _VALID_GRADIENTS:
        raise ValueError(f"Invalid gradient: {gradient!r}; use {_VALID_GRADIENTS}")
    inputs = torch.as_tensor(inputs)
    return _UpperBound.apply(inputs, _as_bound(inputs, bound), gradient)


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``min(max(x, lo), hi)`` with jnp.clip's gradient: where x equals a
    bound, half the gradient passes (torch.clamp passes all of it). The
    tie is common where a layer outputs exact zeros, as an untrained
    synthesis does on all-zero latents."""
    lo_t = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi_t = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)
