"""Bound ops with configurable gradients and the expected-gradient
perturbation (counterpart of ``compression_tpu/ops/math_ops.py``
``lower_bound`` / ``upper_bound`` / ``perturb_and_apply``).

Gradient modes (same semantics as the JAX package):
  * "identity_if_towards" (default): the gradient passes iff the input is
    inside the feasible set OR the gradient points into it, so an optimizer
    can pull a clipped variable back but never pushes it further out.
  * "disconnected": the plain subgradient of min/max (zero where clipped).
  * "identity": the gradient always passes unchanged.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["lower_bound", "upper_bound", "clip", "perturb_and_apply"]

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
    if isinstance(bound, (int, float)):
        # A fill on the device, not a copy from the host: the bound ops can
        # then be captured in a CUDA graph (the single-program decode).
        return torch.full((), bound, dtype=inputs.dtype, device=inputs.device)
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


class _PerturbAndApply(torch.autograd.Function):
    """``f(x + u, *args)``; backward: ``g * (f(x + 1/2) - f(x - 1/2))`` for
    x, zero for u, and autograd of ``f(stopgrad(x + u), *args)`` for the
    args (recomputed in the backward)."""

    @staticmethod
    def forward(ctx, f, x, u, *args):
        ctx.f = f
        ctx.save_for_backward(x, u, *args)
        return f(x + u, *args)

    @staticmethod
    def backward(ctx, g):
        x, u, *args = ctx.saved_tensors
        f = ctx.f
        dx = du = None
        if ctx.needs_input_grad[1]:
            dx = g * (f(x + 0.5, *args) - f(x - 0.5, *args))
        if ctx.needs_input_grad[2]:
            du = torch.zeros_like(u)
        wanted = [i for i, a in enumerate(args) if ctx.needs_input_grad[3 + i]]
        dargs = [None] * len(args)
        if wanted:
            with torch.enable_grad():
                leaves = [a.detach().requires_grad_(i in wanted)
                          for i, a in enumerate(args)]
                y = f((x + u).detach(), *leaves)
                grads = torch.autograd.grad(
                    y, [leaves[i] for i in wanted], g, allow_unused=True)
            for i, grad in zip(wanted, grads):
                dargs[i] = grad
        return (None, dx, du, *dargs)


def perturb_and_apply(f: Callable, x: torch.Tensor, u: torch.Tensor, *args,
                      expected_grads: bool = True) -> torch.Tensor:
    """``f(x + u, *args)`` with the expectation-consistent gradient: with
    ``expected_grads`` the gradient w.r.t. ``x`` is
    ``f(x + 1/2) - f(x - 1/2)`` (the exact derivative of ``E_u[f(x + u)]``
    for elementwise ``f`` and ``u ~ U(-1/2, 1/2)``), none flows to ``u``,
    and the ``args`` (tensors passed in, not closed over, so that gradients
    reach them) get the ordinary gradient of ``f``. ``u`` is an explicit
    argument, as in the JAX package."""
    if not expected_grads:
        return f(x + u, *args)
    return _PerturbAndApply.apply(f, x, u, *args)
