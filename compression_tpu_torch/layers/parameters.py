"""Parameter reparameterizations (counterpart of
``compression_tpu/layers/parameters.py``).

* Nonnegative (GDN): the parameter is stored as ``sqrt(value + pedestal)``
  and read back as ``lower_bound(stored, sqrt(minimum + pedestal))**2 -
  pedestal``.
* RDFT: a conv kernel is stored as coefficients in an orthonormal real-DFT
  basis over its flattened spatial support and read back through the
  inverse transform. The basis is float64 NumPy, built as the JAX package
  builds it; the functions take the JAX layouts (kernels ``(*support, cin,
  cout)``, coefficients ``(prod(support), cin, cout)``).

``Parameter`` / ``GDNParameter`` / ``RDFTParameter`` wrap the stored tensor
in an ``nn.Module``; calling one reads the effective value.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from compression_tpu_torch.ops.math_ops import lower_bound

__all__ = ["NONNEG_PEDESTAL", "nonneg_init", "nonneg_apply", "rdft_basis",
           "rdft_init", "rdft_apply", "Parameter", "GDNParameter",
           "RDFTParameter"]

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


def rdft_basis(n: int) -> np.ndarray:
    """Orthonormal real-DFT basis for length-``n`` signals: a float64
    ``(n, n)`` orthogonal matrix ``B`` whose rows are the unit-norm cosine
    and sine harmonics (``coeffs = B @ signal``, ``signal = B.T @ coeffs``)."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    rows = []
    t = np.arange(n)
    for k in range(n // 2 + 1):
        rows.append(np.cos(2 * np.pi * k * t / n))
        if 0 < k < (n + 1) / 2:  # no sine row for k = 0 and k = n/2 (even n)
            rows.append(np.sin(2 * np.pi * k * t / n))
    basis = np.stack(rows[:n], axis=0).astype(np.float64)
    return basis / np.linalg.norm(basis, axis=1, keepdims=True)


def rdft_init(kernel: torch.Tensor, basis: np.ndarray) -> torch.Tensor:
    """Coefficients ``(prod(support), cin, cout)`` of a kernel ``(*support,
    cin, cout)``, with ``basis = rdft_basis(prod(support))``."""
    n = int(np.prod(kernel.shape[:-2])) if kernel.ndim > 2 else kernel.shape[0]
    flat = kernel.reshape((n,) + tuple(kernel.shape[-2:]))
    b = torch.as_tensor(basis, dtype=flat.dtype, device=flat.device)
    return torch.einsum("kn,nio->kio", b, flat)


def rdft_apply(coeffs: torch.Tensor, basis: np.ndarray, support) -> torch.Tensor:
    """Inverse transform: coefficients -> kernel ``(*support, cin, cout)``."""
    b = torch.as_tensor(basis, dtype=coeffs.dtype, device=coeffs.device)
    flat = torch.einsum("kn,kio->nio", b, coeffs)
    return flat.reshape(tuple(support) + tuple(coeffs.shape[-2:]))


class Parameter(nn.Module):
    """A reparameterized trainable: calling it reads the effective value."""

    def forward(self) -> torch.Tensor:
        raise NotImplementedError


class GDNParameter(Parameter):
    """Sqrt-space nonnegative parameter: ``create(initial, minimum)`` stores
    the initial effective value; calling reads it back with the >= minimum
    projection and identity-if-towards gradients."""

    def __init__(self, stored: torch.Tensor, minimum: float = 0.0):
        super().__init__()
        self.stored = nn.Parameter(stored)
        self.minimum = minimum

    @classmethod
    def create(cls, initial_value, minimum: float = 0.0) -> "GDNParameter":
        return cls(nonneg_init(torch.as_tensor(initial_value)), minimum)

    def forward(self) -> torch.Tensor:
        return nonneg_apply(self.stored, self.minimum)


class RDFTParameter(Parameter):
    """A conv kernel stored as real-DFT coefficients: ``create`` projects a
    ``(*support, cin, cout)`` kernel; calling reads the kernel back."""

    def __init__(self, coeffs: torch.Tensor, support):
        super().__init__()
        self.coeffs = nn.Parameter(coeffs)
        self.support = tuple(int(s) for s in support)

    @classmethod
    def create(cls, kernel) -> "RDFTParameter":
        kernel = torch.as_tensor(kernel)
        support = tuple(int(s) for s in kernel.shape[:-2])
        return cls(rdft_init(kernel, rdft_basis(int(np.prod(support)))), support)

    def forward(self) -> torch.Tensor:
        basis = rdft_basis(int(np.prod(self.support)))
        return rdft_apply(self.coeffs, basis, self.support)
