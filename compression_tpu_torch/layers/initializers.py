"""Kernel initializers (counterpart of
``compression_tpu/layers/initializers.py``)."""

from __future__ import annotations

import torch

__all__ = ["identity_kernel_init"]


def identity_kernel_init(gain: float = 1.0):
    """An init for conv weights ``(cout, cin, *support)`` (the port's layout
    of the JAX package's ``(*support, cin, cout)``) that makes the layer an
    identity map: a centered delta impulse times an identity channel mixing
    (a rectangular ``eye(cin, cout)`` when they differ). The init takes
    ``(generator, shape, dtype)`` and draws nothing."""

    def init(generator, shape, dtype=torch.float32):
        del generator
        cout, cin, *support = shape
        kernel = torch.zeros(shape, dtype=dtype)
        center = tuple((k - 1) // 2 for k in support)
        kernel[(slice(None), slice(None)) + center] = gain * torch.eye(
            cin, cout, dtype=dtype).T
        return kernel

    return init
