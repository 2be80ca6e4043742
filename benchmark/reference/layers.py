"""Plain PyTorch layers of the reference codecs, channels-last (NHWC) at
their boundary like the program's, written from the models' definitions
(Balle et al. 2018; Mentzer et al. 2020; tensorflow_compression's
SignalConv2D, GDN and bound ops). Parameters are a flat dict of
``"<layer path>/<leaf>"`` keys in the flax layout the checkpoints use:
kernels ``(kh, kw, cin, cout)``, GDN's ``beta`` and ``gamma`` stored in
sqrt space.

Nothing here imports the program: the reference must be able to disagree
with it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# GDN's reparameterization: stored = sqrt(value + pedestal).
_PEDESTAL = (2.0 ** -18) ** 2


class LowerBound(torch.autograd.Function):
    """``max(x, bound)``; the gradient passes where x is feasible or where
    it points into the feasible set (tensorflow_compression's
    ``identity_if_towards``)."""

    @staticmethod
    def forward(ctx, x, bound):
        b = torch.full((), bound, dtype=x.dtype, device=x.device)
        ctx.save_for_backward(x, b)
        return torch.maximum(x, b)

    @staticmethod
    def backward(ctx, g):
        x, b = ctx.saved_tensors
        return torch.where((x >= b) | (g < 0), g, torch.zeros_like(g)), None


class UpperBound(torch.autograd.Function):
    """``min(x, bound)`` with the mirrored ``identity_if_towards`` gradient."""

    @staticmethod
    def forward(ctx, x, bound):
        b = torch.full((), bound, dtype=x.dtype, device=x.device)
        ctx.save_for_backward(x, b)
        return torch.minimum(x, b)

    @staticmethod
    def backward(ctx, g):
        x, b = ctx.saved_tensors
        return torch.where((x <= b) | (g > 0), g, torch.zeros_like(g)), None


def nonneg(stored: torch.Tensor, minimum: float = 0.0) -> torch.Tensor:
    """GDN's effective parameter from its sqrt-space storage."""
    return torch.square(LowerBound.apply(stored, math.sqrt(minimum + _PEDESTAL))) - _PEDESTAL


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def conv(x, p, name, stride=1, bias=True):
    """A centred "same" correlation (odd kernel), optionally strided."""
    k = p[f"{name}/kernel"]
    w = k.permute(3, 2, 0, 1)
    b = p[f"{name}/bias"] if bias else None
    pad = (k.shape[0] - 1) // 2
    return _nhwc(F.conv2d(_nchw(x), w, b, stride=stride, padding=pad))


def conv_up(x, p, name, bias=True):
    """SignalConv2D's 2x up-sampling convolution with zero padding: zeros
    stuffed after every sample (the last one's too), the flipped kernel
    correlated over the grid padded ``(k // 2, k - 1 - k // 2)``. That is a
    transposed convolution of the unflipped kernel with padding
    ``k - 1 - k // 2`` and one extra output row and column."""
    k = p[f"{name}/kernel"]
    w = k.permute(2, 3, 0, 1)  # (cin, cout, kh, kw)
    b = p[f"{name}/bias"] if bias else None
    pad = k.shape[0] - 1 - k.shape[0] // 2
    return _nhwc(F.conv_transpose2d(_nchw(x), w, b, stride=2, padding=pad,
                                    output_padding=1))


def gdn(x, p, name, inverse=False):
    """``x / sqrt(beta + x^2 gamma)`` (or times it, inverse)."""
    beta = nonneg(p[f"{name}/beta"], 1e-6)
    gamma = nonneg(p[f"{name}/gamma"], 0.0)
    norm = torch.matmul(x * x, gamma) + beta
    return x * (torch.sqrt(norm) if inverse else torch.rsqrt(norm))


def channel_norm(x, p, name, eps=1e-3):
    """Each position normalised over its channels (population variance),
    then scaled and shifted per channel."""
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mu).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p[f"{name}/gamma"] + p[f"{name}/beta"]


def to_uint8(x):
    """[0, 1] floats to the uint8 image a decoder returns."""
    return torch.clamp(torch.round(x * 255.0), 0, 255).to(torch.uint8)
