"""SignalConv2D: up/down-sampled correlation/convolution for codecs
(counterpart of ``compression_tpu/layers/signal_conv.py``, 2-D and the
``valid`` / ``same_zeros`` padding modes).

Semantics, as in the JAX package: upsample by inserting ``su - 1`` zeros
(plus ``su - 1`` at the end with ``extra_pad_end``), pad ``(c, k - 1 - c)``
on the upsampled grid, correlate (or convolve with the flipped kernel), keep
every ``sd``-th output. Up-sampling goes through the same phase
decomposition + depth-to-space as the JAX package (one dense stride-1 conv
with ``su_h * su_w * cout`` output channels), never through a zero-stuffed
or transposed convolution.

Layouts: activations are NHWC at this module's boundary (the JAX layout);
inside, each conv sees an NCHW view of that memory, i.e. a tensor in
``torch.channels_last`` format, so this module copies no activation
around cuDNN and hands GDN a contiguous ``(rows, C)`` view (cuDNN's fp32
kernels are NCHW and transpose internally). Weights
are torch's OIHW ``(cout, cin, kh, kw)``. Convolutions go to
``torch.nn.functional.conv2d``: the JAX package leaves them to XLA outside
any Pallas kernel, so they get no hand-written kernel.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from compression_tpu_torch.ops.padding_ops import same_padding_for_kernel

__all__ = ["signal_conv", "phase_kernel", "conv_nhwc", "SignalConv2D",
           "truncated_normal_init"]

_Pad = Tuple[Tuple[int, int], Tuple[int, int]]


def _pair(value: Union[int, Sequence[int]], name: str) -> Tuple[int, int]:
    if isinstance(value, int):
        return (value, value)
    value = tuple(int(v) for v in value)
    if len(value) != 2:
        raise ValueError(f"{name} must have length 2, got {value}")
    return value


def conv_nhwc(x: torch.Tensor, weight: torch.Tensor, pad: _Pad,
               stride: Tuple[int, int]) -> torch.Tensor:
    """Zero-padded strided correlation of an NHWC tensor; returns NHWC."""
    xc = x.permute(0, 3, 1, 2)  # NCHW view, channels_last memory
    (hlo, hhi), (wlo, whi) = pad
    if hlo == hhi and wlo == whi:
        padding = (hlo, wlo)
    else:
        xc = F.pad(xc, (wlo, whi, hlo, hhi))
        padding = (0, 0)
    weight = weight.contiguous(memory_format=torch.channels_last)
    out = F.conv2d(xc, weight, stride=stride, padding=padding)
    return out.permute(0, 2, 3, 1)


def phase_kernel(weight: torch.Tensor, su: Tuple[int, int],
                 lo: Tuple[int, int]):
    """Phase-decomposed dense kernel for an upsampled correlation.

    ``y[su*q + p] = sum_m PK[p][m] * x[q + mlo + m]`` with
    ``PK[p][m] = kernel[su*(m + mlo) + lo - p]`` where defined, else 0.

    Args:
      weight: OIHW ``(cout, cin, kh, kw)`` in correlation orientation.
      su: per-dim upsampling factors; lo: per-dim low padding on the
        upsampled grid.

    Returns ``(pk, mlo, M)``: the OIHW stride-1 kernel
    ``(prod(su) * cout, cin, *M)`` with phase-major output channels
    (channel ``(p_h * su_w + p_w) * cout + o``), the input offset ``mlo``
    and the dense support ``M`` per dim.
    """
    K = weight.shape[2:]
    mlo = [-(lo[d] // su[d]) for d in range(2)]
    mhi = [(K[d] - 1 - lo[d] + su[d] - 1) // su[d] for d in range(2)]
    M = [mhi[d] - mlo[d] + 1 for d in range(2)]
    # Each phase is a stride-su slice of the kernel; zero-pad it so the
    # slices' out-of-support taps read zeros.
    lead = [max(0, su[d] - 1 - su[d] * mlo[d] - lo[d]) for d in range(2)]
    trail = [max(0, su[d] * mhi[d] + lo[d] - (K[d] - 1)) for d in range(2)]
    wp = F.pad(weight, (lead[1], trail[1], lead[0], trail[0]))
    phases = []
    for p0 in range(su[0]):
        s0 = su[0] * mlo[0] + lo[0] - p0 + lead[0]
        for p1 in range(su[1]):
            s1 = su[1] * mlo[1] + lo[1] - p1 + lead[1]
            phases.append(
                wp[:, :, s0 : s0 + su[0] * (M[0] - 1) + 1 : su[0],
                   s1 : s1 + su[1] * (M[1] - 1) + 1 : su[1]]
            )
    return torch.cat(phases, 0), mlo, M


def _phase_upsampled_conv(x, weight, sd, su, pad, extra_pad_end):
    """Upsampled correlation via phase decomposition + depth-to-space; the
    same array the zero-stuffed convolution of the spec gives."""
    n = x.shape[1:3]
    K = weight.shape[2:]
    cout = weight.shape[0]
    lo = [p[0] for p in pad]
    hi = [p[1] + (s - 1 if extra_pad_end else 0) for p, s in zip(pad, su)]
    T = [(n[d] - 1) * su[d] + 1 + lo[d] + hi[d] - K[d] + 1 for d in range(2)]
    if any(t <= 0 for t in T):
        raise ValueError(f"empty output for input {tuple(n)}, support "
                         f"{tuple(K)}, padding {pad}")
    pk, mlo, M = phase_kernel(weight, su, lo)
    Q = [-(-T[d] // su[d]) for d in range(2)]
    conv_pad = tuple(
        (-mlo[d], Q[d] - 1 + mlo[d] + M[d] - n[d]) for d in range(2)
    )
    out = conv_nhwc(x, pk, conv_pad, (1, 1))  # (N, Q0, Q1, P*cout)
    nb = out.shape[0]
    out = out.reshape(nb, Q[0], Q[1], su[0], su[1], cout)
    out = out.permute(0, 1, 3, 2, 4, 5).reshape(
        nb, Q[0] * su[0], Q[1] * su[1], cout
    )
    if T[0] != out.shape[1] or T[1] != out.shape[2] or sd != (1, 1):
        out = out[:, : T[0] : sd[0], : T[1] : sd[1], :]
    return out


def signal_conv(
    x: torch.Tensor,
    weight: torch.Tensor,
    *,
    corr: bool = False,
    strides_down: Union[int, Sequence[int]] = 1,
    strides_up: Union[int, Sequence[int]] = 1,
    padding: str = "valid",
    extra_pad_end: bool = True,
) -> torch.Tensor:
    """Functional 2-D signal convolution.

    Args:
      x: ``(N, H, W, C_in)``.
      weight: OIHW ``(C_out, C_in, kh, kw)``.

    Returns:
      ``(N, H', W', C_out)``.
    """
    sd = _pair(strides_down, "strides_down")
    su = _pair(strides_up, "strides_up")
    if padding == "valid":
        pad = ((0, 0), (0, 0))
    elif padding == "same_zeros":
        pad = same_padding_for_kernel(weight.shape[2:], corr)
    else:
        raise ValueError(f"Unsupported padding: {padding!r}")
    if not corr:
        weight = torch.flip(weight, (2, 3))
    if su != (1, 1):
        return _phase_upsampled_conv(x, weight, sd, su, pad, extra_pad_end)
    return conv_nhwc(x, weight, pad, sd)


# Standard deviation of a unit normal cut at +-2 (the JAX initializer's
# correction, so the cut distribution keeps the asked-for variance).
_TRUNCATED_STD = 0.87962566103423978


def truncated_normal_init(weight: torch.Tensor, generator: torch.Generator,
                          mode: str = "fan_avg") -> torch.Tensor:
    """Fills an OIHW ``weight`` as ``variance_scaling(1.0, mode,
    "truncated_normal")``: a normal cut at +-2 standard deviations, scaled to
    variance ``1 / fan`` with ``fan_in = cin * kh * kw`` (flax ``nn.Conv``'s
    default, ``lecun_normal``) or ``fan_avg = (cin + cout) * kh * kw / 2``
    (the JAX package's SignalConv2D default); drawn by the inverse CDF from
    ``generator``'s uniforms, as ``jax.random.truncated_normal`` draws."""
    cout, cin, kh, kw = weight.shape
    fans = {"fan_in": cin * kh * kw, "fan_avg": (cin + cout) * kh * kw / 2.0}
    std = math.sqrt(1.0 / fans[mode]) / _TRUNCATED_STD
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    with torch.no_grad():
        u = torch.rand(weight.shape, generator=generator, dtype=torch.float64)
        z = math.sqrt(2.0) * torch.erfinv(lo + (hi - lo) * u)
        return weight.copy_(torch.clamp(z, -2.0, 2.0) * std)


class SignalConv2D(nn.Module):
    """2-D SignalConv over NHWC activations (see module docstring).

    Parameters: ``weight`` OIHW ``(num_filters, in_channels, kh, kw)``,
    drawn by :func:`truncated_normal_init` at ``fan_avg`` from ``generator`` (a fresh
    one seeded 0 if none is given), and, with ``use_bias``, ``bias``
    ``(num_filters,)`` at zero.
    """

    def __init__(
        self,
        in_channels: int,
        num_filters: int,
        kernel_support: Union[int, Sequence[int]],
        *,
        corr: bool = False,
        strides_down: Union[int, Sequence[int]] = 1,
        strides_up: Union[int, Sequence[int]] = 1,
        padding: str = "valid",
        extra_pad_end: bool = True,
        use_bias: bool = False,
        activation: Optional[Callable] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        kh, kw = _pair(kernel_support, "kernel_support")
        self.corr = corr
        self.strides_down = _pair(strides_down, "strides_down")
        self.strides_up = _pair(strides_up, "strides_up")
        self.padding = padding
        self.extra_pad_end = extra_pad_end
        self.activation = activation
        self.weight = nn.Parameter(
            torch.empty(num_filters, in_channels, kh, kw)
        )
        self.bias = nn.Parameter(torch.zeros(num_filters)) if use_bias else None
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        truncated_normal_init(self.weight, generator, "fan_avg")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = signal_conv(
            x, self.weight, corr=self.corr, strides_down=self.strides_down,
            strides_up=self.strides_up, padding=self.padding,
            extra_pad_end=self.extra_pad_end,
        )
        if self.bias is not None:
            y = y + self.bias
        if self.activation is not None:
            y = self.activation(y)
        return y
