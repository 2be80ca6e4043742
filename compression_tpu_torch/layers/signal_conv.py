"""SignalConv1D/2D/3D: up/down-sampled correlation/convolution for codecs
(counterpart of ``compression_tpu/layers/signal_conv.py``).

Semantics, as in the JAX package: upsample by inserting ``su - 1`` zeros
(plus ``su - 1`` at the end with ``extra_pad_end``), pad ``(c, k - 1 - c)``
on the upsampled grid (zeros for ``same_zeros``, whole-sample reflection
for ``same_reflect``, none for ``valid``), correlate (or convolve with the
flipped kernel), keep every ``sd``-th output. Up-sampling on the zero
padding modes goes through the same phase decomposition + depth-to-space as
the JAX package (one dense stride-1 conv with ``prod(su) * cout`` output
channels), never through a transposed convolution. The two routes the JAX
package takes otherwise are followed as it takes them: a
``channel_separable`` (depthwise, groups = C_in) conv up-samples its input
by zero-stuffing (the JAX package's ``lhs_dilation``), and ``same_reflect``
zero-stuffs before it reflects.

Layouts: activations are channels-last (``N, *spatial, C``) at this
module's boundary (the JAX layout); inside, each conv sees a channels-first
view of that memory, so in 2-D this module copies no activation around
cuDNN and hands GDN a contiguous ``(rows, C)`` view (cuDNN's fp32 kernels
are NCHW and transpose internally). Weights are torch's ``(cout, cin,
*support)`` (OIHW in 2-D; ``(cin * m, 1, *support)`` when channel
separable). Convolutions go to ``torch.nn.functional.conv1d/2d/3d``: the
JAX package leaves them to XLA outside any Pallas kernel, so they get no
hand-written kernel.
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from compression_tpu_torch.layers import parameters
from compression_tpu_torch.ops.padding_ops import same_padding_for_kernel

__all__ = ["signal_conv", "phase_kernel", "conv_nhwc", "SignalConv1D",
           "SignalConv2D", "SignalConv3D", "truncated_normal_init"]

_Pad = Tuple[Tuple[int, int], ...]
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _tuple(value: Union[int, Sequence[int]], ndim: int, name: str) -> Tuple[int, ...]:
    if isinstance(value, int):
        return (value,) * ndim
    value = tuple(int(v) for v in value)
    if len(value) != ndim:
        raise ValueError(f"{name} must have length {ndim}, got {value}")
    return value


def _torch_pad(pad: _Pad) -> Tuple[int, ...]:
    """Per-dim ``(lo, hi)`` pairs as ``F.pad`` takes them (last dim first)."""
    return tuple(v for lo_hi in reversed(pad) for v in lo_hi)


def conv_nhwc(x: torch.Tensor, weight: torch.Tensor, pad: _Pad,
              stride: Tuple[int, ...], groups: int = 1) -> torch.Tensor:
    """Zero-padded strided correlation of a channels-last tensor
    ``(N, *spatial, C)`` (NHWC in 2-D); returns channels-last."""
    nd = x.ndim - 2
    xc = x.permute(0, nd + 1, *range(1, nd + 1))  # channels-first view
    if all(lo == hi for lo, hi in pad):
        padding = tuple(lo for lo, _ in pad)
    else:
        xc = F.pad(xc, _torch_pad(pad))
        padding = (0,) * nd
    if nd == 2:
        weight = weight.contiguous(memory_format=torch.channels_last)
    out = _CONV[nd](xc, weight, stride=stride, padding=padding, groups=groups)
    return out.permute(0, *range(2, nd + 2), 1)


def phase_kernel(weight: torch.Tensor, su: Tuple[int, ...],
                 lo: Tuple[int, ...]):
    """Phase-decomposed dense kernel for an upsampled correlation.

    ``y[su*q + p] = sum_m PK[p][m] * x[q + mlo + m]`` with
    ``PK[p][m] = kernel[su*(m + mlo) + lo - p]`` where defined, else 0.

    Args:
      weight: ``(cout, cin, *support)`` in correlation orientation.
      su: per-dim upsampling factors; lo: per-dim low padding on the
        upsampled grid.

    Returns ``(pk, mlo, M)``: the stride-1 kernel ``(prod(su) * cout, cin,
    *M)`` with phase-major output channels (in 2-D, channel ``(p_h * su_w
    + p_w) * cout + o``), the input offset ``mlo`` and the dense support
    ``M`` per dim.
    """
    nd = weight.ndim - 2
    K = weight.shape[2:]
    mlo = [-(lo[d] // su[d]) for d in range(nd)]
    mhi = [(K[d] - 1 - lo[d] + su[d] - 1) // su[d] for d in range(nd)]
    M = [mhi[d] - mlo[d] + 1 for d in range(nd)]
    # Each phase is a stride-su slice of the kernel; zero-pad it so the
    # slices' out-of-support taps read zeros.
    lead = [max(0, su[d] - 1 - su[d] * mlo[d] - lo[d]) for d in range(nd)]
    trail = [max(0, su[d] * mhi[d] + lo[d] - (K[d] - 1)) for d in range(nd)]
    wp = F.pad(weight, _torch_pad(tuple(zip(lead, trail))))
    phases = []
    for p in itertools.product(*[range(s) for s in su]):
        starts = [su[d] * mlo[d] + lo[d] - p[d] + lead[d] for d in range(nd)]
        phases.append(wp[(slice(None), slice(None)) + tuple(
            slice(starts[d], starts[d] + su[d] * (M[d] - 1) + 1, su[d])
            for d in range(nd))])
    return torch.cat(phases, 0), mlo, M


def _phase_upsampled_conv(x, weight, sd, su, pad, extra_pad_end):
    """Upsampled correlation via phase decomposition + depth-to-space; the
    same array the zero-stuffed convolution of the spec gives."""
    nd = x.ndim - 2
    n = x.shape[1:-1]
    K = weight.shape[2:]
    cout = weight.shape[0]
    lo = [p[0] for p in pad]
    hi = [p[1] + (s - 1 if extra_pad_end else 0) for p, s in zip(pad, su)]
    T = [(n[d] - 1) * su[d] + 1 + lo[d] + hi[d] - K[d] + 1 for d in range(nd)]
    if any(t <= 0 for t in T):
        raise ValueError(f"empty output for input {tuple(n)}, support "
                         f"{tuple(K)}, padding {pad}")
    pk, mlo, M = phase_kernel(weight, su, lo)
    Q = [-(-T[d] // su[d]) for d in range(nd)]
    conv_pad = tuple(
        (-mlo[d], Q[d] - 1 + mlo[d] + M[d] - n[d]) for d in range(nd)
    )
    out = conv_nhwc(x, pk, conv_pad, (1,) * nd)  # (N, *Q, P*cout)
    nb = out.shape[0]
    out = out.reshape((nb, *Q, *su, cout))
    order = [0] + [a for d in range(nd) for a in (1 + d, 1 + nd + d)]
    out = out.permute(*order, 1 + 2 * nd).reshape(
        (nb, *[Q[d] * su[d] for d in range(nd)], cout))
    if any(T[d] != out.shape[1 + d] for d in range(nd)) or any(s != 1 for s in sd):
        out = out[(slice(None),) + tuple(slice(0, T[d], sd[d]) for d in range(nd))]
    return out


def _upsample_zeros(x: torch.Tensor, su: Tuple[int, ...],
                    extra_pad_end: bool) -> torch.Tensor:
    """Zero-stuffed upsampling of a channels-last tensor: ``su - 1`` zeros
    after each sample (the last sample's only with ``extra_pad_end``)."""
    for d, s in enumerate(su):
        if s == 1:
            continue
        axis = 1 + d
        n = x.shape[axis]
        shape = list(x.shape)
        shape[axis] = n * s if extra_pad_end else (n - 1) * s + 1
        out = x.new_zeros(shape)
        index = [slice(None)] * x.ndim
        index[axis] = slice(0, None, s)
        out[tuple(index)] = x
        x = out
    return x


def _reflect_pad(x: torch.Tensor, pad: _Pad) -> torch.Tensor:
    """Whole-sample reflection (NumPy's ``reflect``) of each spatial dim of
    a channels-last tensor, for any pad width (repeated reflection past the
    length, as ``jnp.pad`` does), through an index gather."""
    for d, (lo, hi) in enumerate(pad):
        if lo == 0 and hi == 0:
            continue
        axis = 1 + d
        n = x.shape[axis]
        idx = torch.arange(-lo, n + hi, device=x.device)
        if n == 1:
            idx = torch.zeros_like(idx)
        else:
            period = 2 * (n - 1)
            m = torch.remainder(idx, period)
            idx = torch.where(m < n, m, period - m)
        x = torch.index_select(x, axis, idx)
    return x


def signal_conv(
    x: torch.Tensor,
    weight: torch.Tensor,
    *,
    corr: bool = False,
    strides_down: Union[int, Sequence[int]] = 1,
    strides_up: Union[int, Sequence[int]] = 1,
    padding: str = "valid",
    extra_pad_end: bool = True,
    channel_separable: bool = False,
) -> torch.Tensor:
    """Functional N-D signal convolution (see the module docstring).

    Args:
      x: ``(N, *spatial, C_in)``, 1 to 3 spatial dims.
      weight: ``(C_out, C_in, *support)``, or ``(C_in * m, 1, *support)``
        when ``channel_separable`` (depthwise with multiplier ``m``).

    Returns:
      ``(N, *spatial', C_out)``.
    """
    nd = x.ndim - 2
    if weight.ndim != nd + 2:
        raise ValueError(
            f"kernel rank {weight.ndim} does not match input spatial rank {nd}")
    support = tuple(weight.shape[2:])
    sd = _tuple(strides_down, nd, "strides_down")
    su = _tuple(strides_up, nd, "strides_up")
    if padding not in ("valid", "same_zeros", "same_reflect"):
        raise ValueError(f"Unknown padding: {padding!r}")
    if not corr:
        weight = torch.flip(weight, tuple(range(2, nd + 2)))
    groups = 1
    if channel_separable:
        cin = x.shape[-1]
        if weight.shape[1] != 1 or weight.shape[0] % cin:
            raise ValueError(
                "channel_separable kernel must be (C_in * m, 1, *support); got "
                f"{tuple(weight.shape)} for C_in={cin}")
        groups = cin
    upsampled = any(s > 1 for s in su)
    if padding == "same_reflect":
        if upsampled:
            x = _upsample_zeros(x, su, extra_pad_end)
        x = _reflect_pad(x, same_padding_for_kernel(support, corr))
        return conv_nhwc(x, weight, ((0, 0),) * nd, sd, groups)
    if padding == "valid":
        pad = ((0, 0),) * nd
    else:
        pad = same_padding_for_kernel(support, corr)
    if upsampled:
        if groups == 1:
            return _phase_upsampled_conv(x, weight, sd, su, pad, extra_pad_end)
        # The JAX package's lhs_dilation: zeros between the samples, and
        # the extra_pad_end zeros merged into the high padding.
        x = _upsample_zeros(x, su, False)
        pad = tuple((lo, hi + (s - 1 if extra_pad_end else 0))
                    for (lo, hi), s in zip(pad, su))
    return conv_nhwc(x, weight, pad, sd, groups)


# Standard deviation of a unit normal cut at +-2 (the JAX initializer's
# correction, so the cut distribution keeps the asked-for variance).
_TRUNCATED_STD = 0.87962566103423978


def truncated_normal_init(weight: torch.Tensor, generator: torch.Generator,
                          mode: str = "fan_avg") -> torch.Tensor:
    """Fills a ``(cout, cin, *support)`` ``weight`` as
    ``variance_scaling(1.0, mode, "truncated_normal")``: a normal cut at +-2
    standard deviations, scaled to variance ``1 / fan`` with ``fan_in = cin
    * prod(support)`` (flax ``nn.Conv``'s default, ``lecun_normal``) or
    ``fan_avg = (cin + cout) * prod(support) / 2`` (the JAX package's
    SignalConv default); drawn by the inverse CDF from ``generator``'s
    uniforms, as ``jax.random.truncated_normal`` draws."""
    cout, cin, *support = weight.shape
    receptive = math.prod(support)
    fans = {"fan_in": cin * receptive, "fan_avg": (cin + cout) * receptive / 2.0}
    std = math.sqrt(1.0 / fans[mode]) / _TRUNCATED_STD
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    with torch.no_grad():
        u = torch.rand(weight.shape, generator=generator, dtype=torch.float64)
        z = math.sqrt(2.0) * torch.erfinv(lo + (hi - lo) * u)
        return weight.copy_(torch.clamp(z, -2.0, 2.0) * std)


class _SignalConv(nn.Module):
    """SignalConv over channels-last activations; use the rank-specific
    subclasses (see the module docstring).

    Parameters: ``weight`` ``(num_filters, in_channels, *support)`` (or
    ``(in_channels * num_filters, 1, *support)`` when ``channel_separable``),
    drawn by ``kernel_init(generator, shape, dtype)`` if given, else by
    :func:`truncated_normal_init` at ``fan_avg``, from ``generator`` (a
    fresh one seeded 0 if none is given). With ``kernel_param="rdft"`` and a
    support of more than one tap, ``weight_rdft`` replaces it: the kernel's
    real-DFT coefficients in the JAX package's ``kernel_rdft`` layout
    ``(prod(support), cin, cout)``. With ``use_bias``, ``bias`` ``(cout,)``
    at zero.
    """

    ndim = 2

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
        channel_separable: bool = False,
        use_bias: bool = False,
        activation: Optional[Callable] = None,
        kernel_param: str = "variable",
        kernel_init: Optional[Callable] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        nd = self.ndim
        self.support = _tuple(kernel_support, nd, "kernel_support")
        self.corr = corr
        self.strides_down = _tuple(strides_down, nd, "strides_down")
        self.strides_up = _tuple(strides_up, nd, "strides_up")
        self.padding = padding
        self.extra_pad_end = extra_pad_end
        self.channel_separable = channel_separable
        self.activation = activation
        if kernel_param not in ("variable", "rdft"):
            raise ValueError(f"Unknown kernel_param: {kernel_param!r}")
        if channel_separable:
            cout, cin_w = in_channels * num_filters, 1
        else:
            cout, cin_w = num_filters, in_channels
        shape = (cout, cin_w) + self.support
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        if kernel_init is not None:
            weight = kernel_init(generator, shape, torch.float32)
        else:
            weight = truncated_normal_init(torch.empty(shape), generator, "fan_avg")
        taps = math.prod(self.support)
        if kernel_param == "rdft" and taps > 1:
            basis = parameters.rdft_basis(taps)
            self.register_buffer("rdft_basis", torch.from_numpy(basis),
                                 persistent=False)
            jax_layout = weight.permute(*range(2, nd + 2), 1, 0)
            self.weight_rdft = nn.Parameter(parameters.rdft_init(jax_layout, basis))
            self.weight = None
        else:
            self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None

    def kernel(self) -> torch.Tensor:
        """The effective ``(cout, cin, *support)`` kernel."""
        if self.weight is not None:
            return self.weight
        nd = self.ndim
        k = parameters.rdft_apply(self.weight_rdft, self.rdft_basis, self.support)
        return k.permute(nd + 1, nd, *range(nd))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = signal_conv(
            x, self.kernel(), corr=self.corr, strides_down=self.strides_down,
            strides_up=self.strides_up, padding=self.padding,
            extra_pad_end=self.extra_pad_end,
            channel_separable=self.channel_separable,
        )
        if self.bias is not None:
            y = y + self.bias
        if self.activation is not None:
            y = self.activation(y)
        return y


class SignalConv1D(_SignalConv):
    """1-D SignalConv over ``(N, L, C)``."""

    ndim = 1


class SignalConv2D(_SignalConv):
    """2-D SignalConv over NHWC activations; weights OIHW."""

    ndim = 2


class SignalConv3D(_SignalConv):
    """3-D SignalConv over ``(N, D, H, W, C)``."""

    ndim = 3
