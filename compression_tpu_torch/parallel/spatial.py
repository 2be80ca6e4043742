"""Spatially sharded convolutions with halo exchange (counterpart of
``compression_tpu/parallel/spatial.py``).

For images too large for one device, the input is split along H into one
shard per mesh position and each shard is convolved on its device; the
rows a kernel needs from the neighbouring shards (the halo) are sliced off
them and copied to the shard's device first (the JAX package's
``ppermute``; no copy where two shards share a device). Zeros stand in for
the halo at the image's top and bottom ("same_zeros").

Restrictions, as in the JAX package: "same_zeros" padding, sharding along
H only, shard height at least the halo and divisible by the H stride. Both
directions: strided down-convolutions (analysis) through
:func:`sharded_signal_conv2d`, and up-convolutions (synthesis) through
:func:`sharded_signal_conv2d_up`, which takes the dense path's phase
decomposition (``layers/signal_conv.py`` ``phase_kernel``): a stride-1
halo convolution with phase-major channels, then a depth-to-space local to
the shard.

Sharded activations are lists of tensors, one per mesh position, each
``(N, H / n, W, C)`` channels-last on its device (the port's layout at the
models' API; each convolution sees a channels-first view inside).
:func:`shard_rows` splits an image batch, :func:`gather_rows` joins shards.
GDN, ChannelNorm and the other per-position modules run on each shard
through the module itself (``Replicas.map``: the module's copy on another
device), so GDN runs K1 or the general kernel on the card, one launch a
shard.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Union

import torch
from torch import nn

from compression_tpu_torch.layers.gdn import GDN
from compression_tpu_torch.layers.signal_conv import SignalConv2D, conv_nhwc, phase_kernel
from compression_tpu_torch.ops.padding_ops import same_padding_for_kernel
from compression_tpu_torch.parallel.data_parallel import Mesh, Replicas

__all__ = ["shard_rows", "gather_rows", "as_shards", "map_shards", "sharded_signal_conv2d",
           "sharded_signal_conv2d_up", "sharded_conv", "sharded_transform_apply"]

Shards = List[torch.Tensor]


def shard_rows(x: torch.Tensor, mesh: Mesh, axis: str = "data") -> Shards:
    """Splits ``(N, H, W, C)`` along H into one shard per mesh position,
    each on its device. H must divide the mesh size."""
    n = mesh.shape[axis]
    if x.shape[1] % n:
        raise ValueError(f"H ({x.shape[1]}) must divide the mesh axis ({n})")
    return [part.to(dev) for part, dev in zip(torch.chunk(x, n, dim=1), mesh.devices)]


def gather_rows(shards: Sequence[torch.Tensor]) -> torch.Tensor:
    """The shards joined along H on the first shard's device."""
    dev = shards[0].device
    return torch.cat([s.to(dev) for s in shards], dim=1)


def map_shards(fn: Callable, *shards: Sequence[torch.Tensor]) -> Shards:
    """``fn`` on each mesh position's shards (per-position ops need no
    halo)."""
    return [fn(*parts) for parts in zip(*shards)]


def as_shards(x, mesh: Mesh, axis: str = "data") -> Shards:
    """``x``'s shards: a list of them as it is, a tensor split by
    :func:`shard_rows`."""
    shards = list(x) if isinstance(x, (list, tuple)) else shard_rows(x, mesh, axis)
    if len(shards) != mesh.shape[axis]:
        raise ValueError(f"{len(shards)} shards for a mesh axis of {mesh.shape[axis]}")
    return shards


def _with_halo(shards: Shards, lo: int, hi: int) -> Shards:
    """Each shard with ``lo`` rows of its upper neighbour above it and
    ``hi`` of its lower one below (zeros at the image's edges)."""
    n = len(shards)
    out = []
    for i, x in enumerate(shards):
        parts = [x]
        if lo:
            parts.insert(0, shards[i - 1][:, -lo:].to(x.device) if i > 0
                         else x.new_zeros((x.shape[0], lo) + x.shape[2:]))
        if hi:
            parts.append(shards[i + 1][:, :hi].to(x.device) if i < n - 1
                         else x.new_zeros((x.shape[0], hi) + x.shape[2:]))
        out.append(torch.cat(parts, dim=1) if len(parts) > 1 else x)
    return out


def _pair(value: Union[int, Sequence[int]]) -> tuple:
    return (value, value) if isinstance(value, int) else tuple(value)


def sharded_signal_conv2d(x, kernel: torch.Tensor, mesh: Mesh, axis: str = "data",
                          corr: bool = True,
                          strides_down: Union[int, Sequence[int]] = 1) -> Shards:
    """``signal_conv(..., padding="same_zeros", strides_down=s)`` with H
    sharded over ``axis``.

    "same" padding totals kh - 1 whatever the stride, so shard i's first
    output window starts at global row ``i * H_loc - pad_lo``, the
    halo-extended local row 0, and advances by the stride; with ``H_loc %
    s == 0`` every shard gives ``H_loc / s`` rows and their concatenation
    is the dense result.

    Args:
      x: ``(N, H, W, C)`` (H divisible by the mesh size times the H
        stride), or its shards.
      kernel: ``(Cout, C, kh, kw)``, the port's layout.
      strides_down: int or (sh, sw).

    Returns the output's shards, ``(N, H / (n sh), W / sw, Cout)`` each.
    """
    sh, sw = _pair(strides_down)
    (pad_lo, pad_hi), w_pad = same_padding_for_kernel(tuple(kernel.shape[2:]), corr)
    shards = as_shards(x, mesh, axis)
    n, h_loc = len(shards), shards[0].shape[1]
    if h_loc % sh:
        raise ValueError(
            f"shard height {h_loc * n}/{n} must be divisible by the H stride {sh}")
    if h_loc < max(pad_lo, pad_hi):
        raise ValueError(
            f"shard height {h_loc} smaller than the halo ({pad_lo}, {pad_hi})")
    weight = kernel if corr else torch.flip(kernel, (2, 3))
    return [conv_nhwc(xp, weight.to(xp.device), ((0, 0), w_pad), (sh, sw))
            for xp in _with_halo(shards, pad_lo, pad_hi)]


def sharded_signal_conv2d_up(x, kernel: torch.Tensor, mesh: Mesh, axis: str = "data",
                             corr: bool = False,
                             strides_up: Union[int, Sequence[int]] = 2) -> Shards:
    """``signal_conv(..., padding="same_zeros", strides_up=s,
    extra_pad_end=True)`` with H sharded over ``axis``: the synthesis
    counterpart of :func:`sharded_signal_conv2d`.

    In the phase decomposition, output rows ``su * q + p`` read input rows
    ``q + mlo .. q + mlo + M - 1`` only, so shard i's ``H_loc`` input rows
    and a ``(-mlo, M - 1 + mlo)`` halo give exactly its ``su * H_loc``
    output rows; the depth-to-space is local.

    Args:
      x: ``(N, H, W, C)`` (H divisible by the mesh size), or its shards.
      kernel: ``(Cout, C, kh, kw)``; ``corr=False`` is the convolution
        orientation (SignalConv's synthesis default).

    Returns the output's shards, ``(N, su H / n, su W, Cout)`` each.
    """
    su = _pair(strides_up)
    support = tuple(kernel.shape[2:])
    # The padding follows the original orientation (signal_conv takes
    # "same" padding from corr, then flips the kernel).
    pad = same_padding_for_kernel(support, corr)
    weight = kernel if corr else torch.flip(kernel, (2, 3))
    lo = [p[0] for p in pad]
    shards = as_shards(x, mesh, axis)
    w = shards[0].shape[2]
    pk, mlo, M = phase_kernel(weight, su, lo)
    h_lo, h_hi = -mlo[0], M[0] - 1 + mlo[0]
    w_pad = (-mlo[1], w - 1 + mlo[1] + M[1] - w)
    h_loc = shards[0].shape[1]
    if h_loc < max(h_lo, h_hi):
        raise ValueError(f"shard height {h_loc} smaller than the halo ({h_lo}, {h_hi})")
    cout = kernel.shape[0]
    out = []
    for xp in _with_halo(shards, h_lo, h_hi):
        y = conv_nhwc(xp, pk.to(xp.device), ((0, 0), w_pad), (1, 1))
        nb, q0, q1 = y.shape[:3]
        y = y.reshape(nb, q0, q1, su[0], su[1], cout).permute(0, 1, 3, 2, 4, 5)
        out.append(y.reshape(nb, q0 * su[0], q1 * su[1], cout))
    return out


def _halo_conv(conv: SignalConv2D, x, mesh: Mesh, axis: str = "data") -> Shards:
    """A ``SignalConv2D`` module's convolution, without its bias and
    activation, with H sharded: a down-convolution through
    :func:`sharded_signal_conv2d`, an up-convolution through
    :func:`sharded_signal_conv2d_up`."""
    if (conv.padding != "same_zeros" or conv.channel_separable
            or not conv.extra_pad_end):
        raise ValueError("sharded convolutions take same_zeros padding, a dense "
                         "kernel and extra_pad_end")
    kernel = conv.kernel()
    if any(s > 1 for s in conv.strides_up):
        if any(s > 1 for s in conv.strides_down):
            raise ValueError("a sharded convolution either up- or down-samples")
        return sharded_signal_conv2d_up(x, kernel, mesh, axis, conv.corr, conv.strides_up)
    return sharded_signal_conv2d(x, kernel, mesh, axis, conv.corr, conv.strides_down)


def sharded_conv(conv: SignalConv2D, x, mesh: Mesh, axis: str = "data") -> Shards:
    """A ``SignalConv2D`` module (its kernel, bias and activation) with H
    sharded: :func:`_halo_conv`, then the bias and the activation."""
    shards = _halo_conv(conv, x, mesh, axis)
    if conv.bias is not None:
        shards = [s + conv.bias.to(s.device) for s in shards]
    if conv.activation is not None:
        shards = [conv.activation(s) for s in shards]
    return shards


def sharded_transform_apply(module: nn.Module, x, mesh: Mesh,
                            axis: str = "data") -> Shards:
    """Runs a codec transform (a stack whose forward applies its children
    in order: ``SignalConv2D``\\ s with their bias and activation, and GDN
    or IGDN) with H sharded over the mesh: each convolution exchanges
    halos, each GDN runs on every shard. The analysis, synthesis, hyper and
    slice transforms of every family are such stacks.

    Returns the output's shards."""
    for name, child in module.named_children():
        if not isinstance(child, (SignalConv2D, GDN)):
            raise TypeError(f"{name}: a sharded transform holds SignalConv2D and "
                            f"GDN layers, not {type(child).__name__}")
    shards = as_shards(x, mesh, axis)
    replicas = Replicas(module, mesh.devices)
    for child in module.children():
        if isinstance(child, SignalConv2D):
            shards = sharded_conv(child, shards, mesh, axis)
        else:
            shards = replicas.map(child, shards)
    return shards
