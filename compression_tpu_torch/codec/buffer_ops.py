"""Range coding over fixed-capacity buffers (counterpart of
``compression_tpu/codec/jax_ops.py``'s ``make_jax_encoder`` and
``make_jax_decoder``).

The JAX package calls the host range coder from inside a jitted program
through ``jax.pure_callback``, so its bitstreams travel as fixed-shape
arrays: encode returns ``(data uint8[batch, capacity], lengths
int32[batch])`` rather than variable-length strings. These are the same
two functions over the port's copy of the host coder
(:mod:`compression_tpu_torch.codec.host`), on torch tensors or NumPy
arrays; their bytes are ``host.entropy_encode``'s. The port's
single-program decode (``bmshj2018.Codec.decompress_batch_jit``) needs no
fixed shapes on the host, and decodes the strings as they are.

The CDF tables are host NumPy and never move to the device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from compression_tpu_torch.codec import host

__all__ = ["make_buffer_encoder", "make_buffer_decoder"]


def _host_array(a, dtype) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(a, dtype)


def _like(a: np.ndarray, ref) -> torch.Tensor:
    """``a`` as a tensor on ``ref``'s device (the CPU for a NumPy ``ref``)."""
    t = torch.from_numpy(a)
    return t.to(ref.device) if isinstance(ref, torch.Tensor) else t


def _pack_strings(strings, cap: int) -> Tuple[np.ndarray, np.ndarray]:
    """Byte strings -> ``(data uint8[n, cap], lengths int32[n])``, each
    string zero-padded to ``cap``; raises ValueError for one longer."""
    data = np.zeros((len(strings), cap), np.uint8)
    lengths = np.zeros((len(strings),), np.int32)
    for i, s in enumerate(strings):
        if len(s) > cap:
            raise ValueError(f"stream {i} ({len(s)}B) exceeds capacity {cap}B")
        data[i, : len(s)] = np.frombuffer(s, np.uint8)
        lengths[i] = len(s)
    return data, lengths


def make_buffer_encoder(tables, capacity_per_symbol: int | None = None):
    """Builds ``encode(symbols, indexes) -> (data, lengths)``.

    Args:
      tables: prebuilt CDF tables (``CdfTables``).
      capacity_per_symbol: output buffer bytes per symbol; None (default)
        uses :func:`~compression_tpu_torch.codec.host.encode_capacity`, the
        one source of the worst-case escape bound.

    The returned function takes int32 ``symbols``/``indexes`` of shape
    ``(batch, n)`` (tensors or arrays) and returns ``data: uint8[batch,
    cap]`` and ``lengths: int32[batch]`` as tensors, on the symbols' device
    (the CPU for arrays). A stream longer than ``cap`` raises ValueError.
    """

    def cap_for(n: int) -> int:
        if capacity_per_symbol is None:
            return host.encode_capacity(int(n), tables.precision)
        return capacity_per_symbol * int(n) + 64

    def encode(symbols, indexes) -> Tuple[torch.Tensor, torch.Tensor]:
        values = _host_array(symbols, np.int32)
        strings = host.entropy_encode(
            values, _host_array(indexes, np.int32), tables.cdf,
            tables.cdf_length, tables.cdf_offset, tables.precision,
        )
        data, lengths = _pack_strings(strings, cap_for(values.shape[1]))
        return _like(data, symbols), _like(lengths, symbols)

    return encode


def make_buffer_decoder(tables):
    """Builds ``decode(data, lengths, indexes) -> values``.

    ``data: uint8[batch, cap]``, ``lengths: int32[batch]``, ``indexes:
    int32[batch, n]`` (tensors or arrays) -> ``values: int32[batch, n]``, a
    tensor on the indexes' device (the CPU for arrays).
    """

    def decode(data, lengths, indexes) -> torch.Tensor:
        data = _host_array(data, np.uint8)
        lengths = _host_array(lengths, np.int64)
        idx = _host_array(indexes, np.int32)
        strings = [data[i, : lengths[i]].tobytes() for i in range(data.shape[0])]
        values = host.entropy_decode(
            strings, idx, tables.cdf, tables.cdf_length, tables.cdf_offset,
            tables.precision,
        )
        return _like(np.asarray(values, np.int32).reshape(idx.shape), indexes)

    return decode
