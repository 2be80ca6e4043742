"""Host-side (NumPy in, NumPy out) codec API over the native library
(counterpart of ``compression_tpu/codec/host.py``).

Symbols and CDF rows are computed on the device, fetched, and coded here
with one multi-threaded native call per batch.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from compression_tpu_torch.codec import binding

__all__ = [
    "encode_capacity",
    "entropy_encode",
    "entropy_decode",
    "pmf_to_quantized_cdf",
    "run_length_gamma_encode",
    "run_length_gamma_decode",
]


def encode_capacity(n: int, precision: int) -> int:
    """Safe per-stream output capacity for n symbols: the escape symbol at
    minimum frequency (<= 16 bits) plus the Elias-gamma code of a zigzagged
    int32 (<= 65 bits) is ~10.2 bytes; 12 bytes a symbol leaves margin, and
    the C++ side still returns a capacity error rather than overflowing."""
    del precision
    return 12 * int(n) + 64


def entropy_encode(
    values: np.ndarray,
    indexes: np.ndarray,
    cdfs: np.ndarray,
    cdf_lengths: np.ndarray,
    cdf_offsets: np.ndarray,
    precision: int,
    num_threads: int | None = None,
) -> List[bytes]:
    """Encodes a batch of streams.

    Args:
      values: int32 [B, n] (or [n] for one stream) integer symbol values
        (the CDF row's offset is applied inside).
      indexes: int32, same shape; CDF row per element.
      cdfs: int32 [num_cdfs, max_len]; cdf_lengths/cdf_offsets: [num_cdfs].

    Returns:
      list of B byte strings.
    """
    lib = binding.get_lib()
    values = np.ascontiguousarray(values, np.int32)
    indexes = np.ascontiguousarray(np.broadcast_to(indexes, values.shape), np.int32)
    single = values.ndim == 1
    if single:
        values, indexes = values[None], indexes[None]
    batch, n = values.shape[0], int(np.prod(values.shape[1:], dtype=np.int64))
    values = values.reshape(batch, n)
    indexes = indexes.reshape(batch, n)
    cdfs = np.ascontiguousarray(cdfs, np.int32)
    cdf_lengths = np.ascontiguousarray(cdf_lengths, np.int32)
    cdf_offsets = np.ascontiguousarray(cdf_offsets, np.int32)
    cap = encode_capacity(n, precision)
    out = np.empty((batch, cap), np.uint8)
    out_lens = np.zeros((batch,), np.int64)
    rc = lib.tpc_entropy_encode(
        binding._ptr(values, binding._i32p),
        binding._ptr(indexes, binding._i32p),
        batch, n,
        binding._ptr(cdfs, binding._i32p),
        binding._ptr(cdf_lengths, binding._i32p),
        binding._ptr(cdf_offsets, binding._i32p),
        cdfs.shape[0], cdfs.shape[1], precision,
        binding._ptr(out, binding._u8p), cap,
        binding._ptr(out_lens, binding._i64p),
        num_threads or binding.default_num_threads(),
    )
    binding._check(rc)
    return [out[b, : out_lens[b]].tobytes() for b in range(batch)]


def entropy_decode(
    strings: Sequence[bytes],
    indexes: np.ndarray,
    cdfs: np.ndarray,
    cdf_lengths: np.ndarray,
    cdf_offsets: np.ndarray,
    precision: int,
    num_threads: int | None = None,
) -> np.ndarray:
    """Decodes a batch of streams back to int32 values, shaped like indexes."""
    lib = binding.get_lib()
    indexes = np.ascontiguousarray(indexes, np.int32)
    single = indexes.ndim == 1
    idx = indexes[None] if single else indexes
    batch = idx.shape[0]
    n = int(np.prod(idx.shape[1:], dtype=np.int64))
    idx2 = idx.reshape(batch, n)
    if len(strings) != batch:
        raise ValueError(f"got {len(strings)} strings for batch {batch}")
    cap = max(max((len(s) for s in strings), default=1), 1)
    buf = np.zeros((batch, cap), np.uint8)
    in_lens = np.zeros((batch,), np.int64)
    for b, s in enumerate(strings):
        buf[b, : len(s)] = np.frombuffer(s, np.uint8)
        in_lens[b] = len(s)
    cdfs = np.ascontiguousarray(cdfs, np.int32)
    cdf_lengths = np.ascontiguousarray(cdf_lengths, np.int32)
    cdf_offsets = np.ascontiguousarray(cdf_offsets, np.int32)
    values = np.zeros((batch, n), np.int32)
    rc = lib.tpc_entropy_decode(
        binding._ptr(buf, binding._u8p),
        binding._ptr(in_lens, binding._i64p),
        batch, cap, n,
        binding._ptr(idx2, binding._i32p),
        binding._ptr(cdfs, binding._i32p),
        binding._ptr(cdf_lengths, binding._i32p),
        binding._ptr(cdf_offsets, binding._i32p),
        cdfs.shape[0], cdfs.shape[1], precision,
        binding._ptr(values, binding._i32p),
        num_threads or binding.default_num_threads(),
    )
    binding._check(rc)
    values = values.reshape(idx.shape)
    return values[0] if single else values


def pmf_to_quantized_cdf(
    pmf: np.ndarray,
    pmf_lengths: np.ndarray,
    precision: int,
    num_threads: int | None = None,
) -> np.ndarray:
    """Quantizes float64 PMF rows [num, max_len] (valid lengths in
    ``pmf_lengths``) to int32 CDF rows [num, max_len + 1]."""
    lib = binding.get_lib()
    pmf = np.ascontiguousarray(pmf, np.float64)
    if pmf.ndim == 1:
        pmf = pmf[None]
    pmf_lengths = np.ascontiguousarray(pmf_lengths, np.int32)
    num, max_len = pmf.shape
    cdf = np.zeros((num, max_len + 1), np.int32)
    rc = lib.tpc_pmf_to_quantized_cdf(
        binding._ptr(pmf, binding._f64p), num, max_len,
        binding._ptr(pmf_lengths, binding._i32p), precision,
        binding._ptr(cdf, binding._i32p),
        num_threads or binding.default_num_threads(),
    )
    binding._check(rc)
    return cdf


def run_length_gamma_encode(values: np.ndarray) -> bytes:
    """Run-length + Elias-gamma code of a sparse int32 array (flattened),
    the power-law entropy model's coder."""
    lib = binding.get_lib()
    values = np.ascontiguousarray(values, np.int32).ravel()
    cap = 16 * values.size + 64
    out = np.empty((cap,), np.uint8)
    out_len = np.zeros((1,), np.int64)
    rc = lib.tpc_run_length_gamma_encode(
        binding._ptr(values, binding._i32p), values.size,
        binding._ptr(out, binding._u8p), cap,
        binding._ptr(out_len, binding._i64p),
    )
    binding._check(rc)
    return out[: out_len[0]].tobytes()


def run_length_gamma_decode(data: bytes, shape: Tuple[int, ...]) -> np.ndarray:
    """Inverse of :func:`run_length_gamma_encode`: int32 values of ``shape``."""
    lib = binding.get_lib()
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    buf = np.frombuffer(data, np.uint8)
    values = np.zeros((n,), np.int32)
    rc = lib.tpc_run_length_gamma_decode(
        binding._ptr(buf, binding._u8p), buf.size, n,
        binding._ptr(values, binding._i32p),
    )
    binding._check(rc)
    return values.reshape(shape)
