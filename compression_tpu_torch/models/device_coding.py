"""Blob formats of the hyperprior codecs and the device coder's plumbing
(counterpart of ``compression_tpu/models/device_coding.py``).

Host-coded blobs hold 4 fields ``[y_string, z_string, xshape, zshape]``;
device-coded (rANS) blobs hold 5, ``[y_words, z_string, xshape, zshape,
[K]]``, so a decoder tells them apart by the field count. The y stream of
a device-coded blob is K-lane rANS (:mod:`compression_tpu_torch.codec.rans`),
coded on the card; only its compressed words cross to the host.

Not ported yet: the duck-typed ``dispatch_encode_rans`` /
``finish_encode_rans`` / ``decompress_batch_rans`` that the mean-scale
codecs (mbt2018, HiFiC) share; their first user is the mbt2018 port.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from compression_tpu_torch.util import PackedTensors

__all__ = [
    "rans_for",
    "is_device_coded",
    "parse_host_blobs",
    "parse_device_blobs",
    "fetch_streams",
    "pad_words",
]


def rans_for(codec, N: int, K: int | None = None):
    """``(encode, decode, K, cap)`` for ``codec.em``'s tables and N
    elements an image, cached on the codec per (N, K).

    K defaults to the JAX package's rule: the largest power of two with
    ``K <= max(4, N // 16)``, capped by ``TPC_RANS_K`` (default 128, honoured
    down to 1). ``cap = 3N + 2K + 64`` words holds any stream (at most three
    words an element plus the 2K-word state flush)."""
    from compression_tpu_torch.codec import rans

    if not hasattr(codec, "_rans_cache"):
        codec._rans_cache = {}
    if K is None:
        cap_k = max(1, int(os.environ.get("TPC_RANS_K", "128")))
        k_fit = 1
        while k_fit * 2 <= max(4, N // 16) and k_fit * 2 <= cap_k:
            k_fit *= 2
        K = k_fit
    key = (N, K)
    if key not in codec._rans_cache:
        if getattr(codec, "_rans_tables", None) is None:
            codec._rans_tables = rans.RansTables(codec.em.tables)
        cap = 3 * N + 2 * K + 64
        codec._rans_cache[key] = (
            rans.make_rans_encoder(codec._rans_tables, K, cap),
            rans.make_rans_decoder(codec._rans_tables, K, N),
            K,
            cap,
        )
    return codec._rans_cache[key]


def is_device_coded(blob: bytes) -> bool:
    packed = PackedTensors(blob)
    return len([k for k, *_ in packed.describe() if k != "MD"]) == 5


def parse_host_blobs(blobs: List[bytes]):
    """Unpacks host-coded 4-field blobs with format/size-uniformity
    validation (a lockstep batched decode cannot mix coder formats or image
    sizes). Returns ``(y_strings, z_strings, xshape, zshape)``."""
    y_strings, z_strings = [], []
    xshape = zshape = None
    for b, blob in enumerate(blobs):
        if is_device_coded(blob):
            raise ValueError(
                f"blob {b} is device-coded; a batched decode cannot mix "
                "host- and device-coded bitstreams"
            )
        packed = PackedTensors(blob)
        ys, zs, xs, zsh = packed.unpack([object, object, np.int32, np.int32])
        y_strings.append(bytes(ys[0]))
        z_strings.append(bytes(zs[0]))
        if xshape is not None and not (
            np.array_equal(xshape, xs) and np.array_equal(zshape, zsh)
        ):
            raise ValueError(
                "batched decode requires same-size blobs: blob "
                f"{b} has shape {tuple(xs)} vs {tuple(xshape)}; "
                "decode mixed sizes one by one"
            )
        xshape, zshape = xs, zsh
    return y_strings, z_strings, xshape, zshape


def parse_device_blobs(blobs: List[bytes]):
    """Unpacks device-coded 5-field blobs with the same validation, plus one
    K for the batch. Returns ``(y_words, z_strings, xshape, zshape, K)``,
    ``y_words`` as uint16 arrays."""
    y_words, z_strings = [], []
    xshape = zshape = None
    K = None
    for b, blob in enumerate(blobs):
        if not is_device_coded(blob):
            raise ValueError(
                f"blob {b} is host-coded; a batched decode cannot mix "
                "host- and device-coded bitstreams"
            )
        packed = PackedTensors(blob)
        ys, zs, xs, zsh, kk = packed.unpack(
            [object, object, np.int32, np.int32, np.int32]
        )
        y_words.append(np.frombuffer(bytes(ys[0]), np.uint16))
        z_strings.append(bytes(zs[0]))
        if xshape is not None and not (
            np.array_equal(xshape, xs)
            and np.array_equal(zshape, zsh)
            and K == int(kk[0])
        ):
            raise ValueError(
                "batched decode requires same-size blobs: blob "
                f"{b} has shape/K {tuple(xs)}/{int(kk[0])} vs "
                f"{tuple(xshape)}/{K}; decode mixed sizes one by one"
            )
        xshape, zshape, K = xs, zsh, int(kk[0])
    return y_words, z_strings, xshape, zshape, K


def fetch_streams(stream: torch.Tensor, lengths) -> List[bytes]:
    """Fetches per-image rANS word streams in ONE device-to-host copy.

    ``stream`` is the [n, cap] buffer, ``lengths`` the (already fetched)
    per-image word counts. The copy covers ``[n, max(lengths)]``, a few
    tens of percent more words than the streams hold, in one transfer
    instead of n; on the card it is non-blocking into pinned memory and
    waited for with an event."""
    lengths = np.asarray(lengths)
    n = stream.shape[0]
    max_len = int(lengths.max()) if n else 0
    part = stream[:, :max_len]
    if stream.device.type == "cuda":
        host = torch.empty((n, max_len), dtype=stream.dtype, pin_memory=True)
        host.copy_(part, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
    else:
        host = part
    flat = host.numpy()
    return [flat[b, : int(lengths[b])].tobytes() for b in range(n)]


def pad_words(word_lists) -> np.ndarray:
    """Pads per-image u16 rANS word streams into one [n, cap] array, cap
    rounded up to a power of two (at least 1024) so that varying stream
    lengths reuse a handful of buffer shapes."""
    cap = 1024
    longest = max(len(w) for w in word_lists)
    while cap < longest:
        cap *= 2
    out = np.zeros((len(word_lists), cap), np.uint16)
    for b, w in enumerate(word_lists):
        out[b, : len(w)] = w
    return out
