"""Blob formats of the hyperprior codecs and the device coder's plumbing
(counterpart of ``compression_tpu/models/device_coding.py``).

Host-coded blobs hold 4 fields ``[y_string, z_string, xshape, zshape]``;
device-coded (rANS) blobs hold 5, ``[y_words, z_string, xshape, zshape,
[K]]``, so a decoder tells them apart by the field count. ms2020 codes one
y stream a channel slice: its blobs hold ``num_slices + 3`` and
``num_slices + 4`` fields, read by the same parser. The y stream of
a device-coded blob is K-lane rANS (:mod:`compression_tpu_torch.codec.rans`),
coded on the card; only its compressed words cross to the host.

The hyperprior codecs (bmshj2018, mbt2018, HiFiC) share the
device-coded stages here, duck-typed against the codec as in the JAX
package: z factorized, y coded as ``round(y - mu)`` (``round(y)`` without a
mean) against sigma-indexed rows. A codec has
``cfg.downscale``, ``timer``, ``em``, ``side_em``, ``_front`` (uint8 images
on the device -> y, z symbols, z_hat), ``_mu_rows`` (z_hat -> mu or None,
rows; the one function encode and decode both call), ``_center_round``,
``_apply_loc``, ``_synthesize``, ``_pack`` and the copy helpers of
:class:`~compression_tpu_torch.models.codec_base.DeviceCodec`. Each stage
returns or takes a :class:`~compression_tpu_torch.parallel.pipeline.Work`.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from compression_tpu_torch.parallel.pipeline import Work
from compression_tpu_torch.util import PackedTensors
from compression_tpu_torch.util.image import pad_to_multiple_np
from compression_tpu_torch.util.profiling import span

__all__ = [
    "rans_for",
    "num_fields",
    "is_device_coded",
    "parse_blobs",
    "parse_host_blobs",
    "parse_device_blobs",
    "fetch_streams",
    "pad_words",
    "StreamOverflow",
    "encode_symbols",
    "dispatch_encode_rans",
    "rans_work",
    "finish_encode_rans",
    "dispatch_decode_rans",
    "finish_decode_rans",
    "decompress_batch_rans",
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


def num_fields(blob: bytes) -> int:
    """The tensors a blob holds (its model name aside)."""
    return len([k for k, *_ in PackedTensors(blob).describe() if k != "MD"])


def is_device_coded(blob: bytes, num_streams: int = 1) -> bool:
    """Whether a blob of a codec with ``num_streams`` y streams a blob is
    the device coder's (``num_streams + 4`` fields, the host coder's has
    ``num_streams + 3``)."""
    return num_fields(blob) == num_streams + 4


def parse_blobs(blobs: List[bytes], num_streams: int = 1, device: bool = False):
    """Unpacks one coder's blobs ``[y streams..., z_string, xshape, zshape]``
    (``+ [K]`` for the device coder) with format/size-uniformity validation:
    a lockstep batched decode cannot mix coder formats, image sizes or K.
    Returns ``(streams, z_strings, xshape, zshape, K)``, ``streams[i][b]``
    the i-th y stream of blob b (bytes; uint16 words for the device coder),
    K None for the host coder."""
    streams: List[list] = [[] for _ in range(num_streams)]
    z_strings = []
    xshape = zshape = K = None
    for b, blob in enumerate(blobs):
        if is_device_coded(blob, num_streams) != device:
            raise ValueError(
                f"blob {b} is {'host' if device else 'device'}-coded; a batched "
                "decode cannot mix host- and device-coded bitstreams"
            )
        fields = PackedTensors(blob).unpack(
            [object] * (num_streams + 1) + [np.int32] * (3 if device else 2))
        for i in range(num_streams):
            data = bytes(fields[i][0])
            streams[i].append(np.frombuffer(data, np.uint16) if device else data)
        z_strings.append(bytes(fields[num_streams][0]))
        xs, zsh = fields[num_streams + 1], fields[num_streams + 2]
        kk = int(fields[num_streams + 3][0]) if device else None
        if xshape is not None and not (
            np.array_equal(xshape, xs) and np.array_equal(zshape, zsh) and K == kk
        ):
            what = (f"shape/K {tuple(xs)}/{kk} vs {tuple(xshape)}/{K}" if device
                    else f"shape {tuple(xs)} vs {tuple(xshape)}")
            raise ValueError(
                f"batched decode requires same-size blobs: blob {b} has {what}; "
                "decode mixed sizes one by one"
            )
        xshape, zshape, K = xs, zsh, kk
    return streams, z_strings, xshape, zshape, K


def parse_host_blobs(blobs: List[bytes]):
    """Unpacks host-coded 4-field blobs (see :func:`parse_blobs`). Returns
    ``(y_strings, z_strings, xshape, zshape)``."""
    streams, z_strings, xshape, zshape, _ = parse_blobs(blobs)
    return streams[0], z_strings, xshape, zshape


def parse_device_blobs(blobs: List[bytes]):
    """Unpacks device-coded 5-field blobs (see :func:`parse_blobs`). Returns
    ``(y_words, z_strings, xshape, zshape, K)``, ``y_words`` as uint16
    arrays."""
    streams, z_strings, xshape, zshape, K = parse_blobs(blobs, device=True)
    return streams[0], z_strings, xshape, zshape, K


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


class StreamOverflow(ValueError):
    """A batch's rANS stream outgrew its capacity (the encoder's flag)."""


def encode_symbols(codec, images: np.ndarray):
    """Pads and uploads uint8 images and enqueues the encode chain on the
    device: ``(y symbols, z symbols, CDF rows, (H, W))``, the y symbols
    ``round(y - mu)`` for a mean-scale codec (``_front``'s rounded y where
    ``_mu_rows`` gives no mu). Both coders' encode stages start here."""
    x, hw = pad_to_multiple_np(np.asarray(images, np.uint8), codec.cfg.downscale)
    y, z_sym, z_hat = codec._front(codec._to_device(x))
    mu, rows = codec._mu_rows(z_hat)
    return (y if mu is None else codec._center_round(y, mu)), z_sym, rows, hw


def dispatch_encode_rans(codec, images: np.ndarray):
    """Device stage: the encode chain and K3, all enqueued on the codec's
    stream; the lengths, overflow flags and z symbols start their copies to
    the host (z as int16 where it fits). Returns without waiting; the work
    keeps the device symbols ``sym``, ``z_sym`` and ``rows`` (a codec may
    code an overflowed batch with the host coder)."""
    with codec.timer.stage("enc/dispatch"):
        sym, z_sym, rows, hw = encode_symbols(codec, images)
        n = sym.shape[0]
        enc, _dec, K, _cap = rans_for(codec, sym[0].numel())
        stream, lengths, overflow = enc(sym.reshape(n, -1), rows.reshape(n, -1))
        return rans_work(codec, [stream], [lengths], [overflow], z_sym, hw, K,
                         sym=sym, rows=rows)


def rans_work(codec, streams, lengths, overflow, z_sym, hw, K, **fields) -> Work:
    """The device coder's in-flight encode: ``streams`` ([n, cap] words, one
    tensor for each y stream of a blob) stay on the device; their lengths
    and overflow flags and the z symbols (int16 where they fit) start their
    copies to the host, then an event."""
    return Work(
        streams=streams, lengths=codec._to_host(torch.stack(lengths)),
        overflow=codec._to_host(torch.stack(overflow)),
        z16=codec._to_host(z_sym.to(torch.int16)),
        fit16=codec._to_host(torch.all(torch.abs(z_sym) <= 32767)),
        event=codec._event(), hw=hw, K=K, z_sym=z_sym, **fields,
    )


def finish_encode_rans(codec, w) -> List[bytes]:
    """Host stage: wait, raise :class:`StreamOverflow` on an overflowed
    stream (as the JAX package's mean-scale codecs do), range-code z, fetch
    the y words (one copy for each stream), pack the blobs (``[K]`` last)."""
    with codec.timer.stage("enc/fetch"):
        if w.event is not None:
            with span("wait/device"):
                w.event.synchronize()
        lengths, overflow = w.lengths.cpu().numpy(), w.overflow.cpu().numpy()
        z_sym = (w.z16 if bool(w.fit16) else w.z_sym).cpu().numpy().astype(np.int32)
    if overflow.any():
        raise StreamOverflow(
            "rANS stream capacity exceeded (pathological symbol statistics); "
            "use the host coder for this input"
        )
    with codec.timer.stage("enc/code_z"):
        z_strings = codec.side_em.compress_symbols(z_sym)
    with codec.timer.stage("enc/fetch_stream"):
        streams = [fetch_streams(s, lens) for s, lens in zip(w.streams, lengths)]
    with codec.timer.stage("enc/pack"):
        return codec._pack(list(zip(*streams)), z_strings, w.hw, z_sym.shape[1:3], w.K)


def dispatch_decode_rans(codec, blobs: List[bytes]):
    """Parse 5-field blobs, host-decode z, then enqueue z_hat -> (mu, rows),
    K2, ``values + mu``, the synthesis and the copies of the image and the
    ok flags to the host."""
    with codec.timer.stage("dec/parse"):
        y_words, z_strings, xshape, zshape, K = parse_device_blobs(blobs)
    with codec.timer.stage("dec/code_z"):
        z_hat = codec.side_em.decompress(z_strings, tuple(int(v) for v in zshape))
    with codec.timer.stage("dec/dispatch"):
        mu, rows = codec._mu_rows(codec._to_device(z_hat))
        n = len(blobs)
        _enc, dec, _K, _cap = rans_for(codec, rows[0].numel(), K)
        values, ok = dec(codec._to_device(pad_words(y_words)), rows.reshape(n, -1))
        image = codec._synthesize(codec._apply_loc(values.reshape(rows.shape), mu))
        return Work(coder="device", image=codec._to_host(image),
                    ok=codec._to_host(ok), event=codec._event(), xshape=xshape)


def finish_decode_rans(codec, w) -> np.ndarray:
    """Host stage: wait for the image; raise on a bad final rANS state."""
    with codec.timer.stage("dec/fetch_image"):
        if w.event is not None:
            with span("wait/device"):
                w.event.synchronize()
        image, ok = w.image.numpy(), w.ok.cpu().numpy()
    if not ok.all():
        raise ValueError("corrupt device-coded bitstream (rANS state)")
    return image[:, : int(w.xshape[0]), : int(w.xshape[1]), :]


def decompress_batch_rans(codec, blobs: List[bytes]) -> np.ndarray:
    """Decodes same-size device-coded blobs as one batch."""
    return finish_decode_rans(codec, dispatch_decode_rans(codec, blobs))
