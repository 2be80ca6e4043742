"""K2 and K3, the device entropy coder: K-lane interleaved rANS, as
hand-written CUDA kernels and their plain PyTorch twins.

Counterpart of ``compression_tpu/codec/rans.py``, whose coder is an XLA
``lax.scan`` (K3 ``make_rans_encoder`` :178, scan :230; K2
``make_rans_decoder`` :257, scan :337). The format is specified by
:mod:`compression_tpu_torch.codec.rans_ref`; streams are bit-identical to
the JAX package's, so blobs cross between the packages.

Shapes are batched: ``encode(values i32[B, N], rows[B, N]) -> (stream
u16[B, cap], lengths i32[B], overflow bool[B])`` and ``decode(stream
u16[B, cap'], rows[B, N]) -> (values i32[B, N], ok bool[B])``; lanes split
each image as lane = j mod K. ``rows`` may be int32 or the uint8 that
``LocationScaleIndexedEntropyModel.rows`` returns.

* :func:`rans_encode` / :func:`rans_decode` launch ``csrc/rans.cu`` for CUDA
  tensors (or raise), and run the twins :func:`rans_encode_reference` /
  :func:`rans_decode_reference` for CPU tensors. There is no fallback
  between the two. ``rans_encode.launches`` / ``rans_decode.launches``
  count kernel launches.
* The twins follow the scan bodies step for step, vectorised over
  ``[B, K]`` with a Python loop over the T steps; u32 arithmetic is done in
  int64 and masked. The decoder's escape pops run masked on every step
  (the JAX package skips them under ``lax.cond``; the result is the same).

Bound on an H100: the serial chain of T = ceil(N / K) dependent steps, not
bytes or operations (see the note at the top of ``csrc/rans.cu``). K3 is
two launches: the elements' fields over the whole card, then one CTA an
image whose lanes run independently (no barrier in the lane loop) and
whose words are placed afterwards by a scan of per-step counts; its floor
is T times the state update. K2 spreads an image's K lanes over 4 warps
(16 past 128 lanes) with the tables, the rows and the stream in shared
memory; its floor is T times a chain of four shared-memory loads, a
ballot, a named barrier and a state update. K stays 128: it is in the blob
and the JAX package picks it, so raising it would change the bitstream.

Tables: :class:`RansTables` also builds the kernels' table blob (row info,
f|c stored ragged with a sentinel per row, and per-row slot buckets).
:func:`decode_variant` says whether K2 holds it in shared memory
("on_chip") or reads it through L1 ("global", for tables over the budget);
``rans_decode.variant_launches`` counts launches of each. K3 reads its
part (row info and f|c) through L1, in a pass of its own over all
elements.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from compression_tpu_torch.codec.rans_ref import build_slot_table
from compression_tpu_torch.util import cuda_build
from compression_tpu_torch.util.graphs import count_launch

__all__ = [
    "RansTables",
    "make_rans_encoder",
    "make_rans_decoder",
    "rans_encode",
    "rans_decode",
    "rans_encode_reference",
    "rans_decode_reference",
    "decode_variant",
    "build",
]

_SOURCE = "rans.cu"
_MAX_LANES = 1024  # the lanes of one image are coded by one CTA
_L = 1 << 16
_M16 = 0xFFFF
_M32 = 0xFFFFFFFF
# Must agree with csrc/rans.cu: K2's shared memory is 512 bytes of flags,
# barriers and per-step counts, a ring of 8,192 stream words and four
# 8,192-byte slots of rows, plus the table blob in the on-chip variant,
# within the 232,448 bytes a block may use. Buckets hold 2^3 slots: 2^2
# does not fit the checkpoint's tables on chip, and 2^4 decodes slower
# (chip_smoke.py phase 3 times both; PERF.md section 6).
_DEC_FIXED_SMEM = 512 + 2 * 8192 + 4 * 8192
_MAX_SMEM = 232448
_BUCKET_BITS = 3

_count_lock = threading.Lock()


def _round4(words: int) -> int:
    return -(-words // 4) * 4


def _well_formed(cdf, cdf_length, precision) -> bool:
    """Rows the kernels' ragged tables represent exactly: each starts at 0,
    rises to 2^P at its last entry, and has 1 .. 65,535 symbols."""
    maxlen = cdf.shape[1]
    for r, n in enumerate(np.asarray(cdf_length, np.int64)):
        row = cdf[r, :n]
        if not (2 <= n <= maxlen and n - 1 <= 0xFFFF and row[0] == 0
                and row[-1] == 1 << precision and np.all(np.diff(row) >= 0)):
            return False
    return True


class RansTables:
    """The coder's table bundle, derived from a ``CdfTables``.

    ``fc[r, m] = f << 16 | c`` packs a symbol's frequency and cumulative
    frequency in one int32 (one gather instead of two; lossless for
    precision <= 15, checked here). ``slot2sym[r, slot]`` maps a state's
    low P bits to the symbol; ``escape[r] = cdf_length[r] - 2`` is the
    escape symbol; ``cdf_offset[r]`` shifts symbols to values. All int32,
    on the CPU; :meth:`on` returns (and caches) a copy on another device.

    ``blob`` (int32, 16-byte padded) is the kernels' form of the same
    tables, as ``csrc/rans.cu`` reads it:

    * words ``[0, 4R)``: per row ``(fc start, escape, cdf_offset, bucket
      base)``;
    * from ``fc_words``: per row its ``cdf_length - 1`` entries of ``fc``,
      then a sentinel ``1 << P`` (c = 2^P, past every slot);
    * from ``bucket_words`` (uint16): per row ``2^(P - bucket_bits)``
      buckets, the symbol that holds slot ``i << bucket_bits``; a symbol is
      found from its bucket by a forward search while the next entry's c
      is at most the slot.

    ``table_bytes`` is the whole blob's size. ``blob`` is None where a row
    is not well formed (see :func:`_well_formed`); the kernels then refuse
    the tables.
    """

    def __init__(self, tables, bucket_bits: int = _BUCKET_BITS):
        self.precision = int(tables.precision)
        if self.precision > 15:
            raise ValueError(
                f"rANS fc-packing requires precision <= 15 (f must fit "
                f"16 bits); got {self.precision}"
            )
        cdf = np.asarray(tables.cdf)
        cdf_length = np.asarray(tables.cdf_length)
        f = cdf[:, 1:] - cdf[:, :-1]
        self.fc = torch.from_numpy(
            (f.astype(np.int32) << 16) | cdf[:, :-1].astype(np.int32))
        self.slot2sym = torch.from_numpy(
            build_slot_table(cdf, cdf_length, self.precision).astype(np.int32))
        self.cdf_offset = torch.from_numpy(
            np.asarray(tables.cdf_offset, np.int32).copy())
        self.escape = torch.from_numpy((cdf_length - 2).astype(np.int32))
        self.num_rows = int(cdf.shape[0])
        self.maxlen = int(cdf.shape[1])
        self.bucket_bits = min(int(bucket_bits), self.precision)
        self.blob = None
        if _well_formed(cdf, cdf_length, self.precision):
            self._build_blob(cdf_length)
        self.device = torch.device("cpu")
        self._copies = {self.device: self}

    def _build_blob(self, cdf_length) -> None:
        R, P, bb = self.num_rows, self.precision, self.bucket_bits
        syms = np.asarray(cdf_length, np.int64) - 1  # symbols a row, escape included
        starts = np.concatenate([[0], np.cumsum(syms + 1)[:-1]])
        nb = 1 << (P - bb)
        fc = self.fc.numpy()
        self.fc_words = 4 * R
        self.bucket_words = _round4(self.fc_words + int((syms + 1).sum()))
        words = _round4(self.bucket_words + -(-R * nb // 2))
        blob = np.zeros(words, np.int32)
        info = blob[: 4 * R].reshape(R, 4)
        info[:, 0] = starts
        info[:, 1] = self.escape.numpy()
        info[:, 2] = self.cdf_offset.numpy()
        info[:, 3] = np.arange(R) * nb
        fcr = blob[self.fc_words: self.bucket_words]
        for r in range(R):
            fcr[starts[r]: starts[r] + syms[r]] = fc[r, : syms[r]]
            fcr[starts[r] + syms[r]] = 1 << P
        buckets = self.slot2sym.numpy()[:, :: 1 << bb].astype(np.uint16)
        blob.view(np.uint16)[2 * self.bucket_words: 2 * self.bucket_words + R * nb] = (
            buckets.reshape(-1))
        self.blob = torch.from_numpy(blob)
        self.table_bytes = 4 * words

    def on(self, device) -> "RansTables":
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        copy = self._copies.get(device)
        if copy is None:
            copy = object.__new__(RansTables)
            copy.__dict__.update(self.__dict__)
            for name in ("fc", "slot2sym", "cdf_offset", "escape", "blob"):
                if getattr(self, name) is not None:
                    setattr(copy, name, getattr(self, name).to(device))
            copy.device = device
            self._copies[device] = copy
        return copy


def _tables(tables) -> RansTables:
    return tables if isinstance(tables, RansTables) else RansTables(tables)


def _blob_of(tables) -> RansTables:
    t = _tables(tables)
    if t.blob is None:
        raise ValueError("rANS tables: a row is not a well-formed quantized CDF")
    return t


def decode_variant(tables) -> str:
    """Which variant of K2 decodes with these tables: "on_chip" when the
    blob fits in shared memory beside the rings, else "global"."""
    t = _blob_of(tables)
    return "on_chip" if _DEC_FIXED_SMEM + t.table_bytes <= _MAX_SMEM else "global"


# -- plain PyTorch twins ----------------------------------------------------


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap (XLA's int32 overflow)."""
    return (((x + (1 << 31)) & _M32) - (1 << 31)).to(torch.int32)


def _pad_tk(x: torch.Tensor, T: int, K: int, fill) -> torch.Tensor:
    B, N = x.shape
    if T * K > N:
        x = torch.cat([x, torch.full((B, T * K - N), fill, dtype=x.dtype,
                                     device=x.device)], 1)
    return x.reshape(B, T, K)


def _row_fields(t: RansTables, rows: torch.Tensor):
    r = rows.long().clamp(0, t.num_rows - 1)
    return r, t.cdf_offset.long()[r], t.escape.long()[r]


def _freq_cum(t: RansTables, r, m):
    # fc as u32: at precision 15 a full-mass row's f = 2^15 sets bit 31.
    stride = t.maxlen - 1
    flat = (r * stride + m).clamp(0, t.num_rows * stride - 1)
    v = t.fc.reshape(-1).long()[flat] & _M32
    return v >> 16, v & _M16


def rans_encode_reference(tables, values: torch.Tensor, rows: torch.Tensor,
                          K: int, cap: int):
    """Plain twin of K3 (the scan of ``rans.py:183-252``)."""
    t = _tables(tables).on(values.device)
    P = t.precision
    B, N = values.shape
    T = -(-N // K)
    dev = values.device
    r, off, E = _row_fields(t, rows)
    s = _wrap_i32(values.long() - off).long()
    escaped = ~((s >= 0) & (s < E))
    m = torch.where(escaped, E, s)
    e = torch.where(s >= E, ((s - E) & _M32) * 2, ((-s) & _M32) * 2 - 1) & _M32
    f, c = _freq_cum(t, r, m)
    valid = torch.ones((B, N), dtype=torch.bool, device=dev)
    f, c, esc_all = _pad_tk(f, T, K, 1), _pad_tk(c, T, K, 0), _pad_tk(escaped, T, K, False)
    e_lo, e_hi = _pad_tk(e & _M16, T, K, 0), _pad_tk(e >> 16, T, K, 0)
    valid = _pad_tk(valid, T, K, False)

    x = torch.full((B, K), _L, dtype=torch.int64, device=dev)
    vals, masks = [], []
    for step in range(T - 1, -1, -1):
        ok = valid[:, step]
        esc = esc_all[:, step] & ok
        fs = f[:, step]
        v_hi = x & _M16
        x = torch.where(esc, ((x >> 16) << 16) | e_hi[:, step], x)
        v_lo = x & _M16
        x = torch.where(esc, ((x >> 16) << 16) | e_lo[:, step], x)
        # Renormalise before the push; the threshold is a shift of x, so a
        # full-mass row (f == 2^P) cannot wrap.
        em = ok & ((x >> (32 - P)) >= fs)
        v_m = x & _M16
        x1 = torch.where(em, x >> 16, x)
        fs = torch.where(ok, fs, 1).clamp_min(1)
        x2 = (((x1 // fs) << P) + x1 % fs + c[:, step]) & _M32
        x = torch.where(ok, x2, x)
        vals.append(torch.stack([v_hi, v_lo, v_m], 1))    # [B, 3, K]
        masks.append(torch.stack([esc, esc, em], 1))
    # Emission order: step descending, slot (hi, lo, main), lane
    # descending; then the flush (lanes K-1..0: lo, hi); reversed into
    # decode order by scattering word i to total-1-i.
    if T:
        vals_f = torch.stack(vals, 1).flip(-1).reshape(B, -1)
        masks_f = torch.stack(masks, 1).flip(-1).reshape(B, -1)
    else:
        vals_f = torch.zeros((B, 0), dtype=torch.int64, device=dev)
        masks_f = torch.zeros((B, 0), dtype=torch.bool, device=dev)
    xr = x.flip(1)
    flush = torch.stack([xr & _M16, xr >> 16], -1).reshape(B, 2 * K)
    vals_f = torch.cat([vals_f, flush], 1)
    masks_f = torch.cat([masks_f, torch.ones_like(flush, dtype=torch.bool)], 1)
    idx = torch.cumsum(masks_f.long(), 1) - 1
    total = idx[:, -1] + 1
    pos = total[:, None] - 1 - idx
    pos = torch.where(masks_f & (pos < cap), pos, cap)
    buf = torch.zeros((B, cap + 1), dtype=torch.int64, device=dev)
    buf.scatter_(1, pos, vals_f)
    return (buf[:, :cap].to(torch.uint16), total.to(torch.int32),
            total > cap)


def rans_decode_reference(tables, stream: torch.Tensor, rows: torch.Tensor,
                          K: int, N: int):
    """Plain twin of K2 (the scan of ``rans.py:263-340``)."""
    t = _tables(tables).on(stream.device)
    P = t.precision
    B, cap = stream.shape
    T = -(-N // K)
    dev = stream.device
    r, off, E = _row_fields(t, rows)
    valid = torch.ones((B, N), dtype=torch.bool, device=dev)
    r_t, E_t, valid_t = _pad_tk(r, T, K, 0), _pad_tk(E, T, K, 0), _pad_tk(valid, T, K, False)
    words = stream.long()
    head = words[:, : 2 * K].reshape(B, K, 2)
    x = (head[..., 0] << 16) | head[..., 1]
    p = torch.full((B,), 2 * K, dtype=torch.int64, device=dev)
    slot2sym = t.slot2sym.reshape(-1).long()
    pmask = (1 << P) - 1

    def read(x, p, need, renew):
        """Masked word read in ascending lane order."""
        n = need.long()
        idx = (p[:, None] + torch.cumsum(n, 1) - n).clamp(0, cap - 1)
        w = torch.gather(words, 1, idx)
        return torch.where(need, ((renew << 16) | w) & _M32, x), p + n.sum(1)

    out = []
    for step in range(T):
        rs, Es, ok = r_t[:, step], E_t[:, step], valid_t[:, step]
        slot = x & pmask
        m = slot2sym[(rs << P) + slot]
        f, c = _freq_cum(t, rs, m)
        x1 = (f * (x >> P) + slot - c) & _M32
        x, p = read(torch.where(ok, x1, x), p, ok & (x1 < _L), x1)
        esc = ok & (m == Es)
        b_lo = x & _M16
        x, p = read(x, p, esc, x >> 16)
        b_hi = x & _M16
        x, p = read(x, p, esc, x >> 16)
        e = (b_hi << 16) | b_lo
        s_esc = torch.where(e % 2 == 0, Es + (e >> 1), -((e >> 1) + 1))
        out.append(torch.where(esc, s_esc, m))
    ok = torch.all(x == _L, 1)
    if T:
        sym = torch.stack(out, 1).reshape(B, T * K)[:, :N]
    else:
        sym = torch.zeros((B, 0), dtype=torch.int64, device=dev)
    return _wrap_i32(_wrap_i32(sym).long() + off), ok


# -- the CUDA kernels ---------------------------------------------------------


def build():
    """Compiles ``csrc/rans.cu`` (if not built yet) and returns the library
    path; ptxas's report lands in ``cuda_build.build_logs["rans.cu"]``."""
    return cuda_build.build(_SOURCE)


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.tpc_rans_encode.restype = i
    lib.tpc_rans_encode.argtypes = [
        p, p, i, p, i, i, i, i, ll, i, ll, p, p, p, p, p, p, i, p,
    ]
    lib.tpc_rans_decode.restype = i
    lib.tpc_rans_decode.argtypes = [
        p, ll, p, i, p, i, i, i, i, i, i, i, i, ll, i, p, p, p,
    ]
    lib.tpc_rans_error_string.restype = ctypes.c_char_p
    lib.tpc_rans_error_string.argtypes = [i]


def _check(name, rc, lib):
    if rc != 0:
        msg = lib.tpc_rans_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({rc})")


def _check_rows(name, rows, B, N, device):
    if rows.dtype not in (torch.uint8, torch.int32):
        raise TypeError(f"{name}: rows must be uint8 or int32, got {rows.dtype}")
    if tuple(rows.shape) != (B, N):
        raise ValueError(f"{name}: rows {tuple(rows.shape)} must be {(B, N)}")
    if rows.device != device or not rows.is_contiguous():
        raise ValueError(f"{name}: rows must be contiguous on {device}")


def _check_lanes(name, K):
    if not 1 <= K <= _MAX_LANES:
        raise ValueError(f"{name}: K = {K} lanes unsupported (1..{_MAX_LANES})")


def _on_cuda(name, tensor):
    if tensor.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {tensor.device}")


def rans_encode(tables, values: torch.Tensor, rows: torch.Tensor, K: int,
                cap: int):
    """Encodes ``values`` i32[B, N] under CDF ``rows`` into K-lane rANS
    streams: ``(stream u16[B, cap], lengths i32[B], overflow bool[B])``.

    CPU tensors run :func:`rans_encode_reference`; CUDA tensors launch K3
    (two kernels: the elements' fields, then the lanes and the compaction;
    ``rans_encode.launches`` counts both), or raise if it cannot
    (unsupported shape, type or tables, build or launch failure)."""
    if values.device.type == "cpu":
        return rans_encode_reference(tables, values, rows, K, cap)
    _on_cuda("rans_encode", values)
    if values.dtype != torch.int32 or values.dim() != 2 or not values.is_contiguous():
        raise TypeError("rans_encode: values must be a contiguous int32 [B, N] tensor")
    B, N = values.shape
    _check_rows("rans_encode", rows, B, N, values.device)
    _check_lanes("rans_encode", K)
    if cap < 1:
        raise ValueError(f"rans_encode: cap = {cap} words")
    t = _blob_of(tables).on(values.device)
    dev = values.device
    # Zeros past the stream, as the JAX scatter leaves them: filled here over
    # the whole card; the kernel writes the stream.
    out = torch.zeros((B, cap), dtype=torch.uint16, device=dev)
    lengths = torch.empty((B,), dtype=torch.int32, device=dev)
    overflow = torch.empty((B,), dtype=torch.bool, device=dev)
    if B == 0:
        return out, lengths, overflow
    # Scratch: the elements' fields [B][N][2], the lane pass's candidate
    # words [B][T][3][K] and the warps' ballots (em, esc) [B][T][ceil(K / 32)].
    T = -(-N // K)
    fields = torch.empty((B, N, 2), dtype=torch.int32, device=dev)
    rec = torch.empty((B, T * 3 * K), dtype=torch.uint16, device=dev)
    flags = torch.empty((B, T * -(-K // 32), 2), dtype=torch.int32, device=dev)
    lib = cuda_build.load(_SOURCE, _declare)
    with torch.cuda.device(dev):
        rc = lib.tpc_rans_encode(
            values.data_ptr(), rows.data_ptr(), int(rows.dtype == torch.uint8),
            t.blob.data_ptr(), t.fc_words, t.num_rows, t.precision, B, N, K, cap,
            fields.data_ptr(), rec.data_ptr(), flags.data_ptr(), out.data_ptr(),
            lengths.data_ptr(), overflow.data_ptr(),
            torch.cuda.get_device_properties(dev).multi_processor_count,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _check("rans_encode", rc, lib)
    count_launch(rans_encode, 2 if N else 1)
    return out, lengths, overflow


def rans_decode(tables, stream: torch.Tensor, rows: torch.Tensor, K: int,
                N: int):
    """Decodes K-lane rANS streams u16[B, cap'] with CDF ``rows`` [B, N]:
    ``(values i32[B, N], ok bool[B])``; ``ok`` is False for a stream whose
    final lane states are not 2^16 (corrupt or mis-sized).

    CPU tensors run :func:`rans_decode_reference`; CUDA tensors launch K2
    in the variant :func:`decode_variant` picks, or raise if it cannot."""
    if stream.device.type == "cpu":
        return rans_decode_reference(tables, stream, rows, K, N)
    _on_cuda("rans_decode", stream)
    if stream.dtype != torch.uint16 or stream.dim() != 2 or not stream.is_contiguous():
        raise TypeError("rans_decode: stream must be a contiguous uint16 [B, cap] tensor")
    B, cap = stream.shape
    _check_rows("rans_decode", rows, B, N, stream.device)
    _check_lanes("rans_decode", K)
    if cap < 2 * K:
        raise ValueError(f"rans_decode: {cap} words cannot hold the {K} lane states")
    t = _tables(tables)
    return _decode_launch(t, stream, rows, K, N, decode_variant(t) == "on_chip")


def _decode_launch(t: RansTables, stream, rows, K, N, on_chip: bool):
    """Launches K2 in the given variant (``rans_decode`` picks it from the
    tables' size; ``chip_smoke.py`` also times the other one)."""
    t = t.on(stream.device)
    B, cap = stream.shape
    dev = stream.device
    values = torch.empty((B, N), dtype=torch.int32, device=dev)
    ok = torch.empty((B,), dtype=torch.bool, device=dev)
    if B == 0:
        return values, ok
    lib = cuda_build.load(_SOURCE, _declare)
    with torch.cuda.device(dev):
        rc = lib.tpc_rans_decode(
            stream.data_ptr(), cap, rows.data_ptr(), int(rows.dtype == torch.uint8),
            t.blob.data_ptr(), t.table_bytes, t.fc_words, t.bucket_words,
            t.num_rows, t.precision, t.bucket_bits, int(on_chip),
            B, N, K, values.data_ptr(), ok.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _check("rans_decode", rc, lib)
    count_launch(rans_decode)
    with _count_lock:
        rans_decode.variant_launches["on_chip" if on_chip else "global"] += 1
    return values, ok


rans_encode.launches = 0
rans_decode.launches = 0
rans_decode.variant_launches = {"on_chip": 0, "global": 0}


def make_rans_encoder(tables, K: int, cap_words: int):
    """``encode(values i32[B, N], rows[B, N]) -> (stream, lengths,
    overflow)`` over ``tables`` (a ``CdfTables`` or :class:`RansTables`)."""
    t, K, cap = _tables(tables), int(K), int(cap_words)

    def encode(values, rows):
        return rans_encode(t, values, rows, K, cap)

    return encode


def make_rans_decoder(tables, K: int, N: int):
    """``decode(stream u16[B, cap'], rows[B, N]) -> (values, ok)``."""
    t, K, N = _tables(tables), int(K), int(N)

    def decode(stream, rows):
        return rans_decode(t, stream, rows, K, N)

    return decode
