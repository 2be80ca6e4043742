"""NumPy specification of the device entropy coder: K-lane interleaved rANS
(the port's own copy of ``compression_tpu/codec/rans_ref.py``).

It is the executable specification that the plain PyTorch twins and the
CUDA kernels of :mod:`compression_tpu_torch.codec.rans` are held to: all
three produce bit-identical streams, and the JAX package writes the same
format, so a stream written by either package decodes in the other. The
tests on the card use it as their oracle where there is no JAX.

The format is value-compatible with the host range coder (same quantized
CDF tables, same symbol/escape semantics) but not bit-compatible: rANS is
last-in-first-out, and escapes carry their payload as two raw 16-bit
bypass chunks instead of Elias-gamma bits.

Format specification
--------------------
Constants: word = 16 bits; state u32 with renorm bound L = 2^16 (state
invariant x in [L, 2^32) once initialized); table precision P =
``tables.precision`` (<= 16).

Per element j (0-indexed over the flattened tensor): lane k = j mod K,
step t = j div K. Per element, using row r = rows[j]:
  s = value - cdf_offset[r]; E = cdf_length[r] - 2 (escape symbol index)
  in-range:  main symbol m = s            (0 <= s < E)
  escaped:   m = E, payload e = 2*(s-E) if s >= E else 2*(-s) - 1 (u32)

DECODE order (what the decoder executes; the encoder is its exact mirror,
run backwards): for t = 0..T-1, pops in order (main, payload-lo,
payload-hi); within each pop, lanes 0..K-1 read renorm words in ascending
lane order. Pops:
  main pop:    slot = x & (2^P-1); m = slot->symbol; f,c from the CDF row;
               x = f*(x >> P) + slot - c; if x < L: x = (x<<16) | read()
  bypass pop (16 raw bits, only if m == E): b = x & 0xFFFF; x >>= 16;
               x = (x<<16) | read()     [always reads exactly one word]
Stream head: lane states, read as  for k in 0..K-1: x_k = (read()<<16) |
read().  Decode ends with x_k == L for every lane (integrity check).

ENCODE mirrors decode reversed: elements processed t = T-1..0, pushes
(payload-hi, payload-lo, main) with lanes K-1..0, renorm-before-push
(emit low word iff x >= f << (32-P); bypass always emits), starting at
x = L; finally lane states are flushed (k = K-1..0: emit lo, emit hi) and
the whole emission sequence is REVERSED to give the decode-order stream.

Elements past the end (padding to T*K) are skipped by both sides.
"""

from __future__ import annotations

import numpy as np

__all__ = ["rans_encode", "rans_decode", "build_slot_table"]

_L = 1 << 16
_M16 = 0xFFFF


def build_slot_table(cdf: np.ndarray, cdf_length: np.ndarray, precision: int):
    """slot -> symbol lookup per row: int32 [num_rows, 2^precision]."""
    R = cdf.shape[0]
    out = np.zeros((R, 1 << precision), np.int32)
    for r in range(R):
        n = int(cdf_length[r])
        row = cdf[r, :n]
        out[r] = np.searchsorted(row, np.arange(1 << precision), "right") - 1
    return out


def _element_fields(values, rows, tables):
    values = np.asarray(values, np.int64).ravel()
    rows = np.asarray(rows, np.int64).ravel()
    off = tables.cdf_offset[rows].astype(np.int64)
    esc = (tables.cdf_length[rows] - 2).astype(np.int64)
    s = values - off
    escaped = ~((0 <= s) & (s < esc))
    m = np.where(escaped, esc, s)
    e = np.where(s >= esc, 2 * (s - esc), 2 * (-s) - 1).astype(np.uint64)
    return rows, m.astype(np.int64), escaped, e


def rans_encode(values, rows, tables, K: int) -> bytes:
    """Encodes one flattened tensor into one interleaved-rANS stream."""
    rows, m, escaped, e = _element_fields(values, rows, tables)
    N = len(m)
    P = tables.precision
    cdf = tables.cdf
    T = -(-N // K)
    x = np.full(K, _L, np.uint64)
    emitted = []  # in encode order; reversed at the end

    for t in range(T - 1, -1, -1):
        for push in ("hi", "lo", "main"):
            for k in range(K - 1, -1, -1):
                j = t * K + k
                if j >= N:
                    continue
                if push in ("hi", "lo"):
                    if not escaped[j]:
                        continue
                    b = (int(e[j]) >> 16) if push == "hi" else (int(e[j]) & _M16)
                    emitted.append(int(x[k]) & _M16)
                    x[k] = ((int(x[k]) >> 16) << 16) | b
                else:
                    r, mm = rows[j], int(m[j])
                    c = int(cdf[r, mm])
                    f = int(cdf[r, mm + 1]) - c
                    if int(x[k]) >= (f << (32 - P)):
                        emitted.append(int(x[k]) & _M16)
                        x[k] = int(x[k]) >> 16
                    xi = int(x[k])
                    x[k] = ((xi // f) << P) + (xi % f) + c
    for k in range(K - 1, -1, -1):
        emitted.append(int(x[k]) & _M16)
        emitted.append((int(x[k]) >> 16) & _M16)
    words = np.asarray(emitted[::-1], np.uint16)
    return words.tobytes()


def rans_decode(data: bytes, rows, tables, K: int, n: int) -> np.ndarray:
    """Decodes ``n`` values given their CDF rows; inverse of rans_encode."""
    rows = np.asarray(rows, np.int64).ravel()
    assert len(rows) == n
    P = tables.precision
    cdf = tables.cdf
    slot2sym = build_slot_table(cdf, tables.cdf_length, P)
    words = np.frombuffer(data, np.uint16)
    pos = 0

    def read():
        nonlocal pos
        w = int(words[pos]) if pos < len(words) else 0
        pos += 1
        return w

    x = np.zeros(K, np.uint64)
    for k in range(K):
        hi = read()
        lo = read()
        x[k] = (hi << 16) | lo
    T = -(-n // K)
    out = np.zeros(n, np.int64)
    for t in range(T):
        esc_flags = {}
        for pop in ("main", "lo", "hi"):
            for k in range(K):
                j = t * K + k
                if j >= n:
                    continue
                r = rows[j]
                if pop == "main":
                    slot = int(x[k]) & ((1 << P) - 1)
                    mm = int(slot2sym[r, slot])
                    c = int(cdf[r, mm])
                    f = int(cdf[r, mm + 1]) - c
                    x[k] = f * (int(x[k]) >> P) + slot - c
                    if int(x[k]) < _L:
                        x[k] = (int(x[k]) << 16) | read()
                    esc = mm == int(tables.cdf_length[r]) - 2
                    esc_flags[k] = esc
                    out[j] = mm  # symbol for now; fixed below
                else:
                    if not esc_flags.get(k, False):
                        continue
                    b = int(x[k]) & _M16
                    x[k] = int(x[k]) >> 16
                    x[k] = (int(x[k]) << 16) | read()
                    if pop == "lo":
                        out[j] = (out[j] << 32) | b  # stash (symbol, lo)
                    else:
                        # out[j] currently ((E << 32) | lo); recover value.
                        lo = int(out[j]) & _M16
                        E = int(out[j]) >> 32
                        e = (b << 16) | lo
                        s = E + e // 2 if e % 2 == 0 else -((e + 1) // 2)
                        out[j] = s
        # (in-range symbols already hold s == m from the main pop)
    if not np.all(x == _L):
        raise ValueError("rANS stream integrity check failed")
    return (out + tables.cdf_offset[rows]).astype(np.int32)
