"""Least time of one call of K3 (the rANS encoder) or K2 (its decoder) on
``images`` streams of ``elements`` symbols each that hold ``words`` 16-bit
words in all: the symbols (int32) and their CDF rows (uint8) read once and
the words written once (read once, decoding), over HBM's rate; against the
integer operations of every in-range symbol (the encoder's field mapping,
gather, pushes, renorm test and update: 28; the decoder's slot, gathers,
update and renorm: 19) over the int32 rate. The tables, the per-image
lengths and an escape's extra operations are left out, so the bound is
never more than what the inputs need."""

from __future__ import annotations

from benchmark.roofline import peaks

ENCODE_OPS, DECODE_OPS = 28, 19


def bound_s(images: int, elements: int, words: int, decode: bool) -> float:
    symbols = images * elements
    nbytes = 5.0 * symbols + 2.0 * words
    ops = (DECODE_OPS if decode else ENCODE_OPS) * symbols
    return max(nbytes / peaks.HBM_BYTES, ops / peaks.INT32_OPS)
