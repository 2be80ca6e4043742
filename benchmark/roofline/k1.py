"""Least time of one call of K1, the fused GDN kernel, on ``rows`` rows of
``c`` channels: x read once and y written once, beta and gamma read once,
over HBM's rate; against its ``rows x c x c`` multiply-adds as the three
TF32 products of 3xTF32 (float32 accuracy on the tensor cores) over the
TF32 rate. At the codecs' widths the bytes bound it."""

from __future__ import annotations

from benchmark.roofline import peaks


def gdn_flops(rows: int, c: int) -> float:
    return 2.0 * rows * c * c


def gdn_bytes(rows: int, c: int) -> float:
    return 4.0 * (2 * rows * c + c * c + c)


def bound_s(rows: int, c: int) -> float:
    return max(gdn_bytes(rows, c) / peaks.HBM_BYTES,
               3 * gdn_flops(rows, c) / peaks.TF32_FLOPS)
