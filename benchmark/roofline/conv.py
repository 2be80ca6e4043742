"""Least work of one convolution layer, counted from its shapes: the
multiply-adds the layer's definition needs (a 2x up-sampling layer's
kernel meets each input sample k*k times, whatever zeros an implementation
multiplies), each input, weight and bias read once and each output written
once, in float32."""

from __future__ import annotations

from benchmark.roofline import peaks


def out_size(n: int, stride: int = 1, up: bool = False) -> int:
    return 2 * n if up else -(-n // stride)


def conv_flops(n, h, w, cin, cout, k, stride=1, up=False) -> float:
    """FLOPs (2 per multiply-add) of ``n`` images of ``h x w x cin``."""
    if up:
        return 2.0 * n * h * w * cin * cout * k * k
    return 2.0 * n * out_size(h, stride) * out_size(w, stride) * cin * cout * k * k


def conv_bytes(n, h, w, cin, cout, k, stride=1, up=False, bias=True) -> float:
    ho, wo = out_size(h, stride, up), out_size(w, stride, up)
    return 4.0 * (n * h * w * cin + k * k * cin * cout + (cout if bias else 0)
                  + n * ho * wo * cout)


def conv_bound_s(flops: float, nbytes: float) -> float:
    """The least time: the larger of float32 FLOPs over the CUDA cores'
    peak and bytes over HBM's (the configurations forbid TF32)."""
    return max(flops / peaks.FP32_FLOPS, nbytes / peaks.HBM_BYTES)
