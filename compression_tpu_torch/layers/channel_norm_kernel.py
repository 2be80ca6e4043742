"""HiFiC's ChannelNorm fused with its convolution's bias and the ReLU or the
residual add after it: a hand-written CUDA kernel and its plain twin.

Over the trailing (channel) axis, all float32 (or all float64)::

    v   = x [+ bias]
    out = [residual +] [relu]((v - mean(v)) * rsqrt(var(v) + eps) * gamma + beta)

with ``var`` the population variance, as HiFiC's ChannelNorm takes it.

* ``fused_channel_norm(x, gamma, beta, bias, residual, relu, eps)`` launches
  ``csrc/channel_norm.cu`` once for a CUDA tensor (or raises), and runs the
  plain twin :func:`fused_channel_norm_reference` for a CPU tensor; there is
  no fallback between the two. float64 (HiFiC's float64 checks) takes the
  kernel's general path on the card. ``fused_channel_norm.launches`` counts kernel
  launches. Where a tensor needs a gradient it runs under
  :class:`FusedChannelNorm`: the forward as above, saving each row's mean
  and rstd; the backward in plain torch ops (:func:`fused_channel_norm_backward`).
* The kernel replaces no TPU kernel: the JAX package's ChannelNorm
  (``compression_tpu/models/hific/archs.py``) is plain ``jnp`` that XLA
  fuses, and it has no backward kernel either. The port ran it as separate
  torch ops beside the bias add and the ReLU or residual add, about eight
  reads and six writes of the activation. On an H100 the work is bound by
  bytes (a few flops against 8 bytes an element, 12 with the residual); the
  kernel reads x (and the residual) once and writes out once, keeping each
  row in registers between its two sums and its output (see the notes in
  ``csrc/channel_norm.cu``). It is compiled with nvcc for ``sm_90a`` at
  first use, into ``csrc/build/``, and loaded with ctypes
  (:mod:`compression_tpu_torch.util.cuda_build`).
* At HiFiC's widths the float32 kernel sums each row in the order of ATen's
  reduction (``Reduce.cuh``) as of torch :data:`ATEN_ORDER_TORCH`, so that
  it is the twin on the card bit for bit; another release may order the
  sums otherwise, which moves a row's mean by an ulp and HiFiC's latents
  at rounding ties. Loading the kernel under another release warns, and
  ``tests/test_torch_cuda.py::test_channel_norm_sums_rows_as_torch_mean``
  checks the order on the card.
"""

from __future__ import annotations

import ctypes
import pathlib
import warnings

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from compression_tpu_torch.util import cuda_build
from compression_tpu_torch.util.graphs import count_launch

__all__ = [
    "ATEN_ORDER_TORCH",
    "FusedChannelNorm",
    "build",
    "fused_channel_norm",
    "fused_channel_norm_backward",
    "fused_channel_norm_reference",
]

_SOURCE = "channel_norm.cu"
_DTYPES = (torch.float32, torch.float64)

# The torch release whose ATen row reduction the kernel's float32 sums copy.
ATEN_ORDER_TORCH = "2.11"


def _reference(x, gamma, beta, bias, residual, relu, eps):
    """The twin's output with each row's mean and rstd (keepdim)."""
    v = x if bias is None else x + bias
    mu = torch.mean(v, dim=-1, keepdim=True)
    var = torch.mean(torch.square(v - mu), dim=-1, keepdim=True)  # ddof 0
    rstd = torch.rsqrt(var + eps)
    out = (v - mu) * rstd * gamma + beta
    if relu:
        out = torch.relu(out)
    if residual is not None:
        out = residual + out
    return out, mu, rstd


def fused_channel_norm_reference(x, gamma, beta, bias=None, residual=None, relu: bool = False,
                                 eps: float = 1e-3):
    """Plain PyTorch twin of the kernel (the CPU path and the test oracle):
    the composition HiFiC ran before the kernel, op for op (the
    convolution's ``+ bias``, ChannelNorm's ops, then ``torch.relu`` or
    ``residual + ...``), in x's dtype."""
    return _reference(x, gamma, beta, bias, residual, relu, eps)[0]


def build() -> pathlib.Path:
    """Compiles ``csrc/channel_norm.cu`` (if not built yet) and returns the
    library path; ptxas's report lands in
    ``cuda_build.build_logs["channel_norm.cu"]``."""
    return cuda_build.build(_SOURCE)


def _declare(lib: ctypes.CDLL) -> None:
    lib.tpc_channel_norm_forward.restype = ctypes.c_int
    lib.tpc_channel_norm_forward.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_double, ctypes.c_void_p,
    ]
    lib.tpc_channel_norm_error_string.restype = ctypes.c_char_p
    lib.tpc_channel_norm_error_string.argtypes = [ctypes.c_int]
    release = ".".join(torch.__version__.split(".")[:2])
    if release != ATEN_ORDER_TORCH:
        warnings.warn(f"fused_channel_norm sums rows in ATen's order of torch "
                      f"{ATEN_ORDER_TORCH}; under torch {torch.__version__} it may differ from "
                      "torch.mean by an ulp (tests/test_torch_cuda.py -k sums_rows_as_torch_mean)",
                      RuntimeWarning, stacklevel=2)


def _check_inputs(x, gamma, beta, bias, residual) -> int:
    """C, after checking what the kernel takes: every tensor of x's dtype,
    float32 or float64, on x's device and contiguous (x and the residual as
    ``(rows, C)`` rows), gamma, beta and bias of shape (C,), the residual of
    x's shape."""
    c = x.shape[-1] if x.dim() else 0
    named = (("x", x), ("gamma", gamma), ("beta", beta), ("bias", bias),
             ("residual", residual))
    for name, t in named:
        if t is None:
            continue
        if t.dtype not in _DTYPES or t.dtype != x.dtype:
            raise TypeError(f"fused_channel_norm: {name} is {t.dtype}, x {x.dtype}: every "
                            "tensor must be float32, or every one float64")
        if t.device != x.device:
            raise ValueError(f"fused_channel_norm: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_channel_norm: {name} must be contiguous (x and the "
                             "residual as (rows, C) rows)")
    if c < 1:
        raise ValueError(f"fused_channel_norm: C = {c} unsupported (at least 1)")
    for name, t in named[1:4]:
        if t is not None and tuple(t.shape) != (c,):
            raise ValueError(f"fused_channel_norm: {name} {tuple(t.shape)} does not match "
                             f"C = {c}")
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"fused_channel_norm: residual {tuple(residual.shape)} is not x's "
                         f"{tuple(x.shape)}")
    return c


def _launch(device, *args) -> None:
    """Calls ``tpc_channel_norm_forward`` with ``args`` and the current
    stream of ``device``, raises if the launch failed, and counts it."""
    lib = cuda_build.load(_SOURCE, _declare)
    with torch.cuda.device(device):
        rc = lib.tpc_channel_norm_forward(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        msg = lib.tpc_channel_norm_error_string(rc).decode()
        raise RuntimeError(f"fused_channel_norm kernel launch failed: {msg} ({rc})")
    count_launch(fused_channel_norm)


def _kernel_forward(x, gamma, beta, bias, residual, relu, eps, stats):
    """The card's route: checks, then one launch. Returns ``(out, mean,
    rstd)``; mean and rstd (keepdim) only with ``stats``, else None."""
    c = _check_inputs(x, gamma, beta, bias, residual)
    out = torch.empty_like(x)
    mean = rstd = None
    if stats:
        mean = x.new_empty(x.shape[:-1] + (1,))
        rstd = x.new_empty(x.shape[:-1] + (1,))
    rows = x.numel() // c
    if rows:
        def ptr(t):
            return None if t is None else t.data_ptr()

        # A mean's 1 / C as torch.mean rounds it on the card: float(rows) /
        # float(rows * C), both in x's dtype.
        f64 = x.dtype == torch.float64
        real = np.float64 if f64 else np.float32
        factor = float(real(rows) / real(rows * c))
        _launch(x.device, x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), ptr(bias),
                ptr(residual), out.data_ptr(), ptr(mean), ptr(rstd), rows, c,
                int(bool(relu)), int(f64), factor, float(eps))
    return out, mean, rstd


def _forward(x, gamma, beta, bias, residual, relu, eps, stats):
    if x.device.type == "cpu":
        return _reference(x, gamma, beta, bias, residual, relu, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_channel_norm: unsupported device {x.device}")
    return _kernel_forward(x, gamma, beta, bias, residual, relu, eps, stats)


def fused_channel_norm(x, gamma, beta, bias=None, residual=None, relu: bool = False,
                       eps: float = 1e-3):
    """``[residual +] [relu](ChannelNorm(x [+ bias]))`` over the trailing
    axis of ``x`` (any leading dims; see the module docstring).

    CPU tensors run :func:`fused_channel_norm_reference`; CUDA tensors
    launch the kernel once, or raise if it cannot (a type other than
    float32 or float64, mixed types, rows that are not contiguous, shapes
    that do not match, build or launch failure). Where autograd is on and a
    tensor needs a gradient, the call goes through :class:`FusedChannelNorm`.
    """
    tensors = (x, gamma, beta, bias, residual)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        return FusedChannelNorm.apply(x, gamma, beta, bias, residual, bool(relu), float(eps))
    return _forward(x, gamma, beta, bias, residual, relu, eps, stats=False)[0]


fused_channel_norm.launches = 0


def fused_channel_norm_backward(grad, x, gamma, beta, bias, mean, rstd, relu: bool):
    """Gradients of the fused ChannelNorm in plain torch ops, from the saved
    x and each row's mean and rstd (keepdim): with ``xhat = (v - mean) *
    rstd`` and ``g`` the output's gradient (zero where the ReLU's input
    ``xhat * gamma + beta`` is not above 0), ``dv = rstd * (g*gamma -
    mean(g*gamma) - xhat * mean(g*gamma * xhat))`` over the channels,
    ``dgamma = sum_rows g * xhat``, ``dbeta = sum_rows g`` and ``dbias =
    sum_rows dv``. The residual's gradient is the output's. Returns ``(dx,
    dgamma, dbeta, dbias)``, dbias None without a bias."""
    c = x.shape[-1]
    v = x if bias is None else x + bias
    xhat = (v - mean) * rstd
    if relu:
        grad = torch.where(xhat * gamma + beta > 0, grad, torch.zeros_like(grad))
    gx = grad * gamma
    dv = rstd * (gx - gx.mean(-1, keepdim=True) - xhat * (gx * xhat).mean(-1, keepdim=True))
    g2 = grad.reshape(-1, c)
    dgamma = (g2 * xhat.reshape(-1, c)).sum(0)
    dbeta = g2.sum(0)
    dbias = None if bias is None else dv.reshape(-1, c).sum(0)
    return dv, dgamma, dbeta, dbias


class FusedChannelNorm(torch.autograd.Function):
    """The fused ChannelNorm under autograd: the forward launches the kernel
    on the card (the twin on the CPU) and saves each row's mean and rstd;
    the backward is :func:`fused_channel_norm_backward`."""

    @staticmethod
    def forward(ctx, x, gamma, beta, bias, residual, relu, eps):
        out, mean, rstd = _forward(x, gamma, beta, bias, residual, relu, eps, stats=True)
        ctx.relu = relu
        ctx.save_for_backward(x, gamma, beta, bias, mean, rstd)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        x, gamma, beta, bias, mean, rstd = ctx.saved_tensors
        dx, dgamma, dbeta, dbias = fused_channel_norm_backward(
            grad, x, gamma, beta, bias, mean, rstd, ctx.relu)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, dgamma if need[1] else None,
                dbeta if need[2] else None, dbias if need[3] else None,
                grad if need[4] else None, None, None)
