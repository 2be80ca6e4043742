"""K1, the fused GDN kernel: the hand-written CUDA kernel and its plain twin.

Replaces the TPU kernel ``fused_gdn`` in
``compression_tpu/layers/pallas/gdn_kernel.py`` (``pl.pallas_call`` at
:65). Over the trailing channel axis: ``y = x * rsqrt(beta + (x*x) @
gamma)``, or ``x * sqrt(...)`` for IGDN, with fp32 accumulation.

* ``fused_gdn(x, beta, gamma, inverse)`` launches ``csrc/gdn.cu`` for a
  CUDA tensor (or raises), and runs the plain twin ``fused_gdn_reference``
  for a CPU tensor. ``fused_gdn.launches`` counts kernel launches. The
  kernel is built for C a multiple of 32 up to 192; other widths up to 192
  go through it padded (:func:`pad_channels`).
* ``gdn_autograd(x, beta, gamma, inverse)`` is the same forward under
  autograd (:class:`FusedGDN`): the kernel (or, for a CPU tensor, the twin)
  computes ``y``, and the backward is plain torch ops. The JAX package has
  no backward kernel either: its gradient is XLA's autodiff of the
  ``tensordot`` path (``compression_tpu/layers/gdn.py:94-109``), products
  outside any Pallas kernel.
* The CUDA source is compiled with nvcc for ``sm_90a`` at first use, into
  ``csrc/build/`` (listed in .gitignore), as a shared library with a plain
  C interface loaded with ctypes (:mod:`compression_tpu_torch.util.cuda_build`).

The kernel runs the product on the tensor cores in 3xTF32 (``wgmma``, x tiles
by TMA); on an H100 it is bound by bytes (see the note at the top of
``csrc/gdn.cu``).
"""

from __future__ import annotations

import ctypes
import pathlib
import threading

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from compression_tpu_torch.util import cuda_build

__all__ = [
    "FusedGDN",
    "fused_gdn",
    "fused_gdn_backward",
    "fused_gdn_reference",
    "gdn_autograd",
    "pad_channels",
    "build",
    "supported_channels",
]

_SOURCE = "gdn.cu"
# Must agree with csrc/gdn.cu: a CTA holds gamma's hi and lo parts for a slice
# of 64 output channels (32 where 64 does not divide C) and one 64-row x
# stage for each of its two warpgroups, in the 232,448 bytes of shared memory
# a block may use; the kernel is instantiated for C up to 192.
_TILE_ROWS = 64
_STAGES = 2
_MAX_SMEM = 232448
_MAX_C = 192

_count_lock = threading.Lock()


def _smem_bytes(c: int) -> int:
    slice_width = 64 if c % 64 == 0 else 32
    return 1024 + 4 * (2 * slice_width * c + _STAGES * _TILE_ROWS * c) + 8 * _STAGES


def supported_channels(c: int) -> bool:
    """Channel counts the kernel is built for: multiples of 32 from 32 to
    192, whose gamma slice and x stages fit in shared memory."""
    return c % 32 == 0 and 0 < c <= _MAX_C and _smem_bytes(c) <= _MAX_SMEM


def pad_channels(x, beta, gamma):
    """``(x, beta, gamma)`` widened to the next multiple of 32 channels: x's
    new columns 0, beta's new entries 1, gamma's new rows and columns 0. The
    real channels' norms gain only exact zeros (``0 * 0 * gamma``, ``x *
    0``), and the new channels come out 0, so the kernel at the padded width
    gives the real channels unchanged. Returns the inputs as they are where
    C is already a multiple of 32. The padded copy of x costs bytes only at
    widths no full-width model has (every reference GDN is 128 or 192)."""
    c = x.shape[-1]
    extra = -c % 32
    if not extra:
        return x, beta, gamma
    return (F.pad(x, (0, extra)), F.pad(beta, (0, extra), value=1.0),
            F.pad(gamma, (0, extra, 0, extra)))


def fused_gdn_reference(x, beta, gamma, inverse: bool = False):
    """Plain PyTorch twin of the kernel (the CPU path and the test oracle)."""
    norm = torch.matmul(x * x, gamma) + beta
    return x * (torch.sqrt(norm) if inverse else torch.rsqrt(norm))


def build() -> pathlib.Path:
    """Compiles ``csrc/gdn.cu`` (if not built yet) and returns the library
    path; ptxas's report lands in ``cuda_build.build_logs["gdn.cu"]``."""
    return cuda_build.build(_SOURCE)


def _declare(lib: ctypes.CDLL) -> None:
    lib.tpc_gdn_forward.restype = ctypes.c_int
    lib.tpc_gdn_forward.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.tpc_gdn_error_string.restype = ctypes.c_char_p
    lib.tpc_gdn_error_string.argtypes = [ctypes.c_int]


def _check_inputs(x, beta, gamma) -> int:
    c = x.shape[-1]
    for name, t in (("x", x), ("beta", beta), ("gamma", gamma)):
        if t.dtype != torch.float32:
            raise TypeError(f"fused_gdn: {name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"fused_gdn: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(
                f"fused_gdn: {name} must be contiguous (x as (rows, C), e.g. "
                "the NHWC view of a channels_last tensor)"
            )
        if t.data_ptr() % 16:
            raise ValueError(f"fused_gdn: {name} must be 16-byte aligned")
    if tuple(beta.shape) != (c,) or tuple(gamma.shape) != (c, c):
        raise ValueError(
            f"fused_gdn: beta {tuple(beta.shape)} / gamma {tuple(gamma.shape)}"
            f" do not match C = {c}"
        )
    if not 0 < c <= _MAX_C:
        raise ValueError(f"fused_gdn: C = {c} unsupported (1 to {_MAX_C})")
    return c


def fused_gdn(x, beta, gamma, inverse: bool = False):
    """Fused GDN over the trailing channel axis of ``x`` (any leading dims).

    CPU tensors run :func:`fused_gdn_reference`; CUDA tensors launch the
    kernel once, or raise if it cannot (C above 192, a type other than
    float32, build or launch failure). There is no fallback between the
    two. A C that is not a multiple of 32 runs at the padded width of
    :func:`pad_channels`, and the result is cut back to C.
    """
    if x.device.type == "cpu":
        return fused_gdn_reference(x, beta, gamma, inverse)
    if x.device.type != "cuda":
        raise ValueError(f"fused_gdn: unsupported device {x.device}")
    c = _check_inputs(x, beta, gamma)
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, beta, gamma)
    ):
        # The kernel is forward only; gradients go through FusedGDN, whose
        # forward runs this function with autograd off.
        raise RuntimeError(
            "fused_gdn: the CUDA kernel has no backward of its own; "
            "differentiate through gdn_autograd (FusedGDN), as GDN does"
        )
    xp, beta, gamma = pad_channels(x, beta, gamma)
    width = xp.shape[-1]
    out = torch.empty_like(xp, memory_format=torch.contiguous_format)
    rows = x.numel() // c
    if rows == 0:
        return out[..., :c]
    lib = cuda_build.load(_SOURCE, _declare)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.tpc_gdn_forward(
            xp.data_ptr(), beta.data_ptr(), gamma.data_ptr(), out.data_ptr(),
            rows, width, int(bool(inverse)), stream,
        )
    if rc != 0:
        msg = lib.tpc_gdn_error_string(rc).decode()
        raise RuntimeError(f"fused_gdn kernel launch failed: {msg} ({rc})")
    with _count_lock:  # pipeline worker threads launch concurrently
        fused_gdn.launches += 1
    return out if width == c else out[..., :c].contiguous()


fused_gdn.launches = 0


def fused_gdn_backward(grad, x, beta, gamma, inverse: bool = False):
    """Gradients of ``y = x * s`` with ``s = norm^(-1/2)`` (``norm^(1/2)``
    for IGDN), ``norm = (x*x) @ gamma + beta``, in plain torch ops (fp32
    ``torch.matmul``): with ``h = grad * x * ds/dnorm``,
    ``dx = grad * s + 2 x (h @ gamma^T)``, ``dgamma = (x*x)^T @ h`` and
    ``dbeta = sum_rows h``. Returns ``(dx, dbeta, dgamma)``."""
    c = x.shape[-1]
    x2 = x * x
    norm = torch.matmul(x2, gamma).add_(beta)
    if inverse:
        s = norm.sqrt_()
        ds = torch.reciprocal(s).mul_(0.5)          # 1 / (2 s)
    else:
        s = norm.rsqrt_()
        ds = (s * s).mul_(s).mul_(-0.5)              # -s^3 / 2
    h = ds.mul_(grad).mul_(x)
    dx = torch.matmul(h, gamma.t()).mul_(x).mul_(2.0).addcmul_(grad, s)
    h2 = h.reshape(-1, c)
    dgamma = torch.matmul(x2.reshape(-1, c).t(), h2)
    dbeta = h2.sum(0)
    return dx, dbeta, dgamma


class FusedGDN(torch.autograd.Function):
    """K1 under autograd: the forward is :func:`fused_gdn` (the kernel on the
    card, the twin on the CPU; ``fused_gdn.launches`` counts the kernel's
    launches), the backward :func:`fused_gdn_backward`, which recomputes
    the norm from the saved x rather than keeping it from the forward."""

    @staticmethod
    def forward(ctx, x, beta, gamma, inverse):
        ctx.inverse = bool(inverse)
        ctx.save_for_backward(x, beta, gamma)
        return fused_gdn(x, beta, gamma, ctx.inverse)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        x, beta, gamma = ctx.saved_tensors
        dx, dbeta, dgamma = fused_gdn_backward(grad, x, beta, gamma, ctx.inverse)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, dbeta if need[1] else None,
                dgamma if need[2] else None, None)


def gdn_autograd(x, beta, gamma, inverse: bool = False):
    """:func:`fused_gdn` with gradients (see :class:`FusedGDN`). ``x`` is
    made contiguous first, as the kernel takes ``(rows, C)`` rows only."""
    return FusedGDN.apply(x.contiguous(), beta.contiguous(), gamma.contiguous(),
                          inverse)
