"""The fused GDN kernels, hand-written CUDA, and their plain twin.

Replace the TPU kernel ``fused_gdn`` in
``compression_tpu/layers/pallas/gdn_kernel.py`` (``pl.pallas_call`` at
:65). Over the trailing channel axis: ``y = x * rsqrt(beta + (x*x) @
gamma)``, or ``x * sqrt(...)`` for IGDN, with the norm accumulated in
float32 (float64 for float64) and ``y`` stored in x's dtype, as the TPU
kernel does.

* ``fused_gdn(x, beta, gamma, inverse)``, K1, launches ``csrc/gdn.cu``'s
  tensor-core kernel for a CUDA tensor (or raises), and runs the plain twin
  ``fused_gdn_reference`` for a CPU tensor. ``fused_gdn.launches`` counts
  kernel launches. K1 takes float32, and C a multiple of 32 up to 192;
  other widths up to 192 go through it padded (:func:`pad_channels`).
* ``fused_gdn_general(x, beta, gamma, inverse)`` launches ``csrc/gdn.cu``'s
  second kernel, for any C >= 1 in float32, float64, float16 or bfloat16
  (or raises), and runs the twin for a CPU tensor;
  ``fused_gdn_general.launches`` counts its launches.
* ``gdn_autograd(x, beta, gamma, inverse)`` is the forward under autograd
  (:class:`FusedGDN`): :func:`routes_to_k1` picks K1 or the general kernel
  before any launch (on the CPU both run the twin), and the backward is
  plain torch ops in x's dtype. The JAX package has no backward kernel
  either: its gradient is XLA's autodiff of the ``tensordot`` path
  (``compression_tpu/layers/gdn.py:94-109``), products outside any Pallas
  kernel.
* The CUDA source is compiled with nvcc for ``sm_90a`` at first use, into
  ``csrc/build/`` (listed in .gitignore), as a shared library with a plain
  C interface loaded with ctypes (:mod:`compression_tpu_torch.util.cuda_build`).

K1 runs the product on the tensor cores in 3xTF32 (``wgmma``, x tiles by
TMA); on an H100 it is bound by bytes. The general kernel runs it on the
tensor cores too: float32 rows TMA can stream (C a multiple of 4, x and y
16-byte aligned) as split-TF32 ``wgmma`` (3xTF32's products and lo*lo)
with x streamed in K blocks, everything else through warp-level
``mma.sync``: 3xTF32 in float32, one TF32 product in float16 and bfloat16
(x squared in float), DMMA in float64. It is bound by operations in
float32 and float64 and by bytes in the 16-bit types (see the notes in
``csrc/gdn.cu``).
"""

from __future__ import annotations

import ctypes
import pathlib

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from compression_tpu_torch.util import cuda_build
from compression_tpu_torch.util.graphs import count_launch

__all__ = [
    "FusedGDN",
    "fused_gdn",
    "fused_gdn_backward",
    "fused_gdn_general",
    "fused_gdn_reference",
    "gdn_autograd",
    "pad_channels",
    "build",
    "routes_to_k1",
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
    """Plain PyTorch twin of both kernels (the CPU path and the test
    oracle): the norm in float32 (float64 for float64 x), ``y`` cast to x's
    dtype, as the kernels compute it. A float32 or float64 x runs in its own
    dtype, with no copy."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    xa = x.to(acc)
    norm = torch.matmul(xa * xa, gamma.to(acc)) + beta.to(acc)
    return (xa * (torch.sqrt(norm) if inverse else torch.rsqrt(norm))).to(x.dtype)


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
    lib.tpc_gdn_general_forward.restype = ctypes.c_int
    lib.tpc_gdn_general_forward.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
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


def _refuse_grad(wrapper, *tensors) -> None:
    """The kernels are forward only; gradients go through FusedGDN, whose
    forward runs the wrappers with autograd off."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{wrapper.__name__}: the CUDA kernel has no backward of its own; "
            "differentiate through gdn_autograd (FusedGDN), as GDN does"
        )


def _launch(wrapper, entry: str, device, *args) -> None:
    """Calls the C entry point ``entry`` of ``csrc/gdn.cu`` with ``args`` and
    the current stream of ``device``, raises if the launch failed, and counts
    it on ``wrapper.launches``."""
    lib = cuda_build.load(_SOURCE, _declare)
    with torch.cuda.device(device):
        rc = getattr(lib, entry)(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        msg = lib.tpc_gdn_error_string(rc).decode()
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: {msg} ({rc})")
    count_launch(wrapper)


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
    _refuse_grad(fused_gdn, x, beta, gamma)
    xp, beta, gamma = pad_channels(x, beta, gamma)
    width = xp.shape[-1]
    out = torch.empty_like(xp, memory_format=torch.contiguous_format)
    rows = x.numel() // c
    if rows == 0:
        return out[..., :c]
    _launch(fused_gdn, "tpc_gdn_forward", x.device, xp.data_ptr(), beta.data_ptr(),
            gamma.data_ptr(), out.data_ptr(), rows, width, int(bool(inverse)))
    return out if width == c else out[..., :c].contiguous()


fused_gdn.launches = 0

# fused_gdn_general's storage types, as csrc/gdn.cu numbers them.
_GENERAL_DTYPES = {torch.float32: 0, torch.float64: 1, torch.float16: 2,
                   torch.bfloat16: 3}


def _check_general_inputs(x, beta, gamma) -> int:
    """:func:`_check_inputs` without its dtype and width limits: x, beta and
    gamma of one dtype the general kernel is built for, any C >= 1."""
    c = x.shape[-1] if x.dim() else 0
    if x.dtype not in _GENERAL_DTYPES:
        raise TypeError(f"fused_gdn_general: unsupported dtype {x.dtype} "
                        f"(one of {', '.join(map(str, _GENERAL_DTYPES))})")
    for name, t in (("x", x), ("beta", beta), ("gamma", gamma)):
        if t.dtype != x.dtype:
            raise TypeError(f"fused_gdn_general: {name} is {t.dtype}, x is {x.dtype}")
        if t.device != x.device:
            raise ValueError(f"fused_gdn_general: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_gdn_general: {name} must be contiguous")
    if c < 1:
        raise ValueError(f"fused_gdn_general: C = {c} unsupported (at least 1)")
    if tuple(beta.shape) != (c,) or tuple(gamma.shape) != (c, c):
        raise ValueError(
            f"fused_gdn_general: beta {tuple(beta.shape)} / gamma "
            f"{tuple(gamma.shape)} do not match C = {c}"
        )
    return c


def fused_gdn_general(x, beta, gamma, inverse: bool = False):
    """Fused GDN for the inputs K1 does not take: any C >= 1, and x, beta
    and gamma all float32, float64, float16 or bfloat16 (any leading dims).

    CPU tensors run :func:`fused_gdn_reference`; CUDA tensors launch
    ``csrc/gdn.cu``'s general kernel once (the norm in float32, float64 for
    float64; ``y`` in x's dtype), or raise if it cannot. There is no
    fallback between the two. On the card the products run on the tensor
    cores: float32 as split TF32 (within 2e-5 of the twin), float64 on DMMA
    (IEEE products, within 1e-12), float16 and bfloat16 as one TF32 product
    of x*x squared in float (within two ulps of y's type).
    """
    if x.device.type == "cpu":
        return fused_gdn_reference(x, beta, gamma, inverse)
    if x.device.type != "cuda":
        raise ValueError(f"fused_gdn_general: unsupported device {x.device}")
    c = _check_general_inputs(x, beta, gamma)
    _refuse_grad(fused_gdn_general, x, beta, gamma)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    rows = x.numel() // c
    if rows:
        _launch(fused_gdn_general, "tpc_gdn_general_forward", x.device, x.data_ptr(),
                beta.data_ptr(), gamma.data_ptr(), out.data_ptr(), rows, c,
                int(bool(inverse)), _GENERAL_DTYPES[x.dtype])
    return out


fused_gdn_general.launches = 0


def routes_to_k1(x, beta, gamma) -> bool:
    """The route :class:`FusedGDN` takes, decided before any launch: K1
    (:func:`fused_gdn`) when x, beta and gamma are float32 and
    :func:`pad_channels` brings C to a width K1 is built for
    (:func:`supported_channels`); :func:`fused_gdn_general` for everything
    else."""
    c = x.shape[-1] if x.dim() else 0
    return (all(t.dtype == torch.float32 for t in (x, beta, gamma))
            and supported_channels(c + (-c % 32)))


def fused_gdn_backward(grad, x, beta, gamma, inverse: bool = False):
    """Gradients of ``y = x * s`` with ``s = norm^(-1/2)`` (``norm^(1/2)``
    for IGDN), ``norm = (x*x) @ gamma + beta``, in plain torch ops in x's
    dtype (``torch.matmul``; strict fp32 on the card): with ``h = grad * x * ds/dnorm``,
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
    """The fused GDN under autograd: the forward is :func:`fused_gdn` (K1)
    where :func:`routes_to_k1` says so, else :func:`fused_gdn_general` (each
    launches its kernel on the card and counts it, and runs the twin on the
    CPU); the backward is :func:`fused_gdn_backward`, which recomputes the
    norm from the saved x rather than keeping it from the forward."""

    @staticmethod
    def forward(ctx, x, beta, gamma, inverse):
        ctx.inverse = bool(inverse)
        ctx.save_for_backward(x, beta, gamma)
        kernel = fused_gdn if routes_to_k1(x, beta, gamma) else fused_gdn_general
        return kernel(x, beta, gamma, ctx.inverse)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        x, beta, gamma = ctx.saved_tensors
        dx, dbeta, dgamma = fused_gdn_backward(grad, x, beta, gamma, ctx.inverse)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, dbeta if need[1] else None,
                dgamma if need[2] else None, None)


def gdn_autograd(x, beta, gamma, inverse: bool = False):
    """The fused GDN with gradients (see :class:`FusedGDN`). ``x`` is made
    contiguous first, as the kernels take ``(rows, C)`` rows only."""
    return FusedGDN.apply(x.contiguous(), beta.contiguous(), gamma.contiguous(),
                          inverse)
