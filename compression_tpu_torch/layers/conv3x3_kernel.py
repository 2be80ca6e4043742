"""A 3x3, stride-1, zero-padded ("same") float32 correlation over
channels-last activations: a hand-written CUDA kernel and its plain twin.

``conv3x3(x, weight)`` takes x ``(N, H, W, cin)`` and the correlation
kernel ``(cout, cin, 3, 3)`` (torch's OIHW, as ``SignalConv2D.kernel()``
gives it with ``corr=True``) and returns ``(N, H, W, cout)`` contiguous::

    out[n, h, w, o] = sum_{dy, dx, c} x[n, h + dy - 1, w + dx - 1, c] * weight[o, c, dy, dx]

with x zero outside the image, and no bias.

* For a CUDA tensor it launches ``csrc/conv3x3.cu`` once (or raises); for a
  CPU tensor it runs the plain twin :func:`conv3x3_reference`, ``F.conv2d``
  over the same channels-last view. There is no fallback between the two.
  ``conv3x3.launches`` counts kernel launches. No gradient: HiFiC's
  generator calls it only where none is wanted (``models/hific/archs.py``).
* The kernel replaces no TPU kernel: the JAX package leaves every
  convolution to XLA. It is an implicit GEMM in 3xTF32 on the tensor cores
  (``wgmma`` fed by TMA), where cuDNN's float32 kernels with TF32 off run on
  the CUDA cores; the products are bound by operations (see the notes in
  ``csrc/conv3x3.cu``). Each operand is split into a TF32 high part and a
  TF32 remainder: x in the kernel's registers, the weight here, once per
  weight (:func:`split_tf32`), kept beside the weight tensor while its data
  and version stay the same, so that new weights are never served stale.
* An output's sum takes one order whatever the batch or its place, so an
  image's rows are the same alone as in a batch, on every run.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from compression_tpu_torch.util import cuda_build
from compression_tpu_torch.util.graphs import count_launch

__all__ = ["build", "conv3x3", "conv3x3_reference", "split_tf32"]

_SOURCE = "conv3x3.cu"

def conv3x3_reference(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the kernel (the CPU path and the test oracle):
    ``F.conv2d`` with padding 1 over x's channels-first view, returned as
    contiguous channels-last rows."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def _tf32(v: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest TF32 value, ties away from zero (the
    kernel's ``tf32_rna``: the low 13 bits of the mantissa cleared)."""
    bits = v.view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(cout, cin, 3, 3)`` float32 -> ``(hi, lo)``, each ``(cout, 3, 3,
    cin)`` contiguous: ``hi = tf32(w)``, ``lo = tf32(w - hi)``."""
    w = weight.detach().permute(0, 2, 3, 1).contiguous()
    hi = _tf32(w)
    return hi, _tf32(w - hi)


# weight -> (its data pointer and version, hi, lo)
_splits = WeakIdKeyDictionary()
_splits_lock = threading.Lock()  # the codec's pipeline workers decode concurrently


def _split_weights(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if weight.is_inference():  # keeps no version to key a split on
        return split_tf32(weight)
    key = (weight.data_ptr(), weight._version)
    with _splits_lock:
        held = _splits.get(weight)
        if held is None or held[0] != key:
            held = (key, *split_tf32(weight))
            if weight.is_cuda:
                # Other threads read it on their own streams: let the split
                # be done before any of them can.
                torch.cuda.current_stream(weight.device).synchronize()
            _splits[weight] = held
    return held[1], held[2]


def build() -> pathlib.Path:
    """Compiles ``csrc/conv3x3.cu`` (if not built yet) and returns the
    library path; ptxas's report lands in
    ``cuda_build.build_logs["conv3x3.cu"]``."""
    return cuda_build.build(_SOURCE)


def _declarer(name: str):
    """The ctypes declarations of ``csrc/<name>.cu``'s C interface, which
    the 3x3 and the up-convolution kernels share: ``tpc_<name>_forward(x,
    w_hi, w_lo, out, n, h, w, cin, cout, stream)`` and
    ``tpc_<name>_error_string(code)``."""
    def declare(lib: ctypes.CDLL) -> None:
        forward = getattr(lib, f"tpc_{name}_forward")
        forward.restype = ctypes.c_int
        forward.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        error_string = getattr(lib, f"tpc_{name}_error_string")
        error_string.restype = ctypes.c_char_p
        error_string.argtypes = [ctypes.c_int]
    return declare


def _check_inputs(x: torch.Tensor, weight: torch.Tensor, name: str = "conv3x3") -> None:
    """What the kernel ``name`` takes: x ``(N, H, W, cin)`` and weight
    ``(cout, cin, 3, 3)``, both float32 on one device, x contiguous and
    16-byte aligned, cin and cout multiples of 4 (rows of 16 bytes, as TMA
    reads them)."""
    if x.dtype != torch.float32 or weight.dtype != torch.float32:
        raise TypeError(f"{name}: x is {x.dtype}, weight {weight.dtype}: both must be float32")
    if x.dim() != 4 or weight.dim() != 4 or tuple(weight.shape[2:]) != (3, 3):
        raise ValueError(f"{name}: x {tuple(x.shape)} must be (N, H, W, cin) and weight "
                         f"{tuple(weight.shape)} (cout, cin, 3, 3)")
    cout, cin = weight.shape[:2]
    if x.shape[-1] != cin:
        raise ValueError(f"{name}: x has {x.shape[-1]} channels, weight {cin}")
    if cin % 4 or cout % 4:
        raise ValueError(f"{name}: cin {cin} and cout {cout} must be multiples of 4")
    if weight.device != x.device:
        raise ValueError(f"{name}: weight is on {weight.device}, x on {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be contiguous (N, H, W, cin) rows, 16-byte aligned")


def _launch(name: str, wrapper, x: torch.Tensor, weight: torch.Tensor,
            out: torch.Tensor) -> torch.Tensor:
    """Launches ``csrc/<name>.cu`` once on x (checked by
    :func:`_check_inputs`), the weight's cached split and ``out``, on the
    current stream, and counts the launch on ``wrapper``; raises if the
    launch fails."""
    if out.numel() == 0:
        return out
    hi, lo = _split_weights(weight)
    lib = cuda_build.load(f"{name}.cu", _declarer(name))
    stream = torch.cuda.current_stream(x.device)
    for t in (hi, lo):  # a split may be freed, when its weight changes, while this reads it
        t.record_stream(stream)
    n, h, w, cin = x.shape
    with torch.cuda.device(x.device):
        rc = getattr(lib, f"tpc_{name}_forward")(
            x.data_ptr(), hi.data_ptr(), lo.data_ptr(), out.data_ptr(), n, h, w, cin,
            weight.shape[0], stream.cuda_stream)
    if rc != 0:
        msg = getattr(lib, f"tpc_{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({rc})")
    count_launch(wrapper)
    return out


def _kernel_forward(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    _check_inputs(x, weight)
    out = torch.empty(x.shape[:3] + weight.shape[:1], device=x.device, dtype=x.dtype)
    return _launch("conv3x3", conv3x3, x, weight, out)


def conv3x3(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The stride-1, zero-padded 3x3 correlation of channels-last ``x`` with
    ``weight`` (see the module docstring), without a gradient.

    CPU tensors run :func:`conv3x3_reference`; CUDA tensors launch the
    kernel once, or raise if it cannot (a type other than float32, shapes it
    does not take, x not contiguous, build or launch failure)."""
    if x.device.type == "cpu":
        return conv3x3_reference(x, weight)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3: unsupported device {x.device}")
    return _kernel_forward(x, weight)


conv3x3.launches = 0
