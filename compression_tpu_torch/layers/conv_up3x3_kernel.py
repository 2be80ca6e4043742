"""A 3x3, stride-2, zero-padded float32 up-convolution over channels-last
activations, ``signal_conv(x, w, corr=False, strides_up=2,
padding="same_zeros", extra_pad_end=True)``: a hand-written CUDA kernel and
its plain twin.

``conv_up3x3(x, weight)`` takes x ``(N, H, W, cin)`` and the kernel ``(cout,
cin, 3, 3)`` in convolution orientation (torch's OIHW, as
``SignalConv2D.kernel()`` gives it with ``corr=False``) and returns ``(N, 2H,
2W, cout)`` contiguous, each output phase from its own taps::

    out[2i, 2j]         = x[i, j] w[1, 1]
    out[2i, 2j + 1]     = x[i, j] w[1, 2] + x[i, j + 1] w[1, 0]
    out[2i + 1, 2j]     = x[i, j] w[2, 1] + x[i + 1, j] w[0, 1]
    out[2i + 1, 2j + 1] = x[i, j] w[2, 2] + x[i, j + 1] w[2, 0]
                        + x[i + 1, j] w[0, 2] + x[i + 1, j + 1] w[0, 0]

each term ``sum_c x[n, ., ., c] * weight[o, c, ky, kx]``, with x zero past
the high edges, and no bias.

* For a CUDA tensor it launches ``csrc/conv_up3x3.cu`` once (or raises); for
  a CPU tensor it runs the plain twin :func:`conv_up3x3_reference`. There is
  no fallback between the two. ``conv_up3x3.launches`` counts kernel
  launches. No gradient: HiFiC's generator calls it only where none is
  wanted (``models/hific/archs.py``).
* The kernel replaces no TPU kernel: the JAX package leaves every
  convolution to XLA, and the port ran these as ``signal_conv``'s phase
  convolution, 16 taps of which 7 are zeros, and a depth-to-space copy. It
  computes 9 (phase, tap) products in 3xTF32 on the tensor cores and writes
  the interleaved output directly (see the notes in ``csrc/conv_up3x3.cu``).
  Its weight split is :mod:`conv3x3_kernel`'s, of the kernel as it is (the
  kernel reads each phase's taps from a table, so nothing is flipped or
  gathered per call), kept beside the weight tensor while its data and
  version stay the same.
* An output's sum takes one order whatever the batch or its place, so an
  image's rows are the same alone as in a batch, on every run.
"""

from __future__ import annotations

import pathlib

import torch
import torch.nn.functional as F

from compression_tpu_torch.layers.conv3x3_kernel import _check_inputs, _launch
from compression_tpu_torch.util import cuda_build

__all__ = ["PHASE_TAPS", "build", "conv_up3x3", "conv_up3x3_reference"]

_SOURCE = "conv_up3x3.cu"

# The output phases (a, b) in order (0, 0), (0, 1), (1, 0), (1, 1), each as
# its taps ((dy, dx), (ky, kx)): x[i + dy, j + dx] times weight[..., ky, kx].
PHASE_TAPS = (
    (((0, 0), (1, 1)),),
    (((0, 0), (1, 2)), ((0, 1), (1, 0))),
    (((0, 0), (2, 1)), ((1, 0), (0, 1))),
    (((0, 0), (2, 2)), ((0, 1), (2, 0)), ((1, 0), (0, 2)), ((1, 1), (0, 0))),
)


def conv_up3x3_reference(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the kernel (the CPU path and the test oracle):
    each phase a sum of its taps' matrix products, the phases interleaved
    into contiguous ``(N, 2H, 2W, cout)`` rows."""
    n, h, w, _ = x.shape
    xp = F.pad(x, (0, 0, 0, 1, 0, 1))  # a zero column and row past the high edges
    phases = [sum(xp[:, dy:dy + h, dx:dx + w] @ weight[:, :, ky, kx].T
                  for (dy, dx), (ky, kx) in taps) for taps in PHASE_TAPS]
    out = torch.stack(phases, 3).unflatten(3, (2, 2))  # (N, H, W, a, b, cout)
    return out.permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * h, 2 * w, -1)


def build() -> pathlib.Path:
    """Compiles ``csrc/conv_up3x3.cu`` (if not built yet) and returns the
    library path; ptxas's report lands in
    ``cuda_build.build_logs["conv_up3x3.cu"]``."""
    return cuda_build.build(_SOURCE)


def _kernel_forward(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    _check_inputs(x, weight, "conv_up3x3")
    n, h, w, _ = x.shape
    out = torch.empty((n, 2 * h, 2 * w, weight.shape[0]), device=x.device, dtype=x.dtype)
    return _launch("conv_up3x3", conv_up3x3, x, weight, out)


def conv_up3x3(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The stride-2 zero-padded 3x3 up-convolution of channels-last ``x``
    with ``weight`` (see the module docstring), without a gradient.

    CPU tensors run :func:`conv_up3x3_reference`; CUDA tensors launch the
    kernel once, or raise if it cannot (a type other than float32, shapes it
    does not take, x not contiguous, build or launch failure)."""
    if x.device.type == "cpu":
        return conv_up3x3_reference(x, weight)
    if x.device.type != "cuda":
        raise ValueError(f"conv_up3x3: unsupported device {x.device}")
    return _kernel_forward(x, weight)


conv_up3x3.launches = 0
