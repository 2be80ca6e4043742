"""Device selection and the float32 settings the codec's bitstream needs."""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "strict_fp32"]


def resolve_device(device="cuda") -> torch.device:
    """Returns ``torch.device(device)``; raises if CUDA is asked for and
    absent. Entry points default to CUDA and never fall back to the CPU:
    a caller that wants the CPU passes ``device="cpu"``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device


def strict_fp32() -> None:
    """Pins float32 math on the card: no TF32 in matmuls or convolutions
    (TF32 keeps ~3 decimal digits), and deterministic cuDNN algorithms so
    encoder and decoder derive the same CDF rows run after run."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
