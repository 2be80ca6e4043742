"""Power-law entropy model for entropy-penalized weights (counterpart of
``compression_tpu/entropy_models/power_law.py``): no prior and no tables.
The training penalty is the closed-form code length of a power-law integer
code, per element

    bits(x) = 2 * log2(|x| + alpha) - 2 * log2(alpha),

about 0 at x = 0 and close to the Elias-gamma length ``2 * floor(log2 m) +
1`` for magnitudes m >= 1 at alpha = 1; the coding is the native
run-length + Elias-gamma coder.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

from compression_tpu_torch.codec import host as codec
from compression_tpu_torch.ops.round_ops import round_st

__all__ = ["PowerLawEntropyModel"]


class PowerLawEntropyModel:
    def __init__(self, coding_rank: int, alpha: float = 1.0):
        if alpha <= 0:
            raise ValueError("alpha must be positive")
        self.coding_rank = int(coding_rank)
        self.alpha = float(alpha)

    def penalty(self, x: torch.Tensor) -> torch.Tensor:
        """Differentiable code-length penalty in bits, per coding unit."""
        bits = 2.0 * (torch.log2(torch.abs(x) + self.alpha) - math.log2(self.alpha))
        return torch.sum(bits, dim=tuple(range(x.ndim - self.coding_rank, x.ndim)))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.penalty(x)

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        return round_st(x)

    def compress(self, x: torch.Tensor) -> List[bytes]:
        """Rounds and codes; one stream per leading-batch element."""
        symbols = np.round(x.detach().cpu().numpy()).astype(np.int32)
        lead = symbols.shape[: symbols.ndim - self.coding_rank]
        flat = symbols.reshape((int(np.prod(lead)) if lead else 1, -1))
        return [codec.run_length_gamma_encode(row) for row in flat]

    def decompress(self, strings: List[bytes], shape: Sequence[int]) -> np.ndarray:
        """float32 NumPy values of ``shape``, the FULL output shape (leading
        batch dims included); its trailing ``coding_rank`` dims are one
        coding unit."""
        shape = tuple(shape)
        unit = shape[len(shape) - self.coding_rank :]
        lead = shape[: len(shape) - self.coding_rank]
        n = int(np.prod(lead)) if lead else 1
        if n != len(strings):
            raise ValueError(f"shape {shape} implies {n} streams, got {len(strings)}")
        rows = [np.asarray(codec.run_length_gamma_decode(s, unit)) for s in strings]
        return np.stack(rows).astype(np.float32).reshape(shape)
