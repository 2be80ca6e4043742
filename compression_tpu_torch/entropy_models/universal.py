"""Universal-quantization entropy models (counterpart of
``compression_tpu/entropy_models/universal.py``; Agustsson & Theis 2020).

Element ``e`` is reconstructed as ``round(y_e - u_e) + u_e`` with a dither
``u_e`` in (-1/2, 1/2) that is a fixed function of the element's position,
shared by encoder and decoder: the golden-ratio sequence
``(i * phi + phi / 2) mod 1``, quantized to ``num_noise_levels`` values.
The dither is computed in float64 NumPy, as in the JAX package: in float32
the sequence moves elements to other levels, and with them CDF rows and
bytes. The indexed model tabulates one CDF row per (index combination,
noise level), combo-major and level-minor.

Training (``training=True``) adds U(-1/2, 1/2) noise from a
``torch.Generator``; with ``expected_grads`` the rate's gradient w.r.t. y
is the exact derivative of its expectation over the noise
(:func:`~compression_tpu_torch.ops.math_ops.perturb_and_apply`).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from compression_tpu_torch.codec import host as codec
from compression_tpu_torch.distributions.base import map_tensors
from compression_tpu_torch.entropy_models.continuous_base import uniform_noise
from compression_tpu_torch.entropy_models.continuous_batched import (
    ContinuousBatchedEntropyModel,
)
from compression_tpu_torch.entropy_models.continuous_indexed import (
    ContinuousIndexedEntropyModel,
)
from compression_tpu_torch.ops.math_ops import perturb_and_apply
from compression_tpu_torch.ops.round_ops import round_st

__all__ = ["UniversalBatchedEntropyModel", "UniversalIndexedEntropyModel"]

_PHI = 0.6180339887498949  # golden ratio conjugate


def _levels(indices: np.ndarray, num_levels: int) -> np.ndarray:
    """Noise level of each element index (float64 NumPy)."""
    u = (indices.astype(np.float64) * _PHI + 0.5 * _PHI) % 1.0
    return np.floor(u * num_levels)


def _dither(indices: np.ndarray, num_levels: int) -> np.ndarray:
    """Quantized low-discrepancy offsets in (-1/2, 1/2) per element index."""
    return (_levels(indices, num_levels) + 0.5) / num_levels - 0.5


class UniversalBatchedEntropyModel(ContinuousBatchedEntropyModel):
    """Batched entropy model with a deterministic dither per channel."""

    def __init__(self, prior, coding_rank: int, *, num_noise_levels: int = 15,
                 expected_grads: bool = True, **kwargs):
        self.num_noise_levels = int(num_noise_levels)
        self.expected_grads = bool(expected_grads)
        kwargs.setdefault("offset_heuristic", False)
        super().__init__(prior, coding_rank, **kwargs)

    def _table_offsets(self, prior) -> np.ndarray:
        num = int(np.prod(prior.batch_shape)) if prior.batch_shape else 1
        return _dither(np.arange(num), self.num_noise_levels)

    def dither_offsets(self, dtype=torch.float32, device="cpu") -> torch.Tensor:
        """The per-channel dither shaped like the prior batch: the codec's
        grid, which eval-mode quantization uses too."""
        pshape = tuple(self.prior.batch_shape)
        u = self._table_offsets(self.prior).reshape(pshape)
        return torch.as_tensor(u, dtype=dtype, device=device)

    def quantize(self, y: torch.Tensor, offset=None) -> torch.Tensor:
        if offset is None:
            offset = self.dither_offsets(y.dtype, y.device)
        return super().quantize(y, offset)

    def __call__(self, y: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 training: bool = True):
        """``(y_tilde, bits)``; in training with the expected-gradient rate
        (``expected_grads``) or a one-sample one."""
        if not training:
            return super().__call__(y, generator, training=False)
        u = uniform_noise(y, generator)
        if not self.expected_grads:
            y_tilde = y + u
            return y_tilde, self._bits(self._log2_prob(self.prior, y_tilde), y.ndim)
        log2_p = perturb_and_apply(lambda t: self._log2_prob(self.prior, t), y, u)
        return y + u, self._bits(log2_p, y.ndim)


class UniversalIndexedEntropyModel(ContinuousIndexedEntropyModel):
    """Indexed entropy model with a deterministic dither per position: an
    element at flat position ``p`` of its coding unit uses noise level
    ``level(p)``, so its CDF row is ``flat_index * num_noise_levels +
    level(p)``."""

    def __init__(self, prior_fn: Callable, index_ranges: Sequence[int],
                 parameter_fns: Dict[str, Callable], coding_rank: int, *,
                 num_noise_levels: int = 15, expected_grads: bool = True,
                 **kwargs):
        self.num_noise_levels = int(num_noise_levels)
        self.expected_grads = bool(expected_grads)
        self._offset_override = None
        super().__init__(prior_fn, index_ranges, parameter_fns, coding_rank,
                         **kwargs)

    def build_tables(self, prior=None):
        """All (index combination, noise level) rows in one pass: the grid
        prior tiled with a noise-level axis after its batch dims (parameter
        tensors may carry trailing dims), so the flattened rows are
        combo-major and level-minor; each level's grid offset is its dither
        value."""
        if prior is not None:
            return super().build_tables(prior)
        L = self.num_noise_levels
        u = (np.arange(L) + 0.5) / L - 0.5
        num = int(np.prod(self.index_ranges))
        nb = len(self.prior.batch_shape)

        def tile(a):
            a = a.unsqueeze(nb)
            return a.expand(a.shape[:nb] + (L,) + a.shape[nb + 1:])

        tiled = map_tensors(tile, self.prior)
        self._offset_override = np.tile(u, num)
        try:
            return super().build_tables(tiled)
        finally:
            self._offset_override = None

    def _table_offsets(self, prior) -> np.ndarray:
        if self._offset_override is not None:
            return self._offset_override
        return super()._table_offsets(prior)

    def _position_levels(self, unit_size: int) -> np.ndarray:
        return _levels(np.arange(unit_size), self.num_noise_levels).astype(np.int64)

    def _position_dither(self, unit_size: int) -> np.ndarray:
        return _dither(np.arange(unit_size), self.num_noise_levels)

    def __call__(self, y: torch.Tensor, indexes: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 training: bool = True):
        """``(y_tilde, bits)``. In training with ``expected_grads`` the
        normalized indexes go to ``perturb_and_apply`` as an argument, so
        gradients reach the network that predicts them. Eval quantizes onto
        the per-position dithered grid the codec uses."""
        if training and not self.expected_grads:
            return super().__call__(y, indexes, generator, training=True)
        norm_idx = self._normalize_indexes(indexes)
        if training:
            u = uniform_noise(y, generator)
            log2_p = perturb_and_apply(
                lambda t, idx: self._log2_prob(self._make_prior(idx), t),
                y, u, norm_idx)
            return y + u, self._bits(log2_p, y.ndim)
        unit = tuple(y.shape[y.ndim - self.coding_rank:])
        m = int(np.prod(unit))
        u = torch.as_tensor(self._position_dither(m).reshape(unit),
                            dtype=y.dtype, device=y.device)
        y_hat = round_st(y - u) + u
        prior = self._make_prior(norm_idx)
        return y_hat, self._bits(self._log2_prob(prior, y_hat), y.ndim)

    def _rows(self, flat_idx: np.ndarray, n: int, m: int) -> np.ndarray:
        levels = self._position_levels(m)
        return (flat_idx.reshape(n, m).astype(np.int64) * self.num_noise_levels
                + levels[None, :]).astype(np.int32)

    def compress(self, y: torch.Tensor, indexes) -> List[bytes]:
        """Codes ``round(y - u)`` (float64 on the host) against each
        element's (index, level) row; one bitstream per leading-batch
        element."""
        tables = self._require_tables()
        batch, unit = self._batch_split(y.shape)
        n = int(np.prod(batch)) if batch else 1
        m = int(np.prod(unit))
        u = self._position_dither(m)
        y_host = y.detach().cpu().numpy().astype(np.float64).reshape(n, m)
        symbols = np.round(y_host - u[None, :]).astype(np.int32)
        rows = self._rows(self._flat_int_indexes(indexes), n, m)
        return codec.entropy_encode(
            symbols, rows, tables.cdf, tables.cdf_length, tables.cdf_offset,
            tables.precision)

    def decompress(self, strings: List[bytes], indexes) -> np.ndarray:
        """Inverse of :meth:`compress`: float32 NumPy ``y_hat`` (the decoded
        integers plus the dither, in float64, then rounded to float32)
        shaped like ``indexes`` (without its trailing index dimension when
        there are several)."""
        tables = self._require_tables()
        flat_idx = self._flat_int_indexes(indexes)
        n = len(strings)
        m = flat_idx.size // n
        values = codec.entropy_decode(
            strings, self._rows(flat_idx, n, m), tables.cdf, tables.cdf_length,
            tables.cdf_offset, tables.precision)
        y_hat = values.reshape(n, m).astype(np.float64) + self._position_dither(m)[None, :]
        return y_hat.reshape(flat_idx.shape).astype(np.float32)
