"""Batched entropy model: one prior per channel, shared across positions
(counterpart of ``compression_tpu/entropy_models/continuous_batched.py``
coding path; bmshj2018 codes z with it).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from compression_tpu_torch.codec import host as codec
from compression_tpu_torch.entropy_models.continuous_base import (
    ContinuousEntropyModelBase,
)

__all__ = ["ContinuousBatchedEntropyModel"]


class ContinuousBatchedEntropyModel(ContinuousEntropyModelBase):
    def __init__(self, prior, coding_rank: int, **kwargs):
        if coding_rank < len(prior.batch_shape):
            raise ValueError(
                f"coding_rank ({coding_rank}) must cover the prior batch "
                f"shape {prior.batch_shape}"
            )
        super().__init__(prior, coding_rank, **kwargs)

    def _flat_indexes(self, unit_shape: Tuple[int, ...]) -> np.ndarray:
        """Flat prior index for every element of one coding unit."""
        pshape = self.prior_batch_shape
        num = int(np.prod(pshape)) if pshape else 1
        idx = np.arange(num, dtype=np.int32).reshape(pshape if pshape else ())
        return np.ascontiguousarray(
            np.broadcast_to(idx, unit_shape).reshape(-1), np.int32
        )

    def _split_shapes(self, shape: Sequence[int]):
        shape = tuple(shape)
        batch = shape[: len(shape) - self.coding_rank]
        unit = shape[len(shape) - self.coding_rank :]
        pshape = self.prior_batch_shape
        if pshape and shape[len(shape) - len(pshape) :] != pshape:
            raise ValueError(
                f"Trailing dims of {shape} do not match prior batch shape {pshape}"
            )
        return batch, unit

    def symbol_offset(self, device="cpu") -> torch.Tensor:
        """The grid offset as float32: ``symbols = round(y - offset)``,
        ``y_hat = symbols + offset``."""
        tables = self._require_tables()
        return torch.as_tensor(
            tables.offset.reshape(self.prior_batch_shape).astype(np.float32),
            device=device,
        )

    def compress_symbols(self, symbols: np.ndarray) -> List[bytes]:
        """Codes precomputed int32 symbols ``round(y - symbol_offset())``."""
        tables = self._require_tables()
        symbols = np.asarray(symbols, np.int32)
        _, unit = self._split_shapes(symbols.shape)
        symbols = symbols.reshape((-1,) + unit)
        indexes = self._flat_indexes(unit)
        n = symbols.shape[0]
        return codec.entropy_encode(
            symbols.reshape(n, -1),
            np.broadcast_to(indexes, (n, indexes.size)),
            tables.cdf, tables.cdf_length, tables.cdf_offset, tables.precision,
        )

    def decompress(self, strings: List[bytes],
                   broadcast_shape: Sequence[int]) -> np.ndarray:
        """Inverse of :meth:`compress_symbols`: float32 NumPy ``y_hat`` of shape
        ``(n, *broadcast_shape, *prior_batch_shape)``; ``broadcast_shape``
        is the coding unit without the prior's dims."""
        tables = self._require_tables()
        unit = tuple(broadcast_shape) + self.prior_batch_shape
        indexes = self._flat_indexes(unit)
        n = len(strings)
        values = codec.entropy_decode(
            strings, np.broadcast_to(indexes, (n, indexes.size)),
            tables.cdf, tables.cdf_length, tables.cdf_offset, tables.precision,
        )
        offset = tables.offset.reshape(self.prior_batch_shape)
        return values.reshape((n,) + unit).astype(np.float32) + offset.astype(
            np.float32
        )
