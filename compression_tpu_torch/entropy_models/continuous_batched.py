"""Batched entropy model: one prior per channel, shared across positions
(counterpart of ``compression_tpu/entropy_models/continuous_batched.py``;
the hyperprior models code z with it, bls2017 codes y).

Training: ``em(y, generator, training=True)`` returns ``(y_tilde, bits)``
with additive uniform noise drawn from ``generator`` (on y's device);
``training=False`` quantizes with straight-through gradients instead. The
model is cheap to build around a prior whose parameters carry gradients,
once a step. Coding: the range-coder paths below, on host tables.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from compression_tpu_torch.codec import host as codec
from compression_tpu_torch.entropy_models.continuous_base import (
    ContinuousEntropyModelBase,
    uniform_noise,
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

    def __call__(self, y: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 training: bool = True):
        """Returns ``(y_tilde, bits)``; bits summed per coding unit.

        Args:
          y: ``(*batch, *coding_unit)`` with the prior's batch shape aligned
            to the trailing dims.
          generator: source of the U(-1/2, 1/2) noise (training only), on
            y's device.
          training: additive noise if True, else straight-through rounding.
        """
        if training:
            y_tilde = y + uniform_noise(y, generator)
        else:
            y_tilde = self.quantize(y)
        return y_tilde, self._bits(self._log2_prob(self.prior, y_tilde), y.ndim)

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

    def compress(self, y: torch.Tensor) -> List[bytes]:
        """Codes ``y``, one bitstream per leading-batch element: the symbols
        ``round(y - symbol_offset())`` are taken in float32 on y's device,
        then fetched and range-coded on the host."""
        _, unit = self._split_shapes(y.shape)
        offset = self.symbol_offset(y.device)
        symbols = torch.round(y.to(torch.float32) - offset).to(torch.int32)
        return self.compress_symbols(symbols.cpu().numpy().reshape((-1,) + unit))

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
