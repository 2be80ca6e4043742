"""Indexed entropy models: one CDF row per scale index (counterpart of
``compression_tpu/entropy_models/continuous_indexed.py``; the hyperprior
models code y with it).

The hyper-synthesis predicts a scale per element; the scale is quantized
onto the log-spaced table (SCALES_MIN..SCALES_MAX, 64 levels) and the index
selects the element's CDF row. With several index dimensions, one row is
tabulated per index combination (row-major, ``np.ravel_multi_index``).
Training keeps the indexes continuous (clipped with identity-if-towards
bounds, so gradients keep flowing into the network that predicts them);
only the coding path rounds them.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from compression_tpu_torch.codec import host as codec
from compression_tpu_torch.entropy_models.continuous_base import (
    ContinuousEntropyModelBase,
    uniform_noise,
)
from compression_tpu_torch.ops.math_ops import lower_bound, upper_bound
from compression_tpu_torch.ops.round_ops import round_st

__all__ = [
    "ContinuousIndexedEntropyModel",
    "LocationScaleIndexedEntropyModel",
    "SCALES_MIN",
    "SCALES_MAX",
    "SCALES_LEVELS",
    "log_scale_fn",
    "inverse_log_scale_fn",
]

SCALES_MIN = 0.11
SCALES_MAX = 256.0
SCALES_LEVELS = 64


def _log_step(scales_min, scales_max, levels) -> float:
    return (math.log(scales_max) - math.log(scales_min)) / (levels - 1)


def log_scale_fn(i, scales_min=SCALES_MIN, scales_max=SCALES_MAX,
                 levels=SCALES_LEVELS):
    """index -> scale on the log-linear grid (in the index's dtype)."""
    step = _log_step(scales_min, scales_max, levels)
    return torch.exp(math.log(scales_min) + step * i)


def inverse_log_scale_fn(scale, scales_min=SCALES_MIN, scales_max=SCALES_MAX,
                         levels=SCALES_LEVELS):
    """scale -> continuous index on the log-linear grid."""
    step = _log_step(scales_min, scales_max, levels)
    return (torch.log(scale) - math.log(scales_min)) / step


class ContinuousIndexedEntropyModel(ContinuousEntropyModelBase):
    """Entropy model whose prior parameters are functions of an index.

    Args:
      prior_fn: callable(**params) -> distribution.
      index_ranges: levels per index dimension. With one entry ``indexes``
        has the input's shape; with ``k`` entries a trailing length-``k``
        dimension.
      parameter_fns: parameter name -> fn(indexes), evaluated on continuous
        indexes in training and on the float32 integer grid for the tables.
      coding_rank: trailing dims forming one coding unit.
    """

    def __init__(self, prior_fn: Callable, index_ranges: Sequence[int],
                 parameter_fns: Dict[str, Callable], coding_rank: int, *,
                 compression: bool = False, tail_mass: float = 2.0 ** -8,
                 range_coder_precision: int = 12,
                 laplace_tail_mass: float = 0.0, tables=None):
        self.prior_fn = prior_fn
        self.index_ranges = tuple(int(r) for r in index_ranges)
        self.parameter_fns = dict(parameter_fns)
        axes = [torch.arange(r, dtype=torch.float32) for r in self.index_ranges]
        if len(axes) == 1:
            grid = axes[0]
        else:
            grid = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
        super().__init__(
            self._make_prior(grid), coding_rank, compression=False,
            tail_mass=tail_mass, range_coder_precision=range_coder_precision,
            laplace_tail_mass=laplace_tail_mass, offset_heuristic=False,
        )
        if tables is not None:
            self.tables = tables
        elif compression:
            self.tables = self.build_tables()

    def _make_prior(self, indexes):
        params = {k: fn(indexes) for k, fn in self.parameter_fns.items()}
        return self.prior_fn(**params)

    def _normalize_indexes(self, indexes: torch.Tensor) -> torch.Tensor:
        """Clips continuous indexes into each dimension's [0, levels - 1],
        differentiably."""
        indexes = torch.as_tensor(indexes)
        if len(self.index_ranges) == 1:
            return upper_bound(lower_bound(indexes, 0.0), self.index_ranges[0] - 1)
        return torch.stack([
            upper_bound(lower_bound(indexes[..., d], 0.0), r - 1)
            for d, r in enumerate(self.index_ranges)], dim=-1)

    def _flat_int_indexes(self, indexes) -> np.ndarray:
        """Rounded, normalized indexes (on their device), fetched, with
        multi-dimensional combinations flattened row-major: int32 CDF rows."""
        with torch.no_grad():
            idx = torch.round(self._normalize_indexes(indexes))
        idx = idx.cpu().numpy().astype(np.int64)
        if len(self.index_ranges) == 1:
            return idx.astype(np.int32)
        flat = np.ravel_multi_index(
            tuple(idx[..., d] for d in range(idx.shape[-1])), self.index_ranges)
        return flat.astype(np.int32)

    def device_indexes(self, indexes: torch.Tensor) -> torch.Tensor:
        """The int32 CDF rows of :meth:`_flat_int_indexes`, left on the
        indexes' device."""
        idx = torch.round(self._normalize_indexes(indexes)).to(torch.int32)
        if len(self.index_ranges) == 1:
            return idx
        strides = np.cumprod((self.index_ranges + (1,))[::-1])[::-1][1:]
        return torch.sum(
            idx * torch.as_tensor(strides.astype(np.int32), device=idx.device),
            dim=-1).to(torch.int32)

    def __call__(self, y: torch.Tensor, indexes: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 training: bool = True):
        """Returns ``(y_tilde, bits)``; bits summed over the coding_rank
        dims. ``training`` adds U(-1/2, 1/2) noise from ``generator``;
        otherwise y is rounded with straight-through gradients."""
        prior = self._make_prior(self._normalize_indexes(indexes))
        if training:
            y_tilde = y + uniform_noise(y, generator)
        else:
            y_tilde = round_st(y)
        return y_tilde, self._bits(self._log2_prob(prior, y_tilde), y.ndim)

    def _batch_split(self, shape: Sequence[int]) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        shape = tuple(shape)
        return shape[: len(shape) - self.coding_rank], shape[len(shape) - self.coding_rank :]

    def compress(self, y: torch.Tensor, indexes) -> List[bytes]:
        """Codes ``round(y)`` against each element's row, one bitstream per
        leading-batch element."""
        batch, _ = self._batch_split(y.shape)
        n = int(np.prod(batch)) if batch else 1
        with torch.no_grad():
            symbols = torch.round(y).to(torch.int32).cpu().numpy().reshape(n, -1)
        return self.compress_symbols(
            symbols, self._flat_int_indexes(indexes).reshape(n, -1))

    def compress_symbols(self, symbols: np.ndarray,
                         flat_indexes: np.ndarray) -> List[bytes]:
        """Codes precomputed int32 symbols against flat CDF rows."""
        tables = self._require_tables()
        symbols = np.asarray(symbols, np.int32)
        n = symbols.shape[0] if symbols.ndim > 1 else 1
        return codec.entropy_encode(
            symbols.reshape(n, -1),
            np.asarray(flat_indexes, np.int32).reshape(n, -1),
            tables.cdf, tables.cdf_length, tables.cdf_offset, tables.precision,
        )

    def decompress(self, strings: List[bytes], indexes) -> np.ndarray:
        """Inverse of :meth:`compress`: float32 NumPy values shaped like the
        index rows."""
        flat_idx = self._flat_int_indexes(indexes)
        return self.decompress_rows(strings, flat_idx, flat_idx.shape)

    def decode_symbols(self, strings: List[bytes], flat_rows) -> np.ndarray:
        """Decodes to int32 values against precomputed rows."""
        tables = self._require_tables()
        flat_rows = np.asarray(flat_rows, np.int32)
        n = len(strings)
        return codec.entropy_decode(
            strings, flat_rows.reshape(n, -1), tables.cdf, tables.cdf_length,
            tables.cdf_offset, tables.precision,
        )

    def decompress_rows(self, strings: List[bytes], flat_rows, shape) -> np.ndarray:
        """Decodes against precomputed int32 CDF rows to float32 NumPy of
        ``shape`` (encoder and decoder must derive the rows alike)."""
        return self.decode_symbols(strings, flat_rows).reshape(shape).astype(np.float32)


def _host(t) -> np.ndarray:
    return torch.as_tensor(t).detach().cpu().numpy()


class LocationScaleIndexedEntropyModel:
    """Scale-indexed model over a location-scale family (the class every
    hyperprior codec codes y with); the mean is subtracted before coding and
    added back after. ``scale_fn`` / ``inverse_scale_fn`` default to the
    standard log-spaced table."""

    def __init__(self, prior_fn: Callable, num_scales: int = SCALES_LEVELS,
                 scale_fn: Optional[Callable] = None,
                 inverse_scale_fn: Optional[Callable] = None,
                 coding_rank: int = 1, *, scales_min: float = SCALES_MIN,
                 scales_max: float = SCALES_MAX, compression: bool = False,
                 tail_mass: float = 2.0 ** -8,
                 range_coder_precision: int = 12,
                 laplace_tail_mass: float = 0.0, tables=None):
        if scale_fn is None:
            scale_fn = lambda i: log_scale_fn(  # noqa: E731
                i, scales_min, scales_max, num_scales)
        if inverse_scale_fn is None:
            inverse_scale_fn = lambda s: inverse_log_scale_fn(  # noqa: E731
                s, scales_min, scales_max, num_scales)
        self.scale_fn = scale_fn
        self.inverse_scale_fn = inverse_scale_fn
        self._em = ContinuousIndexedEntropyModel(
            prior_fn=lambda scale: prior_fn(
                loc=torch.zeros_like(scale), scale=scale
            ),
            index_ranges=(num_scales,),
            parameter_fns={"scale": self.scale_fn},
            coding_rank=coding_rank,
            compression=compression,
            tail_mass=tail_mass,
            range_coder_precision=range_coder_precision,
            laplace_tail_mass=laplace_tail_mass,
            tables=tables,
        )

    @property
    def tables(self):
        return self._em.tables

    def __call__(self, y: torch.Tensor, scale: torch.Tensor, loc=None,
                 generator: Optional[torch.Generator] = None,
                 training: bool = True):
        """Returns ``(y_tilde, bits)`` of y under the noisy prior at
        ``scale`` (and ``loc``, subtracted before and added back after)."""
        indexes = self.inverse_scale_fn(scale)
        center = y if loc is None else y - loc
        y_tilde, bits = self._em(center, indexes, generator, training)
        if loc is not None:
            y_tilde = y_tilde + loc
        return y_tilde, bits

    def quantize(self, y: torch.Tensor, loc=None) -> torch.Tensor:
        """Straight-through rounding (around ``loc`` when given)."""
        if loc is None:
            return round_st(y)
        return round_st(y - loc) + loc

    def device_symbols(self, y: torch.Tensor, scale: torch.Tensor, loc=None):
        """int32 ``(symbols, flat_indexes)`` on y's device, for
        :meth:`compress_symbols`."""
        center = y if loc is None else y - loc
        symbols = torch.round(center).to(torch.int32)
        return symbols, self._em.device_indexes(self.inverse_scale_fn(scale))

    def rows(self, scale: torch.Tensor) -> torch.Tensor:
        """Canonical scale -> CDF row map, shared by the encode and decode
        paths: the rounded, clipped ``inverse_scale_fn(scale)`` in the
        narrowest dtype that holds the table (uint8 up to 256 levels, uint16
        up to 65536, else int32), on the scale's device."""
        levels = self._em.index_ranges[0]
        rows = torch.round(self.inverse_scale_fn(scale).clamp(0.0, levels - 1))
        if levels <= 256:
            return rows.to(torch.uint8)
        rows = rows.to(torch.int32)
        return rows.to(torch.uint16) if levels <= 65536 else rows

    def compress_symbols(self, symbols, flat_indexes) -> List[bytes]:
        return self._em.compress_symbols(symbols, flat_indexes)

    def decode_symbols(self, strings, flat_rows) -> np.ndarray:
        return self._em.decode_symbols(strings, flat_rows)

    def decompress_rows(self, strings, flat_rows, shape, loc=None):
        values = self._em.decompress_rows(strings, flat_rows, shape)
        return values if loc is None else values + _host(loc)

    def compress(self, y: torch.Tensor, scale: torch.Tensor, loc=None) -> List[bytes]:
        center = y if loc is None else y - loc
        return self._em.compress(center, self.inverse_scale_fn(scale))

    def decompress(self, strings, scale: torch.Tensor, loc=None) -> np.ndarray:
        values = self._em.decompress(strings, self.inverse_scale_fn(scale))
        return values if loc is None else values + _host(loc)
