"""Indexed entropy models: one CDF row per scale index (counterpart of
``compression_tpu/entropy_models/continuous_indexed.py``; the hyperprior
models code y with it).

The hyper-synthesis predicts a scale per element; the scale is quantized
onto the log-spaced table (SCALES_MIN..SCALES_MAX, 64 levels) and the index
selects the element's CDF row. Training keeps the indexes continuous
(clipped with identity-if-towards bounds, so gradients keep flowing into
the network that predicts them); only the coding path rounds them.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

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
      index_ranges: levels of the (single) index dimension.
      parameter_fns: parameter name -> fn(indexes), evaluated on the float32
        integer grid for the table build.
      coding_rank: trailing dims forming one coding unit.
    """

    def __init__(self, prior_fn: Callable, index_ranges: Sequence[int],
                 parameter_fns: Dict[str, Callable], coding_rank: int, *,
                 compression: bool = False, tail_mass: float = 2.0 ** -8,
                 range_coder_precision: int = 12,
                 laplace_tail_mass: float = 0.0, tables=None):
        self.prior_fn = prior_fn
        self.index_ranges = tuple(int(r) for r in index_ranges)
        if len(self.index_ranges) != 1:
            raise NotImplementedError("only one index dimension is ported")
        self.parameter_fns = dict(parameter_fns)
        grid = torch.arange(self.index_ranges[0], dtype=torch.float32)
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
        """Clips continuous indexes into [0, levels - 1], differentiably."""
        return upper_bound(lower_bound(indexes, 0.0), self.index_ranges[0] - 1)

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

    def decode_symbols(self, strings: List[bytes], flat_rows) -> np.ndarray:
        """Decodes to int32 values against precomputed rows."""
        tables = self._require_tables()
        flat_rows = np.asarray(flat_rows, np.int32)
        n = len(strings)
        return codec.entropy_decode(
            strings, flat_rows.reshape(n, -1), tables.cdf, tables.cdf_length,
            tables.cdf_offset, tables.precision,
        )


class LocationScaleIndexedEntropyModel:
    """Scale-indexed model over a location-scale family (the class every
    hyperprior codec codes y with); the scale table defaults to the standard
    log-spaced one."""

    def __init__(self, prior_fn: Callable, num_scales: int = SCALES_LEVELS,
                 coding_rank: int = 1, *, scales_min: float = SCALES_MIN,
                 scales_max: float = SCALES_MAX, compression: bool = False,
                 tail_mass: float = 2.0 ** -8,
                 range_coder_precision: int = 12,
                 laplace_tail_mass: float = 0.0, tables=None):
        self.scale_fn = lambda i: log_scale_fn(  # noqa: E731
            i, scales_min, scales_max, num_scales
        )
        self.inverse_scale_fn = lambda s: inverse_log_scale_fn(  # noqa: E731
            s, scales_min, scales_max, num_scales
        )
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

    def rows(self, scale: torch.Tensor) -> torch.Tensor:
        """Canonical scale -> CDF row map, shared by the encode and decode
        paths: ``round(clip((log(scale) - log(SCALES_MIN)) / step, 0,
        levels - 1))`` in the narrowest unsigned dtype (uint8 for 64
        levels), on the scale's device."""
        levels = self._em.index_ranges[0]
        if levels > 256:
            raise NotImplementedError("rows() is ported for <= 256 levels")
        idx = self.inverse_scale_fn(scale).clamp(0.0, levels - 1)
        return torch.round(idx).to(torch.uint8)

    def compress_symbols(self, symbols, flat_indexes) -> List[bytes]:
        return self._em.compress_symbols(symbols, flat_indexes)

    def decode_symbols(self, strings, flat_rows) -> np.ndarray:
        return self._em.decode_symbols(strings, flat_rows)
