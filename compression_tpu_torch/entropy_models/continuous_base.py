"""Entropy model base: the training helpers (quantization offset,
straight-through quantization, the likelihood in bits) and the CDF tables
for the range coder (counterpart of
``compression_tpu/entropy_models/continuous_base.py``).

Tables are built once, on the host CPU, with the PMF in float64, and turned
into integer CDFs by the C++ quantizer: integer tables that equal the JAX
package's are what lets a blob written by one package decode in the other.

Table build (the JAX package's algorithm, step for step):

1. ``offset`` = the quantization offset (mode-centered, mod 1).
2. ``lo`` / ``hi`` = the tails at ``tail_mass``; each row's grid is the
   integer span covering [lo, hi].
3. PMF: the prior's (noise-convolved) density at the grid points.
4. Leftover mass becomes the escape symbol, the last of each row.
5. ``pmf_to_quantized_cdf`` (C++) quantizes each row at
   ``range_coder_precision`` bits.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from compression_tpu_torch.codec import host as codec
from compression_tpu_torch.distributions import helpers
from compression_tpu_torch.distributions.base import map_tensors
from compression_tpu_torch.ops.round_ops import round_st

__all__ = [
    "CdfTables",
    "ContinuousEntropyModelBase",
    "load_tables",
    "save_tables",
    "uniform_noise",
]


@dataclasses.dataclass(frozen=True)
class CdfTables:
    """Integer range-coder tables (host NumPy; the coder's only input).

    Row i has ``cdf_length[i]`` valid entries (grid points + escape +
    terminator); ``cdf_offset[i]`` is the integer value of grid point 0,
    ``offset[i]`` the fractional quantization offset.
    """

    cdf: np.ndarray          # int32 [num_cdfs, max_len]
    cdf_length: np.ndarray   # int32 [num_cdfs]
    cdf_offset: np.ndarray   # int32 [num_cdfs]
    offset: np.ndarray       # float64 [num_cdfs]
    precision: int

    @property
    def num_cdfs(self) -> int:
        return self.cdf.shape[0]


def save_tables(path: str, tables: dict) -> None:
    """Saves a dict of named CdfTables to one .npz under the JAX package's
    keys (``<name>.cdf``, ``.cdf_length``, ``.cdf_offset``, ``.offset``,
    ``.precision``), written whole and renamed into place, so either
    package reads the other's file."""
    import os

    arrays = {}
    for name, t in tables.items():
        arrays[f"{name}.cdf"] = t.cdf
        arrays[f"{name}.cdf_length"] = t.cdf_length
        arrays[f"{name}.cdf_offset"] = t.cdf_offset
        arrays[f"{name}.offset"] = t.offset
        arrays[f"{name}.precision"] = np.asarray(t.precision)
    tmp = f"{path}.tmp{os.getpid()}.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def load_tables(path: str) -> dict:
    """Inverse of :func:`save_tables`."""
    with np.load(path) as data:
        names = sorted({k.split(".")[0] for k in data.files})
        return {
            name: CdfTables(
                cdf=data[f"{name}.cdf"],
                cdf_length=data[f"{name}.cdf_length"],
                cdf_offset=data[f"{name}.cdf_offset"],
                offset=data[f"{name}.offset"],
                precision=int(data[f"{name}.precision"]),
            )
            for name in names
        }


def uniform_noise(y: torch.Tensor, generator: Optional[torch.Generator]):
    """U(-1/2, 1/2) noise shaped like ``y``, drawn from ``generator`` on
    y's device (the training-mode quantization surrogate)."""
    if generator is None:
        raise ValueError("training=True requires a generator for the noise")
    return torch.rand(y.shape, generator=generator, dtype=y.dtype,
                      device=y.device) - 0.5


def _host64(t) -> np.ndarray:
    return np.asarray(torch.as_tensor(t).detach().cpu().double().numpy(),
                      np.float64).reshape(-1)


class ContinuousEntropyModelBase:
    """Shared table machinery of the continuous entropy models.

    Args:
      prior: distribution whose batch shape is the per-element prior layout
        (the table build copies it to the CPU: host work, as in the JAX
        package).
      coding_rank: trailing dims forming one coding unit (one bitstream).
      compression: build the range-coder tables now.
      tail_mass: probability mass allowed outside the tabulated range.
      range_coder_precision: CDF precision in bits.
      laplace_tail_mass: if > 0, the training likelihood is mixed with a
        Laplace(0, 1) floor so rate gradients never vanish in dead zones.
      offset_heuristic: center the quantization grids on the prior's mode.
      tables: prebuilt tables (skips the build).
    """

    def __init__(self, prior, coding_rank: int, *, compression: bool = False,
                 tail_mass: float = 2.0 ** -8,
                 range_coder_precision: int = 12,
                 laplace_tail_mass: float = 0.0,
                 offset_heuristic: bool = True,
                 tables: Optional[CdfTables] = None):
        self.prior = prior
        self.coding_rank = int(coding_rank)
        self.tail_mass = float(tail_mass)
        self.range_coder_precision = int(range_coder_precision)
        self.laplace_tail_mass = float(laplace_tail_mass)
        self.offset_heuristic = bool(offset_heuristic)
        self.tables: Optional[CdfTables] = tables
        if compression and self.tables is None:
            self.tables = self.build_tables()

    @property
    def prior_batch_shape(self) -> Tuple[int, ...]:
        return tuple(self.prior.batch_shape)

    # -- training-side helpers ----------------------------------------------

    def quantization_offset(self) -> torch.Tensor:
        """The grid offset (mod 1) from the prior's mode, without gradient:
        a placement decision, and its root-find has no derivative."""
        with torch.no_grad():
            if not self.offset_heuristic:
                return torch.zeros(self.prior_batch_shape)
            return helpers.quantization_offset(self.prior)

    def quantize(self, y: torch.Tensor, offset=None) -> torch.Tensor:
        """Round to the offset grid with straight-through gradients."""
        if offset is None:
            offset = self.quantization_offset().to(y.device)
        return round_st(y, offset)

    def _log2_prob(self, prior, y: torch.Tensor) -> torch.Tensor:
        """Training likelihood in bits, with the optional Laplace mix."""
        log_p = prior.log_prob(y)
        if self.laplace_tail_mass > 0.0:
            m = self.laplace_tail_mass
            # Laplace(0, 1) density as a gradient-carrying floor.
            laplace_log = -torch.abs(y) - math.log(2.0)
            log_p = torch.logaddexp(log_p + math.log1p(-m),
                                    laplace_log + math.log(m))
        return log_p / math.log(2.0)

    def _bits(self, log2_p: torch.Tensor, ndim: int) -> torch.Tensor:
        """Bits per coding unit: minus the sum over the ``coding_rank``
        trailing dims."""
        return -torch.sum(log2_p, dim=tuple(range(ndim - self.coding_rank, ndim)))

    def _table_offsets(self, prior) -> np.ndarray:
        """Fractional grid offsets per CDF row (the universal models
        override this with their dither)."""
        if not self.offset_heuristic:
            return np.zeros(int(np.prod(prior.batch_shape)), np.float64)
        return _host64(helpers.quantization_offset(prior))

    def build_tables(self, prior=None) -> CdfTables:
        """Builds integer CDF tables from the prior, on the host CPU in
        float64 (a prior on the card is copied to the CPU first)."""
        prior = self.prior if prior is None else prior
        with torch.no_grad():
            prior = map_tensors(lambda t: t.detach().cpu(), prior)
            return self._build_tables_impl(prior)

    def _build_tables_impl(self, prior) -> CdfTables:
        offsets_overridden = (
            type(self)._table_offsets
            is not ContinuousEntropyModelBase._table_offsets
        )
        grid_fn = getattr(prior, "_grid_points", None)
        pts = (
            grid_fn(self.tail_mass)
            if grid_fn is not None and self.offset_heuristic
            and not offsets_overridden else None
        )
        if pts is not None:
            # One root-find for offset and both tails (DeepFactorized).
            offset = _host64(pts[0])
            offset -= np.round(offset)
            lo, hi = _host64(pts[1]), _host64(pts[2])
        else:
            offset = self._table_offsets(prior)
            lo = _host64(helpers.lower_tail(prior, self.tail_mass))
            hi = _host64(helpers.upper_tail(prior, self.tail_mass))

        minima = np.floor(lo - offset).astype(np.int64)
        maxima = np.ceil(hi - offset).astype(np.int64)
        lengths = (maxima - minima + 1).astype(np.int64)
        max_len = int(lengths.max()) if lengths.size else 1
        num = offset.size

        # PMF on the integer grid, one prior evaluation for all rows: the
        # grid axis goes first so it broadcasts against the batch shape.
        grid = minima[:, None] + np.arange(max_len)[None, :]
        x = torch.from_numpy(grid + offset[:, None])
        xx = x.T.reshape((max_len,) + tuple(prior.batch_shape))
        pmf = prior.prob(xx).double().numpy()
        pmf = np.moveaxis(pmf.reshape(max_len, num), 0, 1)
        valid = np.arange(max_len)[None, :] < lengths[:, None]
        pmf = np.where(valid, pmf, 0.0)
        pmf = np.clip(pmf, 0.0, None)
        escape = np.clip(1.0 - pmf.sum(axis=1), 2.0 ** -20, 1.0)

        # Rows [pmf_0 .. pmf_{L-1}, escape]: L + 1 symbols each.
        padded = np.zeros((num, max_len + 1), np.float64)
        padded[:, :max_len] = pmf
        padded[np.arange(num), lengths] = escape
        sym_lengths = (lengths + 1).astype(np.int32)

        cdf = codec.pmf_to_quantized_cdf(
            padded, sym_lengths, self.range_coder_precision
        )
        return CdfTables(
            cdf=cdf.astype(np.int32),
            cdf_length=(sym_lengths + 1).astype(np.int32),
            cdf_offset=minima.astype(np.int32),
            offset=offset,
            precision=self.range_coder_precision,
        )

    def _require_tables(self) -> CdfTables:
        if self.tables is None:
            raise RuntimeError(
                "This entropy model was built with compression=False; pass "
                "compression=True (or call build_tables) before coding."
            )
        return self.tables
