"""The reference codec: from uint8 images and the weights, what a correct
codec's blobs hold and what its decoder must return.

Per image: y = analysis(x / 255), z = hyper_analysis(y), z's symbols
``round(z - offset)`` on the prior's grid, z_hat = symbols + offset, then
the family's y model run one image at a time: by default (mu, sigma) =
hyper_synthesis(z_hat), one y stream of symbols ``round(y - mu)``
(``round(y)`` where the family predicts no mean) and y_hat = symbols + mu;
a family that codes y in slices gives each slice's stream from the slices
before it (:mod:`benchmark.reference.models`). The decoded image is
``uint8(synthesis(y_hat))``. A blob holds ``[S y streams, z string,
xshape, zshape]``, and ``[K]`` after them where rANS coded its y
(:func:`~benchmark.reference.formats.blob_fields`). The z strings of a
blob are read back with the reference's own tables and range decoder; y's
symbols are costed in bits against the reference's own y tables, at the
rows sigma picks.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from benchmark.reference import entropy
from benchmark.reference.formats import blob_fields
from benchmark.reference.layers import to_uint8
from benchmark.reference.models import Transforms, y_streams


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 as configured (TF32 off) or, for the control, TF32 on."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


@dataclass
class Expected:
    y_symbols: torch.Tensor   # int32 (n, h, w, C): the streams' channels in blob order
    z_symbols: torch.Tensor   # int32 (n, h/4, w/4, Cz)
    sigma: torch.Tensor       # float32, like y
    images: torch.Tensor      # uint8 (n, H, W, 3)
    streams: tuple            # the channels of each y stream


class ReferenceCodec:
    """The reference of one configuration on ``device`` (parameters as a
    flat float32 dict on that device)."""

    def __init__(self, cfg: dict, params: dict, device):
        self.cfg = cfg
        self.p = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
                  for k, v in params.items()}
        self.t = Transforms(cfg)
        self.streams = y_streams(cfg)
        self.device = device
        self.tables = entropy.FactorizedTables(entropy.prior_params(self.p))
        self.z_offset = torch.as_tensor(self.tables.offset, device=device)
        self._y_tables = None

    @property
    def y_tables(self) -> entropy.GaussianTables:
        if self._y_tables is None:
            self._y_tables = entropy.GaussianTables()
        return self._y_tables

    @torch.no_grad()
    def expected(self, images: np.ndarray, tf32: bool = False) -> Expected:
        with precision(tf32):
            x = torch.as_tensor(images, device=self.device).to(torch.float32) / 255.0
            y = self.t.analysis(self.p, x)
            z = self.t.hyper_analysis(self.p, y)
            z_sym = torch.round(z - self.z_offset).to(torch.int32)
            z_hat = z_sym.to(torch.float32) + self.z_offset
            per_image = [self.t.y_model(self.p, y[i : i + 1], z_hat[i : i + 1])
                         for i in range(z_hat.shape[0])]
            x_hat = torch.cat([to_uint8(self.t.synthesis(self.p, y_hat))
                               for _streams, y_hat in per_image])
            streams = [s for s, _y_hat in per_image]
            y_sym = torch.cat([torch.cat([sym for sym, _ in s], -1) for s in streams])
            sigma = torch.cat([torch.cat([sig for _, sig in s], -1) for s in streams])
        if len(streams[0]) != self.streams:
            raise ValueError(f"the y model gives {len(streams[0])} streams an image, "
                             f"the family's blobs hold {self.streams}")
        return Expected(y_sym, z_sym, sigma, x_hat,
                        tuple(sym.shape[-1] for sym, _ in streams[0]))

    def z_from_blob(self, blob: bytes) -> np.ndarray:
        """The z symbols a blob's z string holds, read with the reference's
        tables: ``(h, w, Cz)`` int64."""
        _y, z_string, zshape, _K = blob_fields(blob, self.streams)
        channels = len(self.tables.rows)
        index = np.tile(np.arange(channels), int(np.prod(zshape)))
        values = entropy.decode_values(z_string, self.tables.rows, self.tables.cdf_offset, index)
        return values.reshape(int(zshape[0]), int(zshape[1]), channels)

    @torch.no_grad()
    def escape_share(self, exp: Expected) -> float:
        """The share of y symbols outside their row of the y tables."""
        rows = entropy.scale_rows(exp.sigma)
        m = exp.y_symbols.to(torch.int64) - torch.as_tensor(
            self.y_tables.cdf_offset, device=rows.device)[rows]
        inside = (m >= 0) & (m < torch.as_tensor(self.y_tables.lengths, device=rows.device)[rows])
        return float((~inside).double().mean())

    @torch.no_grad()
    def y_bits(self, exp: Expected, i: int, escape_bits) -> float:
        """Bits of image i's y symbols coded against the reference's y
        tables at the rows its sigma picks, escapes paid by
        ``escape_bits``."""
        return float(entropy.y_coded_bits(self.y_tables, exp.y_symbols[i : i + 1],
                                          entropy.scale_rows(exp.sigma[i : i + 1]),
                                          escape_bits)[0])
