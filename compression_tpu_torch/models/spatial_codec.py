"""What the families' giant-image codecs share (the ``SpatialCodec``\\ s of
the JAX package's bmshj2018, mbt2018 and HiFiC, one class there per
family): one image, its transforms H-sharded over a mesh
(:mod:`compression_tpu_torch.parallel.spatial`), and the host range coder
on the latent grids, 16x to 64x smaller.

The wire format is the standard 4-field host-coded blob ``[y_string,
z_string, xshape, zshape]``. Encode and decode agree on every row: both
call the family's one sharded function from z_hat to the location and the
CDF rows (``_mu_rows``), and z_hat is ``int symbols + float32 offset`` on
both sides. The image's H is edge-padded to ``downscale * n`` and W to
``downscale``. A blob decodes with a SpatialCodec over the same number of
shards; the dense ``Codec`` computes sigma with other convolution shapes,
equal in practice but not held to be bit-equal.
"""

from __future__ import annotations

import numpy as np
import torch

from compression_tpu_torch.models.device_coding import parse_host_blobs
from compression_tpu_torch.parallel.data_parallel import Mesh
from compression_tpu_torch.parallel.spatial import gather_rows, map_shards, shard_rows
from compression_tpu_torch.util.image import pad_to_multiple_np, to_uint8
from compression_tpu_torch.util.numeric import slim_int

__all__ = ["SpatialCodecBase"]


class SpatialCodecBase:
    """A hyperprior family's codec with its transforms H-sharded over
    ``mesh``. A family gives ``_front`` (float image shards -> y and z
    shards), ``_mu_rows`` (z_hat shards -> location shards or None, CDF row
    shards) and ``_synth`` (y_hat shards -> float image shards), each
    through its ``sharded_*`` functions; ms2020, whose y is coded slice by
    slice, gives its own ``compress`` and ``decompress``.

    Args:
      codec: the family's dense ``Codec`` on ``mesh.devices[0]`` (its
        tables, entropy models and blob name).
      mesh: the shards' devices.
    """

    def __init__(self, codec, mesh: Mesh, axis: str = "data"):
        if codec.device != mesh.devices[0]:
            raise ValueError(f"the codec is on {codec.device}; the mesh's first "
                             f"device is {mesh.devices[0]}")
        self.codec, self.mesh, self.axis = codec, mesh, axis
        self.model, self.cfg = codec.model, codec.cfg
        self._mult = self.cfg.downscale * mesh.shape[axis]
        self._z_off = codec._z_off.cpu().numpy()

    def _shards(self, a: np.ndarray):
        return shard_rows(torch.from_numpy(np.ascontiguousarray(a)), self.mesh, self.axis)

    def _z_symbols(self, z_shards) -> np.ndarray:
        off = self.codec._z_off
        return gather_rows(map_shards(
            lambda z: torch.round(z - off.to(z.device)).to(torch.int32), z_shards)
        ).cpu().numpy()

    def compress(self, image: np.ndarray) -> bytes:
        """uint8 (H, W, 3) -> 4-field .tfci blob."""
        codec = self.codec
        x, (h, w) = pad_to_multiple_np(np.asarray(image, np.uint8)[None], self._mult,
                                       self.cfg.downscale)
        with torch.inference_mode():
            y, z = self._front(map_shards(lambda s: s.to(torch.float32) / 255.0,
                                          self._shards(x)))
            z_sym = self._z_symbols(z)
            # z_hat exactly as the decoder forms it: int symbols + f32 offset.
            mu, rows = self._mu_rows(self._shards(z_sym.astype(np.float32) + self._z_off))
            if mu is None:
                sym = map_shards(lambda v: torch.round(v).to(torch.int32), y)
            else:
                sym = map_shards(codec._center_round, y, mu)
            sym = gather_rows(sym).cpu().numpy()
            rows = gather_rows(rows).cpu().numpy()
        z_strings = codec.side_em.compress_symbols(z_sym)
        y_strings = codec.em.compress_symbols(sym.reshape(1, -1), rows.reshape(1, -1))
        return codec._blob([y_strings[0], z_strings[0], np.array([h, w], np.int32),
                            np.array(z_sym.shape[1:3], np.int32)])

    def decompress(self, blob: bytes) -> np.ndarray:
        """4-field .tfci blob -> uint8 (H, W, 3)."""
        codec = self.codec
        y_strings, z_strings, xshape, zshape = parse_host_blobs([blob])
        z_hat = codec.side_em.decompress(z_strings, tuple(int(v) for v in zshape))
        with torch.inference_mode():
            mu, rows = self._mu_rows(self._shards(z_hat))
            rows = gather_rows(rows).cpu().numpy()
            values = codec.em.decode_symbols(y_strings, rows.reshape(1, -1))
            values = self._shards(slim_int(values.reshape(rows.shape)))
            y_hat = map_shards(codec._apply_loc, values, mu or [None] * len(values))
            x_hat = gather_rows(map_shards(to_uint8, self._synth(y_hat))).cpu().numpy()
        return x_hat[0, : int(xshape[0]), : int(xshape[1]), :]
