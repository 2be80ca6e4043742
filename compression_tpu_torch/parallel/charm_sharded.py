"""Multi-device CHARM decode: image-parallel over a mesh (counterpart of
``compression_tpu/parallel/charm_sharded.py``).

The CHARM slice chain is serial within one image (slice i + 1's mu and
sigma read slice i's decoded values) and independent across images, so the
image batch is split over the mesh: at each slice step every shard runs
the slice transforms of its images on its device, and the host
range-decodes the whole batch's streams at once (one thread a stream), so
the host round trips stay 10 a batch. Device-coded blobs decode with K2 on
each shard's device, with no values crossing to the host.

The shards run the dense ``ms2020.Codec``'s own per-image functions
(``_supports``, ``_slice_rows``, ``_finish_slices``, one image at a time,
never images batched into one slice transform), on each device's copy of
the model, so the output is byte-equal to ``Codec.decompress_batch``.
Batches that do not divide the mesh are padded by repeating the last blob;
the padding is dropped before returning.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from compression_tpu_torch.parallel.data_parallel import Mesh, Replicas
from compression_tpu_torch.util.numeric import slim_int

__all__ = ["ShardedCharmCodec"]


class ShardedCharmCodec:
    """Image-parallel ms2020 decode across a :class:`~compression_tpu_torch.
    parallel.data_parallel.Mesh`. Wraps the single-device ``ms2020.Codec``
    on ``mesh.devices[0]``: tables and bitstream layout are its own.

    Args:
      model: an ``ms2020.MS2020Model`` (moved to ``mesh.devices[0]``).
      mesh: the shards' devices.
    """

    def __init__(self, model, mesh: Mesh, axis: str = "data"):
        from compression_tpu_torch.models import ms2020

        self.codec = ms2020.make_codec(model, mesh.devices[0])
        self.cfg = self.codec.cfg
        self.mesh, self.axis = mesh, axis
        self._ndev = mesh.shape[axis]
        self._replicas = Replicas(self.codec.model, mesh.devices)

    def _groups(self, m: int):
        per = m // self._ndev
        return [(dev, slice(d * per, (d + 1) * per)) for d, dev in enumerate(self.mesh.devices)]

    def decompress_batch(self, blobs: List[bytes]) -> np.ndarray:
        """Lockstep slice-by-slice decode of same-size blobs, image-sharded
        across the mesh; host- and device-coded blobs are told apart as
        ``Codec.decompress_batch`` tells them. Its output, byte for byte."""
        # Imported here: the models import this package.
        from compression_tpu_torch.models.device_coding import pad_words, parse_blobs, rans_for

        n = len(blobs)
        if n == 0:
            raise ValueError("decompress_batch needs at least one blob")
        blobs = list(blobs) + [blobs[-1]] * ((-n) % self._ndev)
        codec, call = self.codec, self._replicas.call
        device_coded = codec._is_device_coded(blobs[0])
        streams, z_strings, xshape, zshape, K = parse_blobs(
            blobs, self.cfg.num_slices, device_coded)
        z_hat = codec.side_em.decompress(z_strings, tuple(int(v) for v in zshape))
        m = len(blobs)
        groups = self._groups(m)
        with torch.inference_mode():
            sups = [call(dev, codec._supports, torch.from_numpy(z_hat[sl]).to(dev))
                    for dev, sl in groups]
            decoded = [[[] for _ in range(m // self._ndev)] for _ in groups]
            oks = []
            for i, slice_streams in enumerate(streams):
                mu_rows = [call(dev, codec._slice_rows, i, sups[d], decoded[d])
                           for d, (dev, _) in enumerate(groups)]
                if device_coded:
                    values = []
                    for (dev, sl), (mu, rows) in zip(groups, mu_rows):
                        _enc, dec, _K, _cap = rans_for(codec, rows[0].numel(), K)
                        words = torch.from_numpy(pad_words(slice_streams[sl])).to(dev)
                        v, ok = dec(words, rows.reshape(rows.shape[0], -1))
                        values.append(v.reshape(mu.shape))
                        oks.append(ok.to(groups[0][0]))
                else:
                    # The coder boundary: every shard's rows to the host, all
                    # m streams decoded at once, the values back to each shard.
                    rows = np.concatenate([r.cpu().numpy() for _, r in mu_rows])
                    flat = codec.em.decode_symbols(slice_streams, rows.reshape(m, -1))
                    flat = slim_int(flat.reshape(rows.shape))
                    values = [torch.from_numpy(flat[sl]).to(dev) for dev, sl in groups]
                for d, ((dev, _), (mu, _), v) in enumerate(zip(groups, mu_rows, values)):
                    call(dev, codec._finish_slices, i, sups[d], decoded[d],
                         codec._apply_loc(v, mu))
            images = [call(dev, codec._synthesize,
                           torch.cat([torch.cat(dec, -1) for dec in decoded[d]])).cpu()
                      for d, (dev, _) in enumerate(groups)]
            if oks and not torch.stack(oks).all():
                raise ValueError("corrupt device-coded bitstream (rANS state)")
        out = torch.cat(images).numpy()
        return out[:n, : int(xshape[0]), : int(xshape[1]), :]

    def decompress(self, data: bytes) -> np.ndarray:
        return self.decompress_batch([data])[0]
