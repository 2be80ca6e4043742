"""CHARM slice-pipelined decoding (counterpart of
``compression_tpu/parallel/charm_pipeline.py``).

An ms2020 decode is ``num_slices`` serial steps an image: the device
computes slice i's (mu, sigma) from the slices before it, the slice is
decoded, and its LRP is added. Two things shorten a decode of many blobs:

* slice batching (``ms2020.Codec.decompress_batch``): blobs of one size
  decode in lockstep, so a batch pays one round of host work a slice
  instead of one a slice and an image;
* batch staggering (:func:`decompress_batch_pipelined`, and
  ``Codec.decompress_iter``'s pipeline for host-coded batches): with
  ``depth`` batches in flight on worker threads, the device computes one
  batch's slice parameters while the host decodes another's slice.
"""

from __future__ import annotations

from typing import List

import numpy as np

from compression_tpu_torch.models.device_coding import num_fields
from compression_tpu_torch.parallel.pipeline import staggered_map
from compression_tpu_torch.util import PackedTensors

__all__ = ["decompress_batch_pipelined"]


def decompress_batch_pipelined(codec, packed_blobs: List[bytes], depth: int = 2,
                               batch_size: int = 8) -> List[np.ndarray]:
    """Decodes many .tfci blobs with an ms2020 ``codec``: blobs of the same
    coder format and image size go to the device in batches of up to
    ``batch_size``, and up to ``depth`` batches are staggered. Results keep
    the input order."""
    def key(blob: bytes):
        shape = PackedTensors(blob).unpack_one(codec.cfg.num_slices + 1, np.int32)
        return (num_fields(blob), *(int(v) for v in shape))

    groups: List[List[int]] = []
    open_group = {}
    for i, blob in enumerate(packed_blobs):
        k = key(blob)
        if k not in open_group or len(groups[open_group[k]]) >= batch_size:
            open_group[k] = len(groups)
            groups.append([])
        groups[open_group[k]].append(i)
    results: List[np.ndarray] = [None] * len(packed_blobs)  # type: ignore
    decoded = staggered_map(
        lambda idxs: codec.decompress_batch([packed_blobs[i] for i in idxs]), groups, depth)
    for idxs, out in zip(groups, decoded):
        for j, i in enumerate(idxs):
            results[i] = out[j]
    return results
