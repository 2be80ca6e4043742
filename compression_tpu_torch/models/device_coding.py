"""Blob formats of the hyperprior codecs (counterpart of
``compression_tpu/models/device_coding.py``; this slice ports the host-coded
format only).

Host-coded blobs hold 4 fields ``[y_string, z_string, xshape, zshape]``;
device-coded (rANS) blobs hold 5, ``[y_words, z_string, xshape, zshape,
[K]]``. The device coder is not ported yet, so a 5-field blob raises.
"""

from __future__ import annotations

from typing import List

import numpy as np

from compression_tpu_torch.util import PackedTensors

__all__ = ["is_device_coded", "parse_host_blobs"]


def is_device_coded(blob: bytes) -> bool:
    packed = PackedTensors(blob)
    return len([k for k, *_ in packed.describe() if k != "MD"]) == 5


def parse_host_blobs(blobs: List[bytes]):
    """Unpacks host-coded 4-field blobs with size-uniformity validation (a
    batched decode cannot mix image sizes). Returns ``(y_strings,
    z_strings, xshape, zshape)``."""
    y_strings, z_strings = [], []
    xshape = zshape = None
    for b, blob in enumerate(blobs):
        if is_device_coded(blob):
            raise NotImplementedError(
                f"blob {b} is device-coded (rANS, 5 fields): the device "
                "coder is not yet ported to the PyTorch package"
            )
        packed = PackedTensors(blob)
        ys, zs, xs, zsh = packed.unpack([object, object, np.int32, np.int32])
        y_strings.append(bytes(ys[0]))
        z_strings.append(bytes(zs[0]))
        if xshape is not None and not (
            np.array_equal(xshape, xs) and np.array_equal(zshape, zsh)
        ):
            raise ValueError(
                "batched decode requires same-size blobs: blob "
                f"{b} has shape {tuple(xs)} vs {tuple(xshape)}; "
                "decode mixed sizes one by one"
            )
        xshape, zshape = xs, zsh
    return y_strings, z_strings, xshape, zshape
