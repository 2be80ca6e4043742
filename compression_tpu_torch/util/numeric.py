"""Small numeric helpers shared by the codec hot paths
(counterpart of ``compression_tpu/util/numeric.py``)."""

from __future__ import annotations

import numpy as np

__all__ = ["slim_int"]


def slim_int(values: np.ndarray) -> np.ndarray:
    """Narrowest integer dtype that exactly holds ``values``.

    The decoded-symbol upload is on the host->device critical path; int8 is
    a 4x smaller transfer than the coder's int32. Returns the input
    unchanged when the values don't fit int16.
    """
    if values.size:
        lo, hi = values.min(), values.max()
        if -128 <= lo and hi <= 127:
            return values.astype(np.int8)
        if -32768 <= lo and hi <= 32767:
            return values.astype(np.int16)
    return values
