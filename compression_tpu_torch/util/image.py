"""Host-side image helpers (counterpart of ``compression_tpu/util/image.py``:
``pad_to_multiple_np`` and a NumPy PSNR)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["pad_to_multiple_np", "psnr_np"]


def pad_to_multiple_np(
    images: np.ndarray, multiple: int
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Edge-pads a batched (N, H, W, C) uint8 stack so H and W are multiples
    of ``multiple``, before the host->device upload, so the device stage
    sees whole latent grids. Returns (padded, (H, W))."""
    h, w = images.shape[1], images.shape[2]
    hp, wp = -h % multiple, -w % multiple
    if hp or wp:
        images = np.pad(
            images, ((0, 0), (0, hp), (0, wp), (0, 0)), mode="edge"
        )
    return images, (h, w)


def psnr_np(a: np.ndarray, b: np.ndarray, max_val: float = 255.0):
    """PSNR over the trailing (H, W, C) dims, in float64."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean(np.square(a - b), axis=(-3, -2, -1))
    return 10.0 * np.log10(max_val**2 / mse)
