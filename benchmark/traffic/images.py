"""Images and crops from a seed, the one generator every mix reads.

A structured image (extended from the repository's synthetic bench image:
colour ramps, a sinusoidal texture, a flat block with sharp edges and mild
noise) has everything drawn from the seed: the texture's two periods, the
block's place, size and colour, the ramps' directions and the noise. The
pool is made in one batch of calls on the device and handed to the host as
uint8 (N, H, W, 3), as a codec's caller holds its images.
"""

from __future__ import annotations

import numpy as np
import torch


def structured_pool(count: int, height: int, width: int, seed: int, device) -> np.ndarray:
    g = torch.Generator(device).manual_seed(int(seed))

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(count, *shape, generator=g, device=device)

    yy = torch.arange(height, device=device, dtype=torch.float32)[None, :, None]
    xx = torch.arange(width, device=device, dtype=torch.float32)[None, None, :]
    flip = torch.rand(count, 2, generator=g, device=device) < 0.5
    ramp_x = torch.where(flip[:, 0, None, None], 1 - xx / width, xx / width) * 255
    ramp_y = torch.where(flip[:, 1, None, None], 1 - yy / height, yy / height) * 255
    fx, fy = u(8.0, 40.0, 1, 1), u(8.0, 40.0, 1, 1)
    texture = (torch.sin(xx / fx) * torch.cos(yy / fy) * 0.5 + 0.5) * 255
    image = torch.stack(torch.broadcast_tensors(ramp_x, ramp_y, texture), dim=-1)
    bh, bw = u(height / 8, height / 3, 1, 1), u(width / 8, width / 3, 1, 1)
    top, left = u(0.0, 1.0, 1, 1) * (height - bh), u(0.0, 1.0, 1, 1) * (width - bw)
    block = (yy >= top) & (yy < top + bh) & (xx >= left) & (xx < left + bw)
    colour = u(0.0, 255.0, 3)[:, None, None, :]
    image = torch.where(block[..., None], colour, image)
    noise = torch.randn(image.shape, generator=g, device=device) * 4
    return torch.clamp(torch.round(image + noise), 0, 255).to(torch.uint8).cpu().numpy()


class Crops:
    """Batches of square crops of a pool, each at a random place and with a
    random one of the eight dihedral transforms (flips, then a transpose),
    as the program's training feed augments its crops; from ``seed``."""

    def __init__(self, pool: np.ndarray, batch: int, patch: int, seed: int, augment: bool):
        self.pool, self.batch, self.patch, self.augment = pool, batch, patch, augment
        self.rng = np.random.default_rng(int(seed))

    def next(self) -> np.ndarray:
        n, h, w, _ = self.pool.shape
        p = self.patch
        out = np.empty((self.batch, p, p, 3), np.uint8)
        for b in range(self.batch):
            i, y, x = (int(v) for v in (self.rng.integers(n), self.rng.integers(h - p + 1),
                                         self.rng.integers(w - p + 1)))
            crop = self.pool[i, y : y + p, x : x + p]
            if self.augment:
                f = self.rng.random(3) < 0.5
                if f[0]:
                    crop = crop[::-1]
                if f[1]:
                    crop = crop[:, ::-1]
                if f[2]:
                    crop = crop.transpose(1, 0, 2)
            out[b] = crop
        return out
