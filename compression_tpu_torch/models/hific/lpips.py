"""LPIPS perceptual distance on VGG16 features with learned channel weights
(counterpart of ``compression_tpu/models/hific/lpips.py``).

The weights are read from the flax msgpack file that
``tools/convert_lpips.py`` writes (``{"params": {"vgg": {"conv{b}_{c}":
{kernel, bias}}, "lin{i}": (C,)}}``), named by ``TPC_LPIPS_WEIGHTS``.
Without a file the features are random, as in the JAX package: a seeded
draw of flax's ``nn.Conv`` init (``lecun_normal`` kernels, zero biases)
and heads at ``1 / C``; the fallback is reported on stderr.
"""

from __future__ import annotations

import os
import sys
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from compression_tpu_torch.models.hific.archs import Conv

__all__ = ["LPIPS", "make_lpips", "lpips_params_path"]

# VGG16 conv widths per block (features tapped after the last conv of each).
_BLOCKS: Tuple[Tuple[int, ...], ...] = (
    (64, 64),
    (128, 128),
    (256, 256, 256),
    (512, 512, 512),
    (512, 512, 512),
)

# ImageNet normalization (inputs in [0, 1]).
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


def lpips_params_path() -> Optional[str]:
    """The converted weights named by ``TPC_LPIPS_WEIGHTS``, or None."""
    path = os.environ.get("TPC_LPIPS_WEIGHTS")
    return path if path and os.path.exists(path) else None


class _VGG16Features(nn.Module):
    def __init__(self, gen: torch.Generator):
        super().__init__()
        cin = 3
        for b, widths in enumerate(_BLOCKS):
            for c, w in enumerate(widths):
                self.add_module(f"conv{b}_{c}", Conv(cin, w, 3, 1, gen))
                cin = w

    def forward(self, x):
        taps = []
        for b, widths in enumerate(_BLOCKS):
            for c in range(len(widths)):
                x = torch.relu(getattr(self, f"conv{b}_{c}")(x))
            taps.append(x)
            if b < len(_BLOCKS) - 1:  # 2x2 max pool, stride 2, NHWC
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        return taps


class LPIPS(nn.Module):
    """``lpips(a, b)``: inputs (N, H, W, 3) in [0, 1]; returns (N,)
    distances. Parameters ``vgg.conv{b}_{c}.weight/bias`` and ``lin{i}``
    (C,), drawn from a generator seeded with ``seed``."""

    def __init__(self, seed: int = 7):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.vgg = _VGG16Features(gen)
        for i, widths in enumerate(_BLOCKS):
            self.register_parameter(
                f"lin{i}", nn.Parameter(torch.full((widths[-1],), 1.0 / widths[-1])))
        self.register_buffer("mean", torch.tensor(_MEAN), persistent=False)
        self.register_buffer("std", torch.tensor(_STD), persistent=False)

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        fa = self.vgg((a - self.mean) / self.std)
        fb = self.vgg((b - self.mean) / self.std)
        total = 0.0
        for i, (xa, xb) in enumerate(zip(fa, fb)):
            # Unit-normalize channels, then a learned per-channel weight.
            na = xa * torch.rsqrt(torch.sum(xa * xa, dim=-1, keepdim=True) + 1e-10)
            nb = xb * torch.rsqrt(torch.sum(xb * xb, dim=-1, keepdim=True) + 1e-10)
            w = torch.clamp(getattr(self, f"lin{i}"), min=0.0)
            diff = torch.square(na - nb) * w
            total = total + torch.mean(torch.sum(diff, dim=-1), dim=(1, 2))
        return total


def make_lpips() -> LPIPS:
    """An :class:`LPIPS` with the converted weights where
    ``TPC_LPIPS_WEIGHTS`` names a file, else random features drawn from
    seed 7 (reported on stderr); its parameters need no gradient."""
    from compression_tpu_torch.convert import load_flax_msgpack, params_from_numpy

    model = LPIPS()
    path = lpips_params_path()
    if path is not None:
        model.load_state_dict(params_from_numpy(load_flax_msgpack(path)))
    else:
        print("[compression_tpu_torch.hific] WARNING: no converted LPIPS weights "
              "found (TPC_LPIPS_WEIGHTS); using randomly initialized VGG features "
              "(smoke mode). Run tools/convert_lpips.py for evaluation parity.",
              file=sys.stderr)
    return model.requires_grad_(False)
