"""Image IO and quality metrics (counterpart of
``compression_tpu/util/image.py``): PNG IO through PIL (imported only when
called), host padding, and PSNR, SSIM and MS-SSIM as plain torch functions
on NHWC float tensors, differentiable, so the MS-SSIM loss trains on the
card. A NumPy PSNR serves the host side."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "read_png",
    "write_png",
    "pad_to_multiple_np",
    "psnr",
    "psnr_np",
    "ssim",
    "msssim",
]


def read_png(path) -> np.ndarray:
    """Reads an image file to uint8 (H, W, 3)."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    return np.asarray(img, np.uint8)


def write_png(path, image: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(np.asarray(image, np.uint8)).save(path)


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


def psnr(a: torch.Tensor, b: torch.Tensor, max_val: float = 255.0):
    """PSNR over the trailing (H, W, C) dims, in float32."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    mse = torch.mean(torch.square(a - b), dim=(-3, -2, -1))
    return 10.0 * torch.log10(max_val**2 / mse)


def _fspecial_gauss(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x**2) / (2.0 * sigma**2))
    return g / g.sum()


def _filter2(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable 2-D blur, valid padding, of NHWC ``x``: a depthwise
    ``conv2d`` along H, then along W, in fp32 (the SSIM variance term
    E[x^2] - mu^2 cancels badly in anything coarser)."""
    c, k = x.shape[-1], win.shape[0]
    xc = x.permute(0, 3, 1, 2)
    xc = F.conv2d(xc, win.reshape(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    xc = F.conv2d(xc, win.reshape(1, 1, 1, k).expand(c, 1, 1, k), groups=c)
    return xc.permute(0, 2, 3, 1)


def _ssim_per_scale(a, b, max_val, filter_size=11, filter_sigma=1.5,
                    k1=0.01, k2=0.03):
    # SSIM is invariant to jointly rescaling (a, b, max_val); dividing
    # through by max_val keeps E[x^2] near 1, so the float32 variance
    # cancellation stays small.
    a = a * (1.0 / max_val)
    b = b * (1.0 / max_val)
    c1 = k1 ** 2
    c2 = k2 ** 2
    win = _fspecial_gauss(filter_size, filter_sigma, a.device)
    mu_a = _filter2(a, win)
    mu_b = _filter2(b, win)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    sigma_aa = _filter2(a * a, win) - mu_aa
    sigma_bb = _filter2(b * b, win) - mu_bb
    sigma_ab = _filter2(a * b, win) - mu_ab
    cs = (2 * sigma_ab + c2) / (sigma_aa + sigma_bb + c2)
    lum = (2 * mu_ab + c1) / (mu_aa + mu_bb + c1)
    return torch.mean(lum * cs, dim=(1, 2, 3)), torch.mean(cs, dim=(1, 2, 3))


def _as_batch(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    return x[None] if x.ndim == 3 else x


def ssim(a: torch.Tensor, b: torch.Tensor, max_val: float = 255.0):
    """Single-scale SSIM; inputs (N, H, W, C) or (H, W, C)."""
    squeeze = a.ndim == 3
    s, _ = _ssim_per_scale(_as_batch(a), _as_batch(b), max_val)
    return s[0] if squeeze else s


_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)

_GRAD_FLOOR = 1e-2


class _WeightedTerm(torch.autograd.Function):
    """``max(v, 0) ** w`` with a bounded derivative, for use in a loss.

    The exact derivative ``w * v**(w-1)`` goes to infinity as ``v -> 0+``,
    and early-training contrast terms touch 0; one such spike inflates
    Adam's second moments for good. The value is exactly ``max(v, 0) ** w``;
    the derivative is taken at ``max(v, 1e-2)``."""

    @staticmethod
    def forward(ctx, v, w):
        ctx.save_for_backward(v)
        ctx.w = w
        return torch.clamp(v, min=0.0) ** w

    @staticmethod
    def backward(ctx, grad):
        (v,) = ctx.saved_tensors
        w = ctx.w
        return grad * (w * torch.clamp(v, min=_GRAD_FLOOR) ** (w - 1.0)), None


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool, stride 2, NHWC, count-normalised: at odd sizes the
    edge windows average their real pixels only."""
    h, w = x.shape[1], x.shape[2]
    xc = F.pad(x.permute(0, 3, 1, 2), (0, w % 2, 0, h % 2))
    ones = F.pad(torch.ones((1, 1, h, w), dtype=x.dtype, device=x.device),
                 (0, w % 2, 0, h % 2))
    s = F.avg_pool2d(xc, 2, 2, divisor_override=1)
    n = F.avg_pool2d(ones, 2, 2, divisor_override=1)
    return (s / n).permute(0, 2, 3, 1)


def msssim(a: torch.Tensor, b: torch.Tensor, max_val: float = 255.0):
    """Multi-scale SSIM (Wang et al. 2003) with the standard 5-level
    weights. Needs spatial dims >= 11 * 2^4 = 176 (the 11-tap window must
    fit at the coarsest scale)."""
    min_hw = 11 * 2 ** (len(_MSSSIM_WEIGHTS) - 1)
    if min(a.shape[-3], a.shape[-2]) < min_hw:
        raise ValueError(
            f"msssim needs spatial dims >= {min_hw}, got "
            f"{a.shape[-3]}x{a.shape[-2]}"
        )
    squeeze = a.ndim == 3
    a, b = _as_batch(a), _as_batch(b)
    values = []
    last = len(_MSSSIM_WEIGHTS) - 1
    for i, w in enumerate(_MSSSIM_WEIGHTS):
        s, cs = _ssim_per_scale(a, b, max_val)
        values.append(_WeightedTerm.apply(s if i == last else cs, w))
        if i < last:
            a = _avg_pool2(a)
            b = _avg_pool2(b)
    out = torch.prod(torch.stack(values, 0), dim=0)
    return out[0] if squeeze else out
