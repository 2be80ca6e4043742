"""Image IO and quality metrics (counterpart of
``compression_tpu/util/image.py``): a PNG codec of its own (``zlib`` and
``struct``: the card's machine has no PIL), padding (tensors, and NumPy
stacks on the host), and PSNR, SSIM
and MS-SSIM as plain torch functions on NHWC float tensors,
differentiable, so the MS-SSIM loss trains on the card. A NumPy PSNR
serves the host side.

PNG: the writer emits 8-bit RGB with filter 0. The reader takes 8-bit,
non-interlaced files of colour types 0, 2, 3, 4 and 6 with any of the five
row filters, and converts them to RGB as PIL's ``convert("RGB")`` does
(gray replicated, alpha dropped, palette looked up). Anything else (16-bit
or interlaced PNG, another format) goes through PIL where it can be
imported, and raises where it cannot.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "read_png",
    "write_png",
    "pad_to_multiple",
    "pad_to_multiple_np",
    "unpad",
    "to_uint8",
    "psnr",
    "psnr_np",
    "ssim",
    "msssim",
]


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path, image: np.ndarray) -> None:
    """Writes a uint8 (H, W, 3) image as an 8-bit RGB PNG, filter 0."""
    image = np.asarray(image, np.uint8)
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got {image.shape}")
    h, w, _ = image.shape
    rows = np.zeros((h, 1 + 3 * w), np.uint8)  # each row's filter byte is 0
    rows[:, 1:] = image.reshape(h, 3 * w)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + _png_chunk(b"IHDR", header)
                + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _png_chunk(b"IEND", b""))


def _png_chunks(data: bytes):
    pos = len(_PNG_SIGNATURE)
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])
        if len(body) != length or zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"corrupt PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("truncated PNG: no IEND chunk")


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undoes the PNG row filters (None, Sub, Up, Average, Paeth)."""
    raw = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(h):
        kind, line = raw[r, 0], raw[r, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum mod 256 along each sample
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = line + prev
        elif kind in (3, 4):  # each byte needs the one decoded bpp before it
            cur = bytearray(line.tobytes())
            up = prev.tolist()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row {r} has an unknown filter {kind}")
        out[r] = prev = cur
    return out


def _png_header(data: bytes):
    """A PNG's (width, height, bit depth, colour type, interlace), or None
    for a file that is not a PNG."""
    if not data.startswith(_PNG_SIGNATURE):
        return None
    kind, body = next(_png_chunks(data))
    if kind != b"IHDR" or len(body) != 13:
        raise ValueError("PNG does not start with IHDR")
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
    return w, h, depth, ctype, interlace


def _decode_png(data: bytes, w: int, h: int, ctype: int) -> np.ndarray:
    """An 8-bit non-interlaced PNG of colour type ``ctype`` -> uint8
    (H, W, 3)."""
    chunks = list(_png_chunks(data))
    ch = _PNG_CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(
        b"".join(body for kind, body in chunks if kind == b"IDAT")), np.uint8)
    if raw.size != h * (w * ch + 1):
        raise ValueError(f"PNG image data holds {raw.size} bytes, expected "
                         f"{h * (w * ch + 1)}")
    px = _unfilter(raw, h, w * ch, ch).reshape(h, w, ch)
    if ctype == 3:
        palette = next((body for kind, body in chunks if kind == b"PLTE"), None)
        if palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        lut = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(palette, np.uint8).reshape(-1, 3)
        lut[: len(entries)] = entries
        return lut[px[..., 0]]
    if ch <= 2:  # gray, gray + alpha
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def read_png(path) -> np.ndarray:
    """Reads an image file to uint8 (H, W, 3). 8-bit non-interlaced PNGs
    are decoded here; other files go through PIL, if it is installed."""
    with open(path, "rb") as f:
        data = f.read()
    header = _png_header(data)
    if header is None:
        unsupported = "not a PNG file"
    else:
        w, h, depth, ctype, interlace = header
        if depth == 8 and not interlace and ctype in _PNG_CHANNELS:
            return _decode_png(data, w, h, ctype)
        unsupported = (f"bit depth {depth}, colour type {ctype}, "
                       f"{'interlaced' if interlace else 'non-interlaced'}")
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(
            f"{path}: {unsupported}; this reader takes 8-bit non-interlaced "
            "PNG (colour types 0, 2, 3, 4, 6), and PIL, which would read the "
            "rest, is not installed") from None
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"), np.uint8)


def pad_to_multiple(x: torch.Tensor, multiple: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Edge-pads the spatial axes -3 and -2 of a tensor of any dtype and
    rank >= 3 up to multiples of ``multiple``; returns ``(x, (H, W))``. The
    padding repeats the last row and column (an index gather with clamped
    indices: ``F.pad``'s replicate mode refuses integer tensors and some
    ranks)."""
    h, w = x.shape[-3], x.shape[-2]
    hp, wp = -h % multiple, -w % multiple
    if hp:
        rows = torch.arange(h + hp, device=x.device).clamp_(max=h - 1)
        x = x.index_select(x.dim() - 3, rows)
    if wp:
        cols = torch.arange(w + wp, device=x.device).clamp_(max=w - 1)
        x = x.index_select(x.dim() - 2, cols)
    return x, (h, w)


def unpad(x, shape: Sequence[int]):
    """Cuts the spatial axes -3 and -2 back to ``shape`` = (H, W)."""
    h, w = shape
    return x[..., :h, :w, :]


def pad_to_multiple_np(
    images: np.ndarray, multiple: int, multiple_w: Optional[int] = None
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Edge-pads a batched (N, H, W, C) uint8 stack so H and W are multiples
    of ``multiple`` (W of ``multiple_w`` where given), before the
    host->device upload, so the device stage sees whole latent grids.
    Returns (padded, (H, W))."""
    h, w = images.shape[1], images.shape[2]
    hp, wp = -h % multiple, -w % (multiple if multiple_w is None else multiple_w)
    if hp or wp:
        images = np.pad(
            images, ((0, 0), (0, hp), (0, wp), (0, 0)), mode="edge"
        )
    return images, (h, w)


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """A float image in [0, 1] -> uint8, rounded and clipped."""
    return torch.clamp(torch.round(x * 255.0), 0, 255).to(torch.uint8)


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
