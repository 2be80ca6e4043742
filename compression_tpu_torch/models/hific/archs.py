"""HiFiC's networks (counterpart of ``compression_tpu/models/hific/archs.py``):
ChannelNorm, the Encoder, the Generator and the conditional Discriminator
with flax's spectral norm.

All channels-last (NHWC), as the JAX package's. Submodule and parameter
names follow its param tree (``generator.res0.conv0``, ``norm0.gamma``, the
discriminator's top-level ``conv0`` ... ``conv_out`` and ``latent_proj``),
so :mod:`compression_tpu_torch.convert` maps flax trees onto
``load_state_dict``. The initial weights are drawn from one generator,
layer by layer.

Where a plain translation would give other numbers:

* ChannelNorm takes the population variance (``jnp.var``, not torch's
  unbiased default) and ``rsqrt(var + 1e-3)`` over the trailing axis.
* The discriminator's 4x4 convolutions pad as TF's "SAME" does: a total of
  ``max((ceil(n / s) - 1) * s + 4 - n, 0)``, the smaller half before, so a
  stride-2 conv on an odd size and the stride-1 ``conv3`` pad (1, 2).
* Spectral norm is flax 0.12.3's ``nn.SpectralNorm``, not
  ``torch.nn.utils.spectral_norm``: the HWIO kernel reshaped to (kh * kw *
  cin, cout), u of shape (1, cout), one power step ``v = l2n(u W^T)``,
  ``u = l2n(v W)`` with ``l2n(x) = x * rsqrt(sum(x^2) + 1e-12)``, u and v
  without gradient, ``sigma = v W u^T`` with its gradient through W, the
  kernel divided by sigma where sigma != 0 (the bias is left alone); u and
  sigma are stored only under ``update_stats=True``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch
from torch import nn

from compression_tpu_torch.layers.channel_norm_kernel import fused_channel_norm
from compression_tpu_torch.layers.conv3x3_kernel import conv3x3
from compression_tpu_torch.layers.conv_up3x3_kernel import conv_up3x3
from compression_tpu_torch.layers.signal_conv import (
    SignalConv2D,
    conv_nhwc,
    truncated_normal_init,
)
from compression_tpu_torch.util.profiling import span

__all__ = ["ChannelNorm", "ResidualBlock", "Encoder", "Generator", "Conv",
           "SpectralNormConv", "Discriminator", "same_pads"]


class ChannelNorm(nn.Module):
    """Normalizes each position over its channels (the trailing axis), with
    a learned scale and offset per channel. ``forward(x, bias, residual,
    relu)`` gives ``[residual +] [relu](norm(x [+ bias]))``, so that the
    convolution before it and the ReLU or residual add after it run in the
    same pass: :func:`fused_channel_norm`, the CUDA kernel on the card (which
    raises on what it cannot take) and its twin on the CPU."""

    def __init__(self, channels: int, epsilon: float = 1e-3):
        super().__init__()
        self.epsilon = epsilon
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x, bias=None, residual=None, relu: bool = False):
        with span("hific/channel_norm"):
            return fused_channel_norm(x, self.gamma, self.beta, bias, residual, relu,
                                      self.epsilon)


def _conv(cin, cout, k, gen, **kw):
    return SignalConv2D(cin, cout, k, corr=kw.pop("corr", True), padding="same_zeros",
                        use_bias=True, generator=gen, **kw)


def _kernel_takes(conv: SignalConv2D, x, weight) -> bool:
    """What both hand-written convolutions ask of a layer and its input: the
    card, a dense 3x3 kernel with zero "same" padding and no down-sampling,
    float32, widths that are multiples of 4, and no gradient wanted."""
    wants_grad = torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad)
    return (x.device.type == "cuda" and tuple(conv.support) == (3, 3)
            and conv.padding == "same_zeros"
            and tuple(conv.strides_down) == (1, 1) and not conv.channel_separable
            and x.dtype == torch.float32 and weight.dtype == torch.float32
            and x.shape[-1] % 4 == 0 and weight.shape[0] % 4 == 0 and not wants_grad)


def _takes_conv3x3(conv: SignalConv2D, x, weight) -> bool:
    """Whether :func:`conv3x3` computes ``conv`` on ``x``: a stride-1
    correlation as :func:`_kernel_takes` has it (the generator's ``conv_in``
    and residual blocks as the codec decodes; the encoder's 7x7 and stride-2
    convolutions, the generator's 7x7 ``conv_out``, float64, the CPU and
    training keep ``signal_conv``, and its up-convolutions go to
    :func:`conv_up3x3` where :func:`_takes_conv_up3x3` holds)."""
    return conv.corr and tuple(conv.strides_up) == (1, 1) and _kernel_takes(conv, x, weight)


def _takes_conv_up3x3(conv: SignalConv2D, x, weight) -> bool:
    """Whether :func:`conv_up3x3` computes ``conv`` on ``x``: a convolution
    (``corr`` false) up-sampled by 2 with ``extra_pad_end``, as
    :func:`_kernel_takes` has it (the generator's up-convolutions as the
    codec decodes; training, float64, the CPU and every other family's 5x5
    up-convolutions keep ``signal_conv``)."""
    return (not conv.corr and tuple(conv.strides_up) == (2, 2) and conv.extra_pad_end
            and _kernel_takes(conv, x, weight))


_ENCODER_WIDTHS = (60, 120, 240, 480, 960)
_UP_WIDTHS = (480, 240, 120, 60)


def _generator_conv(conv: SignalConv2D, x):
    """The dense generator's convolution without its bias: :func:`conv3x3`
    where :func:`_takes_conv3x3` says so, :func:`conv_up3x3` where
    :func:`_takes_conv_up3x3` does, else ``conv.convolve``."""
    weight = conv.kernel()
    if _takes_conv3x3(conv, x, weight):
        with span("hific/generator_conv"):
            return conv3x3(x, weight)
    if _takes_conv_up3x3(conv, x, weight):
        with span("hific/generator_upconv"):
            return conv_up3x3(x, weight)
    return conv.convolve(x)


class _Wiring(NamedTuple):
    """HiFiC's layer order, written once over ``convolve(conv, x)``, a layer's
    convolution without its bias, and ``each(fn, *parts)``, ``fn`` on each
    part: the whole tensors (the dense forwards), or each shard on its device
    with that device's copy of the parameters ``fn`` reads (``model.sharded_*``)."""

    convolve: Callable
    each: Callable

    def conv_norm(self, conv: SignalConv2D, norm: ChannelNorm, x, residual=None, relu=False):
        """``norm(conv(x))`` with the convolution's bias, and the ReLU or the
        residual add after the norm, handed to the norm's one pass."""
        if conv.activation is not None:
            raise ValueError("a convolution before a ChannelNorm has no activation of its own")
        # The norm takes contiguous (rows, C) rows: conv3x3 and cuDNN's float32
        # convolutions leave channels-last memory, which is that already; cuDNN's
        # float64 ones leave NCHW memory, copied here.
        parts = [self.convolve(conv, x)] + ([] if residual is None else [residual])
        return self.each(lambda t, *r: norm(t.contiguous(), conv.bias, *r, relu=relu), *parts)

    def encode(self, enc: Encoder, x):
        for i in range(len(_ENCODER_WIDTHS)):
            x = self.conv_norm(getattr(enc, f"conv{i}"), getattr(enc, f"norm{i}"), x, relu=True)
        return self.each(lambda t: t + enc.conv_out.bias, self.convolve(enc.conv_out, x))

    def residual(self, block: ResidualBlock, x):
        h = self.conv_norm(block.conv0, block.norm0, x, relu=True)
        return self.conv_norm(block.conv1, block.norm1, h, residual=x)

    def generate(self, gen: Generator, y):
        # y as the encoder or the entropy model left it (NCHW memory in float64).
        x = self.each(lambda t: gen.norm_in(t.contiguous()), y)
        x = self.conv_norm(gen.conv_in, gen.norm_head, x)
        for i in range(gen.num_residual_blocks):
            x = self.residual(getattr(gen, f"res{i}"), x)
        for i in range(len(_UP_WIDTHS)):
            x = self.conv_norm(getattr(gen, f"up{i}"), getattr(gen, f"upnorm{i}"), x, relu=True)
        return self.each(lambda t: t + gen.conv_out.bias, self.convolve(gen.conv_out, x))


def _whole(fn, *parts):
    return fn(*parts)


# The encoder keeps signal_conv: its one convolution that conv3x3 could take,
# conv_out, stays cuDNN's, and so do the compressed blobs.
_ENCODER = _Wiring(lambda conv, x: conv.convolve(x), _whole)
_GENERATOR = _Wiring(_generator_conv, _whole)


class ResidualBlock(nn.Module):
    def __init__(self, filters: int, gen: torch.Generator):
        super().__init__()
        self.conv0 = _conv(filters, filters, 3, gen)
        self.norm0 = ChannelNorm(filters)
        self.conv1 = _conv(filters, filters, 3, gen)
        self.norm1 = ChannelNorm(filters)

    def forward(self, x):
        return _GENERATOR.residual(self, x)


class Encoder(nn.Module):
    """Image -> y: a 7x7 conv to 60 channels, four stride-2 3x3 convs
    (120, 240, 480, 960), each with ChannelNorm and ReLU, then a 3x3 conv
    to ``num_latents``."""

    def __init__(self, num_latents: int, gen: torch.Generator):
        super().__init__()
        self.conv0 = _conv(3, _ENCODER_WIDTHS[0], 7, gen)
        self.norm0 = ChannelNorm(_ENCODER_WIDTHS[0])
        for i, (cin, cout) in enumerate(zip(_ENCODER_WIDTHS, _ENCODER_WIDTHS[1:])):
            self.add_module(f"conv{i + 1}", _conv(cin, cout, 3, gen, strides_down=2))
            self.add_module(f"norm{i + 1}", ChannelNorm(cout))
        self.conv_out = _conv(_ENCODER_WIDTHS[-1], num_latents, 3, gen)

    def forward(self, x):
        return _ENCODER.encode(self, x)


class Generator(nn.Module):
    """y_hat -> image: ChannelNorm, a 3x3 conv to 960 channels, ChannelNorm,
    the residual blocks, four 3x3 up-convolutions (stride 2; 480, 240, 120,
    60) with ChannelNorm and ReLU, and a 7x7 conv to 3 channels."""

    def __init__(self, num_latents: int, num_residual_blocks: int, gen: torch.Generator):
        super().__init__()
        self.num_residual_blocks = num_residual_blocks
        self.norm_in = ChannelNorm(num_latents)
        self.conv_in = _conv(num_latents, 960, 3, gen)
        self.norm_head = ChannelNorm(960)
        for i in range(num_residual_blocks):
            self.add_module(f"res{i}", ResidualBlock(960, gen))
        for i, (cin, cout) in enumerate(zip((960,) + _UP_WIDTHS, _UP_WIDTHS)):
            self.add_module(f"up{i}", _conv(cin, cout, 3, gen, corr=False, strides_up=2))
            self.add_module(f"upnorm{i}", ChannelNorm(cout))
        self.conv_out = _conv(_UP_WIDTHS[-1], 3, 7, gen)

    def forward(self, y):
        return _GENERATOR.generate(self, y)


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """TF "SAME" padding of one axis of size n for a k-tap kernel at stride
    s: ``ceil(n / s)`` outputs, the smaller half of the padding before."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _l2_normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.sum(x * x) + eps)


class Conv(nn.Module):
    """flax ``nn.Conv(cout, (k, k), strides=s, padding="SAME")`` over NHWC:
    ``weight`` OIHW at flax's ``lecun_normal`` init (a truncated normal at
    ``fan_in``), ``bias`` zeros."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, gen: torch.Generator):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        truncated_normal_init(self.weight, gen, "fan_in")
        self.bias = nn.Parameter(torch.zeros(cout))

    def conv(self, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        k = weight.shape[-1]
        pad = tuple(same_pads(n, k, self.stride) for n in x.shape[1:3])
        return conv_nhwc(x, weight, pad, (self.stride, self.stride)) + self.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x, self.weight)


class SpectralNormConv(Conv):
    """``nn.SpectralNorm(nn.Conv(...))`` of flax, one power step a call (see
    the module docstring): a :class:`Conv` with the buffers ``u`` (1,
    cout), drawn N(0, 1), and ``sigma`` (), one."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, gen: torch.Generator,
                 epsilon: float = 1e-12):
        super().__init__(cin, cout, k, stride, gen)
        self.epsilon = epsilon
        self.register_buffer("u", torch.randn(1, cout, generator=gen))
        self.register_buffer("sigma", torch.ones(()))

    def normalized_weight(self, update_stats: bool) -> torch.Tensor:
        cout = self.weight.shape[0]
        w = self.weight.permute(2, 3, 1, 0).reshape(-1, cout)  # (kh*kw*cin, cout)
        with torch.no_grad():
            v = _l2_normalize(self.u @ w.T, self.epsilon)
            u = _l2_normalize(v @ w, self.epsilon)
        sigma = ((v @ w) @ u.T)[0, 0]
        if update_stats:
            self.u.copy_(u)
            self.sigma.copy_(sigma.detach())
        return self.weight / torch.where(sigma != 0, sigma, torch.ones_like(sigma))

    def forward(self, x: torch.Tensor, update_stats: bool) -> torch.Tensor:
        return self.conv(x, self.normalized_weight(update_stats))


class Discriminator(nn.Module):
    """Conditional patch discriminator: the latent projected to 12 channels
    (``latent_proj``, a SignalConv2D without spectral norm), ReLU, a
    nearest 16x upsample cut to the image's size and put after its 3
    channels; then four spectral-normalized 4x4 convs (64, 128, 256 at
    stride 2, 512 at stride 1) with leaky ReLU 0.2, and a spectral-
    normalized 1x1 conv to one logit a position."""

    def __init__(self, num_latents: int, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.latent_proj = _conv(num_latents, 12, 3, gen)
        cin = 3 + 12
        for i, (f, stride) in enumerate(((64, 2), (128, 2), (256, 2), (512, 1))):
            self.add_module(f"conv{i}", SpectralNormConv(cin, f, 4, stride, gen))
            cin = f
        self.conv_out = SpectralNormConv(cin, 1, 1, 1, gen)

    def forward(self, x: torch.Tensor, y_latent: torch.Tensor,
                update_stats: bool = True) -> torch.Tensor:
        c = torch.relu(self.latent_proj(y_latent))
        n, hc, wc, ch = c.shape
        c = c[:, :, None, :, None, :].expand(n, hc, 16, wc, 16, ch).reshape(
            n, 16 * hc, 16 * wc, ch)
        h = torch.cat([x, c[:, : x.shape[1], : x.shape[2], :]], dim=-1)
        for i in range(4):
            h = getattr(self, f"conv{i}")(h, update_stats)
            h = torch.where(h >= 0, h, 0.2 * h)  # flax leaky_relu: slope 1 at 0
        return self.conv_out(h, update_stats)
