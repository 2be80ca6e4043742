"""bmshj2018, the scale hyperprior (Balle et al., ICLR 2018), as the
reference computes it: analysis of four 5x5 stride-2 convolutions with GDN
between them, synthesis mirrored with IGDN, hyper-analysis on ``|y|`` (3x3,
then two 5x5 stride-2, ReLU between), hyper-synthesis (two 5x5
up-convolutions with ReLU, a 3x3) giving sigma bounded below by the scale
table's 0.11 and no mean; the training loss ``bpp + lmbda * 255^2 * MSE``
with tensorflow_compression's training-time noise; and the layers that the
roofline counts.

The weights come from a checkpoint, so the family draws none.
"""

from __future__ import annotations

import torch

from benchmark.reference import entropy
from benchmark.reference.layers import LowerBound, conv, conv_up, gdn
from benchmark.roofline.models import Stack

SCALES_MIN = 0.11


def analysis(p, x, widths):
    for i in range(3):
        x = gdn(conv(x, p, f"analysis/conv{i}", 2), p, f"analysis/gdn{i}")
    return conv(x, p, "analysis/conv3", 2, bias=False)


def synthesis(p, y, widths):
    for i in range(3):
        y = gdn(conv_up(y, p, f"synthesis/conv{i}"), p, f"synthesis/igdn{i}", inverse=True)
    return conv_up(y, p, "synthesis/conv3")


def hyper_analysis(p, y, widths):
    h = torch.relu(conv(torch.abs(y), p, "hyper_analysis/conv0"))
    h = torch.relu(conv(h, p, "hyper_analysis/conv1", 2))
    return conv(h, p, "hyper_analysis/conv2", 2, bias=False)


def hyper_synthesis(p, z, widths):
    h = torch.relu(conv_up(z, p, "hyper_synthesis/conv0"))
    h = torch.relu(conv_up(h, p, "hyper_synthesis/conv1"))
    return None, LowerBound.apply(conv(h, p, "hyper_synthesis/conv2"), SCALES_MIN)


def uniform_noise(like, generator):
    """U(-1/2, 1/2) shaped like ``like``, from ``generator`` on its device."""
    return torch.rand(like.shape, generator=generator, dtype=like.dtype,
                      device=like.device) - 0.5


def rd_loss(cfg: dict, p: dict, x: torch.Tensor, generator):
    """The rate-distortion loss of a float batch x in [0, 1] (N, H, W, 3):
    noise added to z, then to y, from one generator; z's bits under the
    noise-convolved factorized prior, y's under the noise-convolved
    Gaussian at sigma's table scale."""
    widths = cfg["widths"]
    y = analysis(p, x, widths)
    z = hyper_analysis(p, y, widths)
    z_tilde = z + uniform_noise(z, generator)
    z_bits = entropy.z_bits(entropy.prior_params(p), z_tilde)
    _mu, sigma = hyper_synthesis(p, z_tilde, widths)
    y_tilde = y + uniform_noise(y, generator)
    y_bits = entropy.y_bits(y_tilde, sigma)
    x_hat = synthesis(p, y_tilde, widths)
    bpp = (torch.mean(y_bits) + torch.mean(z_bits)) / (x.shape[1] * x.shape[2])
    mse = torch.mean(torch.square(x - x_hat)) * (255.0 ** 2)
    return bpp + cfg["training"]["lmbda"] * mse


def layers(widths, part, n, h, w):
    """The layers of one transform for ``n`` images of h x w."""
    f, lat, hyp = widths["num_filters"], widths["num_latents"], widths["num_hyperlatents"]
    if part == "analysis":
        b = Stack(n, h, w, 3)
        for i in range(3):
            b.conv(f"analysis/conv{i}", f, 5, 2)
            b.pointwise("gdn", f"analysis/gdn{i}")
        b.conv("analysis/conv3", lat, 5, 2, bias=False)
    elif part == "hyper_analysis":
        b = Stack(n, h // 16, w // 16, lat)
        b.conv("hyper_analysis/conv0", f, 3)
        b.conv("hyper_analysis/conv1", f, 5, 2)
        b.conv("hyper_analysis/conv2", hyp, 5, 2, bias=False)
    elif part == "hyper_synthesis":
        b = Stack(n, h // 64, w // 64, hyp)
        b.conv("hyper_synthesis/conv0", f, 5, up=True)
        b.conv("hyper_synthesis/conv1", f, 5, up=True)
        b.conv("hyper_synthesis/conv2", lat, 3)
    else:
        b = Stack(n, h // 16, w // 16, lat)
        for i in range(3):
            b.conv(f"synthesis/conv{i}", f, 5, up=True)
            b.pointwise("gdn", f"synthesis/igdn{i}")
        b.conv("synthesis/conv3", 3, 5, up=True)
    return b.layers
