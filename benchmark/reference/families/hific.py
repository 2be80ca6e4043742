"""HiFiC's generator network (Mentzer et al., NeurIPS 2020), as the
reference computes it: an encoder of a 7x7 convolution to 60 channels and
four stride-2 3x3 convolutions (120 ... 960), each with ChannelNorm and
ReLU, then a 3x3 convolution to the latents; mbt2018's mean-scale hyper
pair on signed y (the synthesis's last convolution gives mu and sigma); the
generator of ChannelNorm, a 3x3 convolution to 960, ChannelNorm, residual
blocks, four 3x3 up-convolutions (480 ... 60) with ChannelNorm and ReLU,
and a 7x7 convolution to 3 channels. Also every parameter's shape (for
weights drawn from the seed) and the layers that the roofline counts.
The family has no training loss here: no cell trains it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from benchmark.reference import entropy
from benchmark.reference.layers import LowerBound, channel_norm, conv, conv_up
from benchmark.roofline.models import Stack

SCALES_MIN = 0.11
ENCODER = (60, 120, 240, 480, 960)
UP = (480, 240, 120, 60)


def analysis(p, x, widths):
    for i in range(len(ENCODER)):
        x = conv(x, p, f"encoder/conv{i}", 1 if i == 0 else 2)
        x = torch.relu(channel_norm(x, p, f"encoder/norm{i}"))
    return conv(x, p, "encoder/conv_out")


def synthesis(p, y, widths):
    x = channel_norm(y, p, "generator/norm_in")
    x = channel_norm(conv(x, p, "generator/conv_in"), p, "generator/norm_head")
    for i in range(int(widths["num_residual_blocks"])):
        r = f"generator/res{i}"
        h = torch.relu(channel_norm(conv(x, p, f"{r}/conv0"), p, f"{r}/norm0"))
        x = x + channel_norm(conv(h, p, f"{r}/conv1"), p, f"{r}/norm1")
    for i in range(len(UP)):
        x = torch.relu(channel_norm(conv_up(x, p, f"generator/up{i}"), p,
                                    f"generator/upnorm{i}"))
    return conv(x, p, "generator/conv_out")


def hyper_analysis(p, y, widths):
    h = torch.relu(conv(y, p, "hyper_analysis/conv0"))
    h = torch.relu(conv(h, p, "hyper_analysis/conv1", 2))
    return conv(h, p, "hyper_analysis/conv2", 2, bias=False)


def hyper_synthesis(p, z, widths):
    h = torch.relu(conv_up(z, p, "hyper_synthesis/conv0"))
    h = torch.relu(conv_up(h, p, "hyper_synthesis/conv1"))
    mu, sigma = torch.chunk(conv(h, p, "hyper_synthesis/conv2"), 2, dim=-1)
    return mu, LowerBound.apply(sigma, SCALES_MIN)


def weight_shapes(widths: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of HiFiC's G side (encoder, generator, mbt2018's
    hyper pair, the factorized prior) and its shape."""
    lat, hyp = widths["num_latents"], widths["num_hyperlatents"]
    shapes: Dict[str, Tuple[int, ...]] = {}

    def conv_(name, cin, cout, k, bias=True):
        shapes[f"{name}/kernel"] = (k, k, cin, cout)
        if bias:
            shapes[f"{name}/bias"] = (cout,)

    def norm(name, c):
        shapes[f"{name}/gamma"] = (c,)
        shapes[f"{name}/beta"] = (c,)

    cin = 3
    for i, c in enumerate(ENCODER):
        conv_(f"encoder/conv{i}", cin, c, 7 if i == 0 else 3)
        norm(f"encoder/norm{i}", c)
        cin = c
    conv_("encoder/conv_out", cin, lat, 3)
    norm("generator/norm_in", lat)
    conv_("generator/conv_in", lat, 960, 3)
    norm("generator/norm_head", 960)
    for i in range(widths["num_residual_blocks"]):
        for j in range(2):
            conv_(f"generator/res{i}/conv{j}", 960, 960, 3)
            norm(f"generator/res{i}/norm{j}", 960)
    cin = 960
    for i, c in enumerate(UP):
        conv_(f"generator/up{i}", cin, c, 3)
        norm(f"generator/upnorm{i}", c)
        cin = c
    conv_("generator/conv_out", cin, 3, 7)
    conv_("hyper_analysis/conv0", lat, hyp, 3)
    conv_("hyper_analysis/conv1", hyp, hyp, 5)
    conv_("hyper_analysis/conv2", hyp, hyp, 5, bias=False)
    conv_("hyper_synthesis/conv0", hyp, hyp, 5)
    conv_("hyper_synthesis/conv1", hyp, hyp * 3 // 2, 5)
    conv_("hyper_synthesis/conv2", hyp * 3 // 2, 2 * lat, 3)
    shapes.update(entropy.prior_shapes(hyp))
    return shapes


def layers(widths, part, n, h, w):
    """The layers of one transform for ``n`` images of h x w."""
    lat, hyp = widths["num_latents"], widths["num_hyperlatents"]
    if part == "analysis":
        b = Stack(n, h, w, 3)
        for i, c in enumerate(ENCODER):
            b.conv(f"encoder/conv{i}", c, 7 if i == 0 else 3, 1 if i == 0 else 2)
            b.pointwise("channelnorm", f"encoder/norm{i}")
        b.conv("encoder/conv_out", lat, 3)
    elif part == "hyper_analysis":
        b = Stack(n, h // 16, w // 16, lat)
        b.conv("hyper_analysis/conv0", hyp, 3)
        b.conv("hyper_analysis/conv1", hyp, 5, 2)
        b.conv("hyper_analysis/conv2", hyp, 5, 2, bias=False)
    elif part == "hyper_synthesis":
        b = Stack(n, h // 64, w // 64, hyp)
        b.conv("hyper_synthesis/conv0", hyp, 5, up=True)
        b.conv("hyper_synthesis/conv1", hyp * 3 // 2, 5, up=True)
        b.conv("hyper_synthesis/conv2", 2 * lat, 3)
    else:
        b = Stack(n, h // 16, w // 16, lat)
        b.pointwise("channelnorm", "generator/norm_in")
        b.conv("generator/conv_in", 960, 3)
        b.pointwise("channelnorm", "generator/norm_head")
        for i in range(widths["num_residual_blocks"]):
            r = f"generator/res{i}"
            b.conv(f"{r}/conv0", 960, 3)
            b.pointwise("channelnorm", f"{r}/norm0")
            b.conv(f"{r}/conv1", 960, 3)
            b.pointwise("channelnorm", f"{r}/norm1")
            b.pointwise("add", f"{r}/add")
        for i, c in enumerate(UP):
            b.conv(f"generator/up{i}", c, 3, up=True)
            b.pointwise("channelnorm", f"generator/upnorm{i}")
        b.conv("generator/conv_out", 3, 7)
    return b.layers


def small_widths(widths):
    """The widths the CPU tests run the family at."""
    return {"num_latents": 8, "num_hyperlatents": 4, "num_residual_blocks": 1}
