"""ms2020-cc10, the channel-wise autoregressive entropy model (Minnen &
Singh, ICIP 2020, arXiv:2007.08739; tensorflow_compression
models/ms2020.py), as the reference computes it: bmshj2018's GDN analysis
and synthesis; a hyper-analysis on signed y (a 3x3 convolution to 320, a
5x5 stride-2 one to 256, a 5x5 stride-2 one to the hyperlatents, ReLU
between); a mean support and a scale support from z_hat (two 5x5
up-convolutions to 192 and 256 with ReLU, then a 3x3 to y's depth); and
y coded in ``num_slices`` slices (10) one after another. Slice i's mean and
scale come from its support and the first ``max_support_slices`` (5)
slices decoded before it, through a network of a 5x5 convolution to 224, a
5x5 one to 128 and a 3x3 one to the slice's depth (ReLU between); sigma is
bounded below by the scale table's 0.11. The slice's symbols are
``round(y_i - mu_i)``, and the slice as decoded is ``symbols + mu_i`` plus
its latent residual prediction, ``0.5 tanh`` of a third such network over
the mean support, the same earlier slices and the slice itself. Every
later slice reads that, and so does the synthesis. Also every parameter's
shape (for weights drawn from the seed), the layers that the roofline
counts, the parts each phase runs, and the widths of the CPU tests.
The family has no training loss here: no cell trains it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmark.reference import entropy
from benchmark.reference.families import bmshj2018
from benchmark.reference.layers import LowerBound, conv, conv_up
from benchmark.roofline.models import Stack

SCALES_MIN = 0.11
NUM_SLICES = 10
MAX_SUPPORT_SLICES = 5
HYPER_ANALYSIS = (320, 256)
SUPPORT = (192, 256)
SLICE_NET = (224, 128)

analysis = bmshj2018.analysis
synthesis = bmshj2018.synthesis

# Encoding runs the slice chain too: each slice's rows need the slices
# before it as the decoder will hold them, LRP included.
PHASES = {
    "compress": ("analysis", "hyper_analysis", "hyper_synthesis", "y_model"),
    "decompress": ("hyper_synthesis", "y_model", "synthesis"),
    "train": ("analysis", "hyper_analysis", "hyper_synthesis", "y_model", "synthesis"),
}


def y_streams(widths) -> int:
    """One y stream a slice."""
    return int(widths.get("num_slices", NUM_SLICES))


def _support_slices(widths) -> int:
    return int(widths.get("max_support_slices", MAX_SUPPORT_SLICES))


def _context(decoded: List[torch.Tensor], widths) -> List[torch.Tensor]:
    """The decoded slices a slice conditions on: the first
    ``max_support_slices`` (all of them where it is negative)."""
    m = _support_slices(widths)
    return decoded if m < 0 else decoded[:m]


def hyper_analysis(p, y, widths):
    h = torch.relu(conv(y, p, "hyper_analysis/conv0"))
    h = torch.relu(conv(h, p, "hyper_analysis/conv1", 2))
    return conv(h, p, "hyper_analysis/conv2", 2, bias=False)


def supports(p, z_hat):
    """(mean support, scale support) of z_hat."""
    out = []
    for name in ("mean_support", "scale_support"):
        h = torch.relu(conv_up(z_hat, p, f"{name}/conv0"))
        h = torch.relu(conv_up(h, p, f"{name}/conv1"))
        out.append(conv(h, p, f"{name}/conv2"))
    return tuple(out)


def _net(p, x, name):
    h = torch.relu(conv(x, p, f"{name}/conv0"))
    h = torch.relu(conv(h, p, f"{name}/conv1"))
    return conv(h, p, f"{name}/conv2")


def slice_params(p, i, mu_sup, sigma_sup, decoded, widths):
    """Slice i's (mu, sigma) from the supports and the slices decoded
    before it."""
    ctx = _context(decoded, widths)
    mu = _net(p, torch.cat([mu_sup] + ctx, -1), f"mean_t{i}")
    sigma = _net(p, torch.cat([sigma_sup] + ctx, -1), f"scale_t{i}")
    return mu, LowerBound.apply(sigma, SCALES_MIN)


def slice_lrp(p, i, mu_sup, decoded, y_hat_i, widths):
    """Slice i's latent residual prediction, at most half a bin."""
    ctx = torch.cat([mu_sup] + _context(decoded, widths) + [y_hat_i], -1)
    return 0.5 * torch.tanh(_net(p, ctx, f"lrp_t{i}"))


def y_model(p, y, z_hat, widths):
    """One image's y streams, a slice each in order, ``(int32 symbols,
    sigma)``, and the decoded slices joined, as the synthesis reads them."""
    mu_sup, sigma_sup = supports(p, z_hat)
    s = y.shape[-1] // y_streams(widths)
    decoded: List[torch.Tensor] = []
    streams = []
    for i in range(y_streams(widths)):
        mu, sigma = slice_params(p, i, mu_sup, sigma_sup, decoded, widths)
        sym = torch.round(y[..., i * s : (i + 1) * s] - mu).to(torch.int32)
        y_hat_i = sym.to(torch.float32) + mu
        decoded.append(y_hat_i + slice_lrp(p, i, mu_sup, decoded, y_hat_i, widths))
        streams.append((sym, sigma))
    return streams, torch.cat(decoded, -1)


def _slice_inputs(widths) -> List[int]:
    """The input depth of each slice's mean and scale networks."""
    lat, n = widths["num_latents"], y_streams(widths)
    s = lat // n
    return [lat + s * len(_context(list(range(i)), widths)) for i in range(n)]


def weight_shapes(widths: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of the model (transforms, supports, the slices'
    networks, the factorized prior) and its shape."""
    f, lat, hyp = widths["num_filters"], widths["num_latents"], widths["num_hyperlatents"]
    s = lat // y_streams(widths)
    shapes: Dict[str, Tuple[int, ...]] = {}

    def conv_(name, cin, cout, k, bias=True):
        shapes[f"{name}/kernel"] = (k, k, cin, cout)
        if bias:
            shapes[f"{name}/bias"] = (cout,)

    for part, gdn, cins, couts in (("analysis", "gdn", (3, f, f, f), (f, f, f, lat)),
                                   ("synthesis", "igdn", (lat, f, f, f), (f, f, f, 3))):
        for i in range(4):
            conv_(f"{part}/conv{i}", cins[i], couts[i], 5,
                  bias=not (part == "analysis" and i == 3))
            if i < 3:
                shapes[f"{part}/{gdn}{i}/beta"] = (f,)
                shapes[f"{part}/{gdn}{i}/gamma"] = (f, f)
    conv_("hyper_analysis/conv0", lat, HYPER_ANALYSIS[0], 3)
    conv_("hyper_analysis/conv1", HYPER_ANALYSIS[0], HYPER_ANALYSIS[1], 5)
    conv_("hyper_analysis/conv2", HYPER_ANALYSIS[1], hyp, 5, bias=False)
    for name in ("mean_support", "scale_support"):
        conv_(f"{name}/conv0", hyp, SUPPORT[0], 5)
        conv_(f"{name}/conv1", SUPPORT[0], SUPPORT[1], 5)
        conv_(f"{name}/conv2", SUPPORT[1], lat, 3)
    for i, cin in enumerate(_slice_inputs(widths)):
        for name, c in ((f"mean_t{i}", cin), (f"scale_t{i}", cin), (f"lrp_t{i}", cin + s)):
            conv_(f"{name}/conv0", c, SLICE_NET[0], 5)
            conv_(f"{name}/conv1", SLICE_NET[0], SLICE_NET[1], 5)
            conv_(f"{name}/conv2", SLICE_NET[1], s, 3)
    shapes.update(entropy.prior_shapes(hyp))
    return shapes


def layers(widths, part, n, h, w):
    """The layers of one part for ``n`` images of h x w: the transforms,
    ``hyper_synthesis`` (the two supports) and ``y_model`` (the slices'
    30 networks)."""
    lat, hyp = widths["num_latents"], widths["num_hyperlatents"]
    if part in ("analysis", "synthesis"):
        return bmshj2018.layers(widths, part, n, h, w)
    if part == "hyper_analysis":
        b = Stack(n, h // 16, w // 16, lat)
        b.conv("hyper_analysis/conv0", HYPER_ANALYSIS[0], 3)
        b.conv("hyper_analysis/conv1", HYPER_ANALYSIS[1], 5, 2)
        b.conv("hyper_analysis/conv2", hyp, 5, 2, bias=False)
        return b.layers
    out = []
    if part == "hyper_synthesis":
        for name in ("mean_support", "scale_support"):
            b = Stack(n, h // 64, w // 64, hyp)
            b.conv(f"{name}/conv0", SUPPORT[0], 5, up=True)
            b.conv(f"{name}/conv1", SUPPORT[1], 5, up=True)
            b.conv(f"{name}/conv2", lat, 3)
            out += b.layers
        return out
    s = lat // y_streams(widths)
    for i, cin in enumerate(_slice_inputs(widths)):
        for name, c in ((f"mean_t{i}", cin), (f"scale_t{i}", cin), (f"lrp_t{i}", cin + s)):
            b = Stack(n, h // 16, w // 16, c)
            b.conv(f"{name}/conv0", SLICE_NET[0], 5)
            b.conv(f"{name}/conv1", SLICE_NET[1], 5)
            b.conv(f"{name}/conv2", s, 3)
            out += b.layers
    return out


def small_widths(widths):
    """The widths the CPU tests run the family at: the transforms and y
    narrow, the slices, the supports' and the slices' networks as
    published."""
    return {**widths, "num_filters": 16, "num_latents": 20, "num_hyperlatents": 8}
