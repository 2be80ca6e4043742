"""The FLOP and byte counters against hand counts at the cells' shapes:
one convolution, one K1 call, one coded stream; and each configuration's
whole-model FLOPs against the sum over its layers."""

import json
import pathlib

import pytest

from benchmark.roofline import conv, k1, models, peaks, rans

BENCH = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = {n: json.loads((BENCH / "configs" / f"{n}.json").read_text())
           for n in ("bmshj2018", "hific-mi")}
# A family with no cell yet, at its published widths.
CONFIGS["ms2020-cc10"] = {"family": "ms2020", "widths": {
    "num_filters": 192, "num_latents": 320, "num_hyperlatents": 192}}


def test_one_convolution_at_the_codec_shape():
    # bmshj2018's analysis conv1: 8 images of 256x384x192 -> 128x192x192, 5x5, stride 2.
    flops = conv.conv_flops(8, 256, 384, 192, 192, 5, 2)
    assert flops == 2 * 8 * 128 * 192 * 192 * 192 * 25 == 362_387_865_600
    nbytes = conv.conv_bytes(8, 256, 384, 192, 192, 5, 2)
    assert nbytes == 4 * (8 * 256 * 384 * 192 + 25 * 192 * 192 + 192 + 8 * 128 * 192 * 192)
    assert conv.conv_bound_s(flops, nbytes) == flops / 67e12  # FLOP-bound


def test_an_up_sampling_convolution_counts_k_squared_taps_an_input():
    # bmshj2018's synthesis conv2: 128x192x192 -> 256x384x192, 5x5 up.
    assert conv.conv_flops(8, 128, 192, 192, 192, 5, up=True) == 2 * 8 * 128 * 192 * 192 * 192 * 25
    assert conv.out_size(128, up=True) == 256


def test_one_k1_call():
    rows, c = 8 * 256 * 384, 192
    nbytes = 4 * (2 * rows * c + c * c + c)
    assert k1.gdn_bytes(rows, c) == nbytes == 1_208_107_776
    assert k1.bound_s(rows, c) == pytest.approx(nbytes / 3.35e12)
    assert nbytes / 3.35e12 > 3 * 2 * rows * c * c / 495e12  # bytes bound K1 here


def test_one_coded_stream():
    n = 48 * 32 * 192  # y's symbols of one 768x512 image
    words = 17_000
    enc = rans.bound_s(1, n, words, decode=False)
    dec = rans.bound_s(1, n, words, decode=True)
    assert enc == pytest.approx(max((5 * n + 2 * words) / 3.35e12, 28 * n / peaks.INT32_OPS))
    assert dec == pytest.approx(max((5 * n + 2 * words) / 3.35e12, 19 * n / peaks.INT32_OPS))
    assert peaks.INT32_OPS == pytest.approx(16.727e12, rel=1e-3)


def test_bmshj2018_analysis_by_hand():
    layers = models.layers(CONFIGS["bmshj2018"], "analysis", 1, 512, 768)
    hand = (2 * 256 * 384 * 3 * 192 * 25 + 2 * 128 * 192 * 192 * 192 * 25
            + 2 * 64 * 96 * 192 * 192 * 25 + 2 * 32 * 48 * 192 * 192 * 25
            + sum(2 * r * 192 * 192 + 3 * r * 192 for r in (256 * 384, 128 * 192, 64 * 96)))
    assert sum(layer.flops() for layer in layers) == hand
    assert [layer.kind for layer in layers].count("gdn") == 3


def test_hific_generator_by_hand():
    layers = models.layers(CONFIGS["hific-mi"], "synthesis", 1, 512, 768)
    res = 9 * (2 * 2 * 1536 * 960 * 960 * 9 + 2 * 7 * 1536 * 960 + 1536 * 960)
    assert sum(1 for layer in layers if layer.kind == "conv") == 1 + 18 + 4 + 1
    convs = sum(layer.flops() for layer in layers if layer.kind == "conv")
    hand = (2 * 1536 * 220 * 960 * 9 + 18 * 2 * 1536 * 960 * 960 * 9
            + 2 * 1536 * 960 * 480 * 9 + 2 * 6144 * 480 * 240 * 9
            + 2 * 24576 * 240 * 120 * 9 + 2 * 98304 * 120 * 60 * 9
            + 2 * 393216 * 60 * 3 * 49)
    assert convs == hand
    assert res < sum(layer.flops() for layer in layers)


def test_ms2020_slices_by_hand():
    # Each of 10 slices: a mean and a scale network over the mean or scale
    # support (320) and the first min(i, 5) decoded slices (32 each), and an
    # LRP network over the slice too; 5x5 to 224, 5x5 to 128, 3x3 to 32, at
    # y's 32x48 grid.
    cfg = CONFIGS["ms2020-cc10"]
    layers = models.layers(cfg, "y_model", 1, 512, 768)
    assert len(layers) == 90 and {layer.kind for layer in layers} == {"conv"}

    def net(cin):
        return 2 * 32 * 48 * (25 * cin * 224 + 25 * 224 * 128 + 9 * 128 * 32)
    hand = sum(2 * net(320 + 32 * min(i, 5)) + net(320 + 32 * min(i, 5) + 32)
               for i in range(10))
    assert sum(layer.flops() for layer in layers) == hand
    assert models.phases(cfg)["compress"][-1] == "y_model"
    assert "y_model" in models.phases(cfg)["decompress"]
    supports = models.layers(cfg, "hyper_synthesis", 1, 512, 768)
    assert [(layer.h, layer.cout, layer.up) for layer in supports[:3]] == [
        (8, 192, True), (16, 256, True), (32, 320, False)]


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("phase", ["compress", "decompress", "train"])
def test_whole_model_flops_are_the_sum_over_the_layers(name, phase):
    cfg = CONFIGS[name]
    n, h, w = (8, 256, 256) if phase == "train" else (8, 512, 768)
    parts = [models.layers(cfg, part, n, h, w) for part in models.phases(cfg)[phase]]
    forward = sum(layer.flops() for part in parts for layer in part)
    total = models.model_flops(cfg, phase, n, h, w)
    assert total == (3 * forward if phase == "train" else forward)
    assert forward == sum(layer.flops() for layer in models.phase_layers(cfg, phase, n, h, w))
