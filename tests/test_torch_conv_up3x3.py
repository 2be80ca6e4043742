"""HiFiC's hand-written stride-2 3x3 up-convolution on the CPU: the
wrapper's twin against ``signal_conv`` in float64 at the generator's width
pairs (fewer pixels) and against the JAX package's SignalConv2D in float32,
the weight split it shares with the 3x3 kernel, the generator's rule for
when the kernel takes a convolution, how the benchmark classes the kernel,
and the metric that reads its span. The kernel itself runs on the card
(``tests/test_torch_cuda.py``)."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmark import harness, trace
from compression_tpu.layers import SignalConv2D as JaxSignalConv2D
from compression_tpu_torch.convert import kernel_to_torch
from compression_tpu_torch.layers.conv3x3_kernel import _split_weights, split_tf32
from compression_tpu_torch.layers.conv_up3x3_kernel import (PHASE_TAPS, conv_up3x3,
                                                            conv_up3x3_reference)
from compression_tpu_torch.layers.signal_conv import SignalConv2D, signal_conv
from compression_tpu_torch.models.hific import archs

# The profiler's names of the kernel's two tile widths, as ``torch.profiler``
# gives them on the card.
KERNEL_NAMES = [f"void (anonymous namespace)::conv_up3x3_fprop_3xtf32_kernel<{n}>(CUtensorMap_st, "
                "CUtensorMap_st, CUtensorMap_st, float*, (anonymous namespace)::Shape)"
                for n in (120, 64)]

UP = dict(corr=False, strides_up=2, padding="same_zeros")


def _inputs(shape, dtype, seed=0):
    n, h, w, cin, cout = shape
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, h, w, cin, generator=gen, dtype=dtype)
    weight = torch.randn(cout, cin, 3, 3, generator=gen, dtype=dtype) / (9 * cin) ** 0.5
    return x, weight


@pytest.mark.parametrize("shape", [(2, 3, 4, 960, 480), (2, 4, 5, 480, 240), (1, 5, 6, 240, 120),
                                   (2, 6, 7, 120, 60), (3, 5, 7, 8, 12), (2, 1, 1, 12, 8),
                                   (1, 1, 5, 8, 4), (1, 7, 1, 4, 8)],
                         ids=["up0", "up1", "up2", "up3", "odd", "one_pixel", "one_row",
                              "one_column"])
def test_twin_is_signal_conv_in_float64(shape):
    x, weight = _inputs(shape, torch.float64)
    want = signal_conv(x, weight, **UP)
    got = conv_up3x3(x, weight)
    n, h, w, _, cout = shape
    assert got.shape == (n, 2 * h, 2 * w, cout) and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    assert conv_up3x3_reference(x, weight).equal(got)


@pytest.mark.parametrize("hw", [(8, 6), (7, 9), (1, 1)])
def test_twin_is_the_jax_up_convolution(hw):
    """The JAX package's SignalConv2D (3x3, ``corr=False``, up-sampled by 2,
    zero "same" padding) in float32, at its parity tests' 1e-5."""
    cin, cout = 8, 12
    rng = np.random.RandomState(hw[0] * 10 + hw[1])
    x = rng.randn(2, *hw, cin).astype(np.float32)
    kernel = rng.randn(3, 3, cin, cout).astype(np.float32) * 0.2
    flax_mod = JaxSignalConv2D(cout, kernel_support=3, use_bias=False, **UP)
    want = np.asarray(flax_mod.apply({"params": {"kernel": jnp.asarray(kernel)}},
                                     jnp.asarray(x)))
    got = conv_up3x3_reference(torch.from_numpy(x), kernel_to_torch(kernel)).numpy()
    assert got.shape == want.shape == (2, 2 * hw[0], 2 * hw[1], cout)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_the_phases_take_each_tap_once():
    """Nine (phase, tap) products: 1, 2, 2 and 4 taps, each of the kernel's
    nine taps once, each reading x at its phase's shift."""
    assert [len(taps) for taps in PHASE_TAPS] == [1, 2, 2, 4]
    used = [k for taps in PHASE_TAPS for _, k in taps]
    assert sorted(used) == [(ky, kx) for ky in range(3) for kx in range(3)]
    for p, taps in enumerate(PHASE_TAPS):
        a, b = divmod(p, 2)
        for (dy, dx), (ky, kx) in taps:
            # out[2i + a] reads the up-sampled input at 2i + a + 1 - k, which is x[i + dy].
            assert (a + 1 - ky, b + 1 - kx) == (2 * dy, 2 * dx)


def test_a_changed_weight_gets_a_new_split():
    """The kernel reads the 3x3 kernel's split of the weight as the layer
    holds it (``conv3x3_kernel._launch``), kept while the weight is
    unchanged and made anew after an in-place update."""
    weight = torch.nn.Parameter(torch.randn(8, 4, 3, 3))
    first = _split_weights(weight)
    assert _split_weights(weight)[0] is first[0]
    with torch.no_grad():
        weight.add_(1.0)
    again = _split_weights(weight)
    assert again[0] is not first[0]
    assert again[0].equal(split_tf32(weight)[0]) and again[1].equal(split_tf32(weight)[1])


def _generator():
    return archs.Generator(num_latents=220, num_residual_blocks=1, gen=torch.Generator())


def _on_card(shape, dtype=torch.float32, requires_grad=False):
    """A stand-in for a CUDA tensor: what the rule reads of one."""
    return types.SimpleNamespace(device=torch.device("cuda"), dtype=dtype, shape=shape,
                                 requires_grad=requires_grad)


def test_the_kernel_takes_the_up_convolutions_on_the_card_without_grad():
    g = _generator()
    for conv, cin in ((g.up0, 960), (g.up1, 480), (g.up2, 240), (g.up3, 120)):
        x, w = _on_card((1, 4, 6, cin)), conv.kernel()
        assert w.requires_grad
        assert not archs._takes_conv_up3x3(conv, x, w)  # autograd wants the weight's gradient
        with torch.no_grad():
            assert archs._takes_conv_up3x3(conv, x, w)
            assert not archs._takes_conv3x3(conv, x, w)
            assert not archs._takes_conv_up3x3(conv, torch.zeros(1, 4, 6, cin), w)  # the CPU
            assert not archs._takes_conv_up3x3(conv, _on_card((1, 4, 6, cin), torch.float64),
                                               w.double())
        with torch.inference_mode():
            assert archs._takes_conv_up3x3(conv, x, w)
        assert archs._takes_conv_up3x3(conv, x, w.detach())
        assert not archs._takes_conv_up3x3(conv, _on_card((1, 4, 6, cin), requires_grad=True),
                                           w.detach())


def test_the_kernel_takes_no_other_convolution():
    """5x5 up-convolutions (every other family's), channel-separable ones,
    correlations, stride 1, no ``extra_pad_end``, and HiFiC's other layers
    keep ``signal_conv`` or the 3x3 kernel."""
    g, gen = _generator(), torch.Generator()
    e = archs.Encoder(220, gen)
    cases = [(SignalConv2D(8, 12, 5, **UP, generator=gen), 8),
             (SignalConv2D(8, 1, 3, **UP, channel_separable=True, generator=gen), 8),
             (SignalConv2D(8, 12, 3, corr=True, strides_up=2, padding="same_zeros",
                           generator=gen), 8),
             (SignalConv2D(8, 12, 3, corr=False, padding="same_zeros", generator=gen), 8),
             (SignalConv2D(8, 12, 3, **UP, extra_pad_end=False, generator=gen), 8),
             (SignalConv2D(8, 12, 3, corr=False, strides_up=2, padding="valid",
                           generator=gen), 8),
             (SignalConv2D(6, 8, 3, **UP, generator=gen), 6),
             (g.conv_in, 220), (g.res0.conv0, 960), (g.conv_out, 60), (e.conv1, 60),
             (e.conv4, 480)]
    with torch.no_grad():
        for conv, cin in cases:
            assert not archs._takes_conv_up3x3(conv, _on_card((1, 4, 4, cin)), conv.kernel())


def test_the_cpu_path_never_launches(monkeypatch):
    """On the CPU the generator's up-convolutions run ``convolve``
    (signal_conv), never the kernel's wrapper, so the CPU numbers and the
    JAX parity tests are the ones signal_conv gives."""
    g = _generator()
    called = []
    monkeypatch.setattr(archs, "conv_up3x3", lambda *a: called.append(a))
    before = conv_up3x3.launches
    with torch.no_grad():
        g(torch.randn(1, 2, 3, 220))
    assert called == [] and conv_up3x3.launches == before


@pytest.mark.parametrize("name", KERNEL_NAMES, ids=["tile120", "tile64"])
def test_the_profiler_classes_the_kernel_as_a_forward_convolution(name):
    assert trace.kind_of(name, []) == "conv_forward"
    assert trace.kind_of(name, ["hific/generator_upconv"]) == "conv_forward"
    for part in ("gdn_kernel", "rans_", "memcpy", "memset", "dgrad", "wgrad"):
        assert part not in name.lower()


def _reader():
    return harness.load_module(harness.HERE / "metrics"
                               / "generator_upconv_ms_per_img.decompress.py").read


def test_the_metric_reads_the_spans_device_time():
    record = {"traffic": {"round_batches": 16, "batch": 8},
              "span_device_s": {"decompress": {"hific/generator_upconv": 0.064,
                                               "hific/generator_conv": 0.455,
                                               "hific/channel_norm": 0.03},
                                "compress": {"hific/channel_norm": 0.02}}}
    assert _reader()(record) == pytest.approx(0.5)  # 64 ms over 128 images


def test_the_metric_gives_none_without_the_span():
    read = _reader()
    assert read({"traffic": {"round_batches": 16, "batch": 8}}) is None
    assert read({"traffic": {"round_batches": 16, "batch": 8},
                 "span_device_s": {"decompress": {"hific/generator_conv": 0.455}}}) is None
    assert read({"traffic": {}, "span_device_s": {
        "decompress": {"hific/generator_upconv": 0.06}}}) is None
