"""HiFiC's hand-written 3x3 convolution on the CPU: the wrapper's twin
against ``signal_conv`` at the generator's layer shapes (fewer pixels), the
weight's TF32 split and the cache that keeps it, the generator's rule for
when the kernel takes a convolution, how the benchmark classes the kernel,
and the metric that reads its span. The kernel itself runs on the card
(``tests/test_torch_cuda.py``)."""

import os
import sys
import threading

import pytest
import torch

from benchmark import harness, trace
from compression_tpu_torch.layers import conv3x3_kernel
from compression_tpu_torch.layers.conv3x3_kernel import conv3x3, conv3x3_reference, split_tf32
from compression_tpu_torch.layers.signal_conv import SignalConv2D, signal_conv
from compression_tpu_torch.models.hific import archs

# The profiler's name of the kernel, as ``torch.profiler`` gives it on the card.
KERNEL_NAME = ("(anonymous namespace)::conv3x3_fprop_3xtf32_kernel(CUtensorMap_st, CUtensorMap_st, "
               "CUtensorMap_st, float*, (anonymous namespace)::Shape)")


@pytest.mark.parametrize("shape", [(2, 4, 6, 220, 960), (1, 4, 6, 960, 960), (3, 5, 7, 8, 12)],
                         ids=["conv_in", "residual", "small"])
def test_twin_is_signal_conv_at_the_generator_shapes(shape):
    n, h, w, cin, cout = shape
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(n, h, w, cin, generator=gen)
    weight = torch.randn(cout, cin, 3, 3, generator=gen) / (9 * cin) ** 0.5
    want = signal_conv(x, weight, corr=True, padding="same_zeros")
    got = conv3x3(x, weight)
    assert got.shape == (n, h, w, cout) and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert conv3x3_reference(x, weight).equal(got)


def test_split_is_two_tf32_parts_of_the_weight():
    gen = torch.Generator().manual_seed(1)
    weight = torch.randn(12, 8, 3, 3, generator=gen) * torch.logspace(-6, 3, 12)[:, None, None,
                                                                                  None]
    hi, lo = split_tf32(weight)
    assert hi.shape == lo.shape == (12, 3, 3, 8)
    assert hi.is_contiguous() and lo.is_contiguous()
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()  # 10 mantissa bits and no more
    w = weight.permute(0, 2, 3, 1)
    torch.testing.assert_close(hi + lo, w, rtol=2.0 ** -21, atol=0)
    # hi is w rounded to nearest: never further from it than half its last bit.
    assert ((w - hi).abs() <= hi.abs() * 2.0 ** -11).all()


def test_a_changed_weight_gets_a_new_split():
    weight = torch.nn.Parameter(torch.randn(8, 4, 3, 3))
    first = conv3x3_kernel._split_weights(weight)
    assert conv3x3_kernel._split_weights(weight)[0] is first[0]  # kept while unchanged
    with torch.no_grad():
        weight.mul_(2)
    again = conv3x3_kernel._split_weights(weight)
    assert again[0] is not first[0]
    assert again[0].equal(split_tf32(weight)[0])
    with torch.inference_mode():
        frozen = torch.randn(8, 4, 3, 3)
    assert conv3x3_kernel._split_weights(frozen)[0].equal(split_tf32(frozen)[0])


def test_threads_share_one_split():
    """The codec's pipeline workers decode concurrently: many threads asking
    for one weight's split at once all get the same tensors, equal to a
    fresh split."""
    weight = torch.nn.Parameter(torch.randn(16, 8, 3, 3))
    got, errors = [], []

    def ask():
        try:
            got.append(conv3x3_kernel._split_weights(weight))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=ask) for _ in range(4 * (os.cpu_count() or 1) + 8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(got) == len(threads)
    assert all(hi is got[0][0] and lo is got[0][1] for hi, lo in got)
    assert got[0][0].equal(split_tf32(weight)[0]) and got[0][1].equal(split_tf32(weight)[1])


def _generator():
    return archs.Generator(num_latents=220, num_residual_blocks=1, gen=torch.Generator())


def test_the_kernel_takes_conv_in_and_the_residual_blocks_without_grad():
    g = _generator()
    latent = torch.zeros(1, 4, 6, 220)
    wide = torch.zeros(1, 4, 6, 960)
    for conv, x in ((g.conv_in, latent), (g.res0.conv0, wide), (g.res0.conv1, wide)):
        w = conv.kernel()
        assert w.requires_grad
        assert not archs._takes_conv3x3(conv, x, w)  # autograd wants the weight's gradient
        with torch.no_grad():
            assert archs._takes_conv3x3(conv, x, w)
        with torch.inference_mode():
            assert archs._takes_conv3x3(conv, x, w)
        assert archs._takes_conv3x3(conv, x, w.detach())
        assert not archs._takes_conv3x3(conv, x.clone().requires_grad_(), w.detach())
        with torch.no_grad():
            assert not archs._takes_conv3x3(conv, x.double(), w.double())


def test_the_kernel_takes_no_other_convolution():
    """The encoder's 7x7 and stride-2 convolutions, the generator's
    up-convolutions and 7x7 ``conv_out``, and widths that are not multiples
    of 4 keep ``signal_conv``."""
    g = _generator()
    e = archs.Encoder(220, torch.Generator())
    odd = archs._conv(6, 8, 3, torch.Generator())
    cases = [(e.conv0, torch.zeros(1, 16, 16, 3)),
             (e.conv1, torch.zeros(1, 16, 16, 60)),
             (e.conv4, torch.zeros(1, 2, 2, 480)),
             (g.up0, torch.zeros(1, 2, 2, 960)),
             (g.up3, torch.zeros(1, 8, 8, 120)),
             (g.conv_out, torch.zeros(1, 16, 16, 60)),
             (odd, torch.zeros(1, 4, 4, 6))]
    with torch.no_grad():
        for conv, x in cases:
            assert not archs._takes_conv3x3(conv, x, conv.kernel())


def test_the_cpu_path_keeps_signal_conv(monkeypatch):
    """On the CPU the generator never calls the kernel's wrapper: each of its
    convolutions runs ``convolve`` (signal_conv), so the CPU numbers (and the
    JAX parity tests) are the ones signal_conv gives."""
    g = _generator()
    called, convolved = [], []
    monkeypatch.setattr(archs, "conv3x3", lambda *a: called.append(a))
    convolve = SignalConv2D.convolve
    monkeypatch.setattr(SignalConv2D, "convolve",
                        lambda conv, x: convolved.append(conv) or convolve(conv, x))
    before = conv3x3.launches
    with torch.no_grad():
        g(torch.randn(1, 2, 3, 220))
    assert called == [] and conv3x3.launches == before
    assert convolved == [g.conv_in, g.res0.conv0, g.res0.conv1, g.up0, g.up1, g.up2, g.up3,
                         g.conv_out]


def test_the_profiler_classes_the_kernel_as_a_forward_convolution():
    assert trace.kind_of(KERNEL_NAME, []) == "conv_forward"
    assert trace.kind_of(KERNEL_NAME, ["hific/generator_conv"]) == "conv_forward"
    for part in ("gdn_kernel", "rans_", "memcpy", "memset", "dgrad", "wgrad"):
        assert part not in KERNEL_NAME.lower()


def _reader():
    return harness.load_module(harness.HERE / "metrics"
                               / "generator_conv_ms_per_img.decompress.py").read


def test_the_metric_reads_the_spans_device_time():
    record = {"traffic": {"round_batches": 16, "batch": 8},
              "span_device_s": {"decompress": {"hific/generator_conv": 0.512,
                                               "hific/channel_norm": 0.03},
                                "compress": {"hific/channel_norm": 0.02}}}
    assert _reader()(record) == pytest.approx(4.0)  # 512 ms over 128 images


def test_the_metric_gives_none_without_the_span():
    read = _reader()
    assert read({"traffic": {"round_batches": 16, "batch": 8}}) is None
    assert read({"traffic": {"round_batches": 16, "batch": 8},
                 "span_device_s": {"decompress": {"hific/channel_norm": 0.03}}}) is None
    assert read({"traffic": {}, "span_device_s": {
        "decompress": {"hific/generator_conv": 0.5}}}) is None
