"""HiFiC's fused ChannelNorm (``layers/channel_norm_kernel.py``) on the CPU:
the twin against the composition HiFiC ran before it, the autograd
Function's backward against plain autograd, the wrapper's routes and
checks (the card's launch stubbed), and the networks' wiring of the bias,
the ReLU and the residual add into the norm. The kernel itself runs only on
the card (``tests/test_torch_cuda.py -k channel_norm``)."""

import itertools

import numpy as np
import pytest
import torch

from compression_tpu_torch.layers import channel_norm_kernel as cnk
from compression_tpu_torch.layers.channel_norm_kernel import (
    FusedChannelNorm,
    fused_channel_norm,
    fused_channel_norm_reference,
)
from compression_tpu_torch.models.hific import archs

WIDTHS = (60, 120, 220, 240, 480, 960, 37)  # HiFiC's widths and an odd one
COMBOS = list(itertools.product((False, True), repeat=3))  # bias, relu, residual


def _inputs(c, bias, residual, dtype=torch.float32, seed=0, shape=(2, 3, 5)):
    """x with mean 3 and std 5 (torch's unbiased variance would be off by
    C / (C - 1)), gamma and beta around 1 and 0, bias and residual normal."""
    gen = torch.Generator().manual_seed(seed + c)
    x = (torch.randn(*shape, c, generator=gen) * 5 + 3).to(dtype)
    gamma = (1 + 0.3 * torch.randn(c, generator=gen)).to(dtype)
    beta = (0.3 * torch.randn(c, generator=gen)).to(dtype)
    b = torch.randn(c, generator=gen).to(dtype) if bias else None
    r = torch.randn(*shape, c, generator=gen).to(dtype) if residual else None
    return x, gamma, beta, b, r


def _composition(x, gamma, beta, bias, residual, relu, eps=1e-3):
    """What HiFiC ran before the kernel: the convolution's ``y + bias``, the
    ChannelNorm's ops, then ``torch.relu`` or ``x + ...``."""
    if bias is not None:
        x = x + bias
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps) * gamma + beta
    if relu:
        out = torch.relu(out)
    return out if residual is None else residual + out


@pytest.mark.parametrize("bias,relu,residual", COMBOS)
@pytest.mark.parametrize("c", WIDTHS)
def test_twin_equals_the_composition(c, bias, relu, residual):
    x, gamma, beta, b, r = _inputs(c, bias, residual)
    got = fused_channel_norm_reference(x, gamma, beta, b, r, relu)
    assert torch.equal(got, _composition(x, gamma, beta, b, r, relu))


def _grads(fn, tensors, w):
    leaves = [t.detach().clone().requires_grad_() if t is not None else None for t in tensors]
    (fn(*leaves) * w).sum().backward()
    return [t.grad if t is not None else None for t in leaves]


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 2e-5)])
@pytest.mark.parametrize("bias,relu,residual", COMBOS)
def test_function_gradients_equal_plain_autograd(bias, relu, residual, dtype, tol):
    """FusedChannelNorm's backward (from the saved mean and rstd) against
    autograd through the twin, for x, gamma, beta, bias and residual, each
    within ``tol`` of its largest entry: float64 to rounding, float32 within
    2e-5 (the two sum the same products in other orders)."""
    c = 60
    tensors = _inputs(c, bias, residual, dtype, seed=7)
    w = torch.randn(tensors[0].shape, generator=torch.Generator().manual_seed(3)).to(dtype)

    def fused(x, g, b, bi, r):
        return FusedChannelNorm.apply(x, g, b, bi, r, relu, 1e-3)

    def plain(x, g, b, bi, r):
        return fused_channel_norm_reference(x, g, b, bi, r, relu)

    got, want = _grads(fused, tensors, w), _grads(plain, tensors, w)
    for name, g, h in zip(("x", "gamma", "beta", "bias", "residual"), got, want):
        assert (g is None) == (h is None), name
        if h is not None:
            torch.testing.assert_close(g, h, rtol=0, atol=tol * h.abs().max().item(), msg=name)


def test_wrapper_takes_the_function_only_for_gradients(monkeypatch):
    """With a tensor that needs a gradient the wrapper's output has
    FusedChannelNorm's grad_fn; without, or under no_grad, it is the twin's
    plain result; a CPU tensor never reaches the launch."""
    monkeypatch.setattr(cnk, "_launch", lambda *a: pytest.fail("a CPU tensor launched"))
    x, gamma, beta, b, r = _inputs(120, True, True)
    want = fused_channel_norm_reference(x, gamma, beta, b, r, True)
    before = fused_channel_norm.launches
    assert torch.equal(fused_channel_norm(x, gamma, beta, b, r, relu=True), want)
    g = gamma.clone().requires_grad_()
    out = fused_channel_norm(x, g, beta, b, r, relu=True)
    assert type(out.grad_fn).__name__ == "FusedChannelNormBackward"
    assert torch.equal(out.detach(), want)
    with torch.no_grad():
        assert fused_channel_norm(x, g, beta, b, r, relu=True).grad_fn is None
    assert fused_channel_norm.launches == before


@pytest.fixture
def stubbed_launch(monkeypatch):
    """The card's route run on CPU tensors, the launch replaced by a
    recorder of its arguments."""
    calls = []
    monkeypatch.setattr(cnk, "_launch", lambda *args: calls.append(args))
    return calls


@pytest.mark.parametrize("bias,relu,residual", [(False, False, False), (True, True, False),
                                                (True, False, True)])
def test_card_route_passes_the_launch_its_arguments(stubbed_launch, bias, relu, residual):
    """One launch of (rows, C) rows; bias and residual pointers null where
    they are not given; the statistics' pointers only with ``stats``."""
    x, gamma, beta, b, r = _inputs(960, bias, residual, shape=(2, 4, 3))
    out, mean, rstd = cnk._kernel_forward(x, gamma, beta, b, r, relu, 1e-3, stats=True)
    assert out.shape == x.shape and mean.shape == rstd.shape == (2, 4, 3, 1)
    (device, xp, gp, bp, biasp, resp, outp, meanp, rstdp, rows, c, rl, f64, factor,
     eps), = stubbed_launch
    assert (device, xp, gp, bp, outp) == (x.device, x.data_ptr(), gamma.data_ptr(),
                                          beta.data_ptr(), out.data_ptr())
    assert (biasp is None) == (not bias) and (resp is None) == (not residual)
    assert (meanp, rstdp) == (mean.data_ptr(), rstd.data_ptr())
    assert (rows, c, rl, f64) == (24, 960, int(relu), 0) and eps == pytest.approx(1e-3)
    assert factor == float(np.float32(1) / np.float32(960))
    _, mean, rstd = cnk._kernel_forward(x, gamma, beta, b, r, relu, 1e-3, stats=False)
    assert mean is None and rstd is None and stubbed_launch[-1][7:9] == (None, None)


def test_card_route_takes_float64_whole(stubbed_launch):
    """Every tensor float64 (HiFiC's float64 checks on the card): one
    launch flagged float64, the mean's factor 1 / C in float64, the
    statistics in float64."""
    x, gamma, beta, b, r = _inputs(220, True, True, dtype=torch.float64, shape=(3, 5))
    out, mean, rstd = cnk._kernel_forward(x, gamma, beta, b, r, True, 1e-3, stats=True)
    assert out.dtype == mean.dtype == rstd.dtype == torch.float64
    (launch,) = stubbed_launch
    assert launch[9:13] == (15, 220, 1, 1) and launch[13] == 15.0 / (15 * 220)


def test_card_route_launches_nothing_for_no_rows(stubbed_launch):
    x, gamma, beta, _, _ = _inputs(60, False, False, shape=(0, 4))
    out, _, _ = cnk._kernel_forward(x, gamma, beta, None, None, False, 1e-3, stats=False)
    assert out.shape == (0, 4, 60) and stubbed_launch == []


def _refused():
    x, gamma, beta, b, r = _inputs(240, True, True, shape=(4, 6))
    r_strided = r.transpose(0, 1).contiguous().transpose(0, 1)
    return {
        "float64_x": ((x.double(), gamma, beta, b, r), TypeError),
        "float64_gamma": ((x, gamma.double(), beta, b, r), TypeError),
        "float16_residual": ((x, gamma, beta, b, r.half()), TypeError),
        "float16_all": ((x.half(), gamma.half(), beta.half(), b.half(), r.half()), TypeError),
        "bfloat16_all": ((x.bfloat16(), gamma.bfloat16(), beta.bfloat16(), b.bfloat16(),
                          r.bfloat16()), TypeError),
        "transposed_x": ((x.transpose(0, 1), gamma, beta, b, r.transpose(0, 1)), ValueError),
        "strided_rows": ((x[..., ::2], gamma[::2], beta[::2], b[::2], r[..., ::2]), ValueError),
        "transposed_residual": ((x, gamma, beta, b, r_strided), ValueError),
        "gamma_of_another_width": ((x, gamma[:-4], beta, b, r), ValueError),
        "bias_of_another_width": ((x, gamma, beta, b[:-4], r), ValueError),
        "residual_of_another_shape": ((x, gamma, beta, b, r[:2]), ValueError),
        "no_channels": ((x[..., :0], gamma[:0], beta[:0], b[:0], r[..., :0]), ValueError),
    }


@pytest.mark.parametrize("case", sorted(_refused()))
def test_card_route_refuses_what_the_kernel_cannot_take(stubbed_launch, case):
    args, error = _refused()[case]
    with pytest.raises(error):
        cnk._kernel_forward(*args, False, 1e-3, stats=False)
    assert stubbed_launch == []


def test_other_devices_are_refused():
    x, gamma, beta, _, _ = _inputs(60, False, False)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_channel_norm(x.to("meta"), gamma.to("meta"), beta.to("meta"))


def _count_norm_calls(monkeypatch):
    calls = []

    def spy(x, gamma, beta, bias=None, residual=None, relu=False, eps=1e-3):
        calls.append((x.shape[-1], bias is not None, relu, residual is not None, x.dtype))
        return fused_channel_norm(x, gamma, beta, bias, residual, relu, eps)

    monkeypatch.setattr(archs, "fused_channel_norm", spy)
    return calls


def test_networks_hand_the_norm_its_bias_relu_and_residual(monkeypatch):
    """The encoder's 5 norms take their convolution's bias and the ReLU;
    the generator's ``norm_in`` nothing, ``norm_head`` its bias, each
    block's ``norm0`` bias and ReLU and ``norm1`` bias and the residual,
    the up-path's norms bias and ReLU (5 + 2 + 2 a block + 4 calls)."""
    calls = _count_norm_calls(monkeypatch)
    gen = torch.Generator().manual_seed(0)
    enc, g = archs.Encoder(8, gen), archs.Generator(8, 2, gen)
    with torch.no_grad():
        enc(torch.rand(1, 32, 32, 3))
        assert calls == [(c, True, True, False, torch.float32) for c in (60, 120, 240, 480, 960)]
        calls.clear()
        g(torch.randn(1, 2, 2, 8))
    assert [call[:4] for call in calls] == (
        [(8, False, False, False), (960, True, False, False)]
        + [(960, True, True, False), (960, True, False, True)] * 2
        + [(c, True, True, False) for c in (480, 240, 120, 60)])


def test_float64_networks_take_the_twin(monkeypatch):
    """A float64 model (the card's float64 checks) calls the wrapper as a
    float32 one does: the twin on the CPU, with gradients in float64 (on the
    card the kernel's general path)."""
    calls = _count_norm_calls(monkeypatch)
    monkeypatch.setattr(cnk, "_launch", lambda *a: pytest.fail("a CPU tensor launched"))
    enc = archs.Encoder(8, torch.Generator().manual_seed(0)).double()
    x = torch.rand(1, 32, 32, 3, dtype=torch.float64, requires_grad=True)
    enc(x).sum().backward()
    assert calls == [(c, True, True, False, torch.float64) for c in (60, 120, 240, 480, 960)]
    assert x.grad.dtype == torch.float64


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_module_hands_the_kernel_rows_as_they_are(monkeypatch, stubbed_launch, dtype):
    """ChannelNorm copies nothing: on the card's route (here CPU tensors sent
    there, the launch stubbed) contiguous rows launch once and rows that are
    not contiguous, x's or the residual's, raise."""
    monkeypatch.setattr(cnk, "_forward", cnk._kernel_forward)
    norm = archs.ChannelNorm(60).to(dtype)
    x, _, _, b, r = _inputs(60, True, True, dtype=dtype, shape=(4, 6))
    with torch.no_grad():
        norm(x, bias=b, residual=r)
        assert len(stubbed_launch) == 1
        with pytest.raises(ValueError, match="contiguous"):
            norm(x.transpose(0, 1), bias=b, residual=r.transpose(0, 1))
        with pytest.raises(ValueError, match="contiguous"):
            norm(x, bias=b, residual=r.transpose(0, 1).contiguous().transpose(0, 1))
    assert len(stubbed_launch) == 1


def _aten_row_sum(e):
    """ATen's float32 sum of one contiguous row on the card (Reduce.cuh at
    16 rows or more): 32 lanes; from 128 channels lane m sums float4 slots
    m, m + 32, ... each component on its own, then ((x + y) + z) + w; below,
    elements m, m + 32, ... in order; then shuffles at offsets 16 ... 1."""
    f, c = np.float32, len(e)
    p = []
    for m in range(32):
        if c >= 128:
            acc = [f(0)] * 4
            for s in range(m, c // 4, 32):
                acc = [acc[k] + e[4 * s + k] for k in range(4)]
            p.append(((acc[0] + acc[1]) + acc[2]) + acc[3])
        else:
            acc = f(0)
            for i in range(m, c, 32):
                acc = acc + e[i]
            p.append(acc)
    for off in (16, 8, 4, 2, 1):
        p = [p[m] + p[m + off] if m < off else p[m] for m in range(32)]
    return p[0]


def _kernel_row_sum(e):
    """``csrc/channel_norm.cu``'s ``row_sum`` on one row: from 128 channels
    lane m of 32 holds float4 slots m + 32 j, below lane q of 8 holds slots
    q + 8 j; each lane sums its slots by component, then the lanes' shuffle
    tree (XOR), as the kernel does."""
    f, c = np.float32, len(e)
    lanes = 32 if c >= 128 else 8
    a = [[f(0)] * 4 for _ in range(lanes)]
    for q in range(lanes):
        for s in range(q, c // 4, lanes):
            a[q] = [a[q][k] + e[4 * s + k] for k in range(4)]
    if lanes == 32:
        p = [((x + y) + z) + w for x, y, z, w in a]
        for off in (16, 8, 4, 2, 1):
            p = [p[m] + p[m ^ off] for m in range(32)]
        return p[0]
    for off in (4, 2, 1):
        a = [[a[q][k] + a[q ^ off][k] for k in range(4)] for q in range(8)]
    x, y, z, w = a[0]
    return (x + z) + (y + w)


@pytest.mark.parametrize("c", WIDTHS[:-1])
def test_kernel_sums_in_atens_order(c):
    """The kernel's layout and shuffle tree give each row the bits of
    torch.mean's sum on the card, so its norm rounds as the twin's there
    (checked on the card by ``-k channel_norm``); a plain lane order does
    not."""
    rng = np.random.RandomState(c)
    rows = (rng.randn(20, c) * 5 + 3).astype(np.float32)
    for e in rows:
        assert _aten_row_sum(e).tobytes() == _kernel_row_sum(e).tobytes()
    plain = [np.float32(sum(np.float32(v) for v in e)) for e in rows]  # one lane, in order
    assert any(p.tobytes() != _aten_row_sum(e).tobytes() for p, e in zip(plain, rows))
