"""Tests of the port that need the card: the CUDA kernels (K1 fused GDN at
any width up to 192, the general GDN kernel at any width and dtype, K3/K2
rANS encode/decode, HiFiC's ChannelNorm and 3x3 convolution) against their
plain twins, K1 and the general kernel
under autograd, the single-program decode's CUDA graphs and their launch
counts, the codecs on the card (bmshj2018 with either coder,
bls2017 in both archs, mbt2018 with either coder, b2018 at 192 filters,
ms2020 and HiFiC at full width with either coder), the tfci CLI against
the Codec API, training steps (HiFiC's joint G/D step among them), and the
rest of the library (universal and power-law models, the soft-round and
mixture priors and the log-CDF tails, SignalConv1D/3D with reflect,
separable and RDFT kernels, the CDF quantizer on the card, the toy sources,
tracing), and the multi-device layer on 4 shards of one card (a
data-parallel step, a SpatialCodec, the image-parallel CHARM decode),
against the CPU path. They skip without a GPU. This file imports neither JAX nor the JAX package, so on a machine
without JAX run it alone, without the suite's conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import itertools
import pathlib

import numpy as np
import pytest
import torch

from compression_tpu_torch import convert
from compression_tpu_torch.codec import pmf_to_quantized_cdf, rans, rans_ref
from compression_tpu_torch.entropy_models.continuous_base import CdfTables
from compression_tpu_torch.layers import (fused_gdn, fused_gdn_general, fused_gdn_reference,
                                          parameters)
from compression_tpu_torch.layers import channel_norm_kernel
from compression_tpu_torch.layers.channel_norm_kernel import (fused_channel_norm,
                                                           fused_channel_norm_reference)
from compression_tpu_torch.layers.conv3x3_kernel import conv3x3, conv3x3_reference
from compression_tpu_torch.layers.gdn_kernel import FusedGDN
from compression_tpu_torch.entropy_models import continuous_batched, continuous_indexed
from compression_tpu_torch.models import (b2018, bls2017, bmshj2018, common, hific, mbt2018,
                                          ms2020)
from compression_tpu_torch.models.device_coding import num_fields, rans_for
from compression_tpu_torch.models.hific import lpips as hific_lpips
from compression_tpu_torch.util import PackedTensors
from compression_tpu_torch.util.image import pad_to_multiple_np

TOL = dict(rtol=2e-5, atol=2e-5)  # the TPU kernel's tolerance
CKPT = pathlib.Path(__file__).resolve().parent.parent / "ckpt" / "bmshj2018.msgpack"

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from compression_tpu_torch.util.device import strict_fp32

    strict_fp32()
    return torch.device("cuda")


def _inputs(seed, rows, c, device, wide=False):
    """x normal, or (wide) of magnitude spread log-uniformly over 1e-3..1e3
    with random signs; beta and gamma positive, gamma diagonal-heavy."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, c, generator=gen)
    if wide:
        x = torch.sign(x) * 10.0 ** (torch.rand(rows, c, generator=gen) * 6 - 3)
    beta = torch.rand(c, generator=gen) * 1.5 + 0.5
    gamma = torch.rand(c, c, generator=gen) * 0.1 + 0.05 * torch.eye(c)
    return [t.to(device) for t in (x, beta, gamma)]


@pytest.mark.parametrize("c", [32, 64, 128, 192])
@pytest.mark.parametrize("rows", [1, 63, 4551, 200_000])
@pytest.mark.parametrize("inverse", [False, True])
def test_kernel_matches_twin(cuda, c, rows, inverse):
    x, beta, gamma = _inputs(c + rows, rows, c, cuda)
    before = fused_gdn.launches
    with torch.inference_mode():
        got = fused_gdn(x, beta, gamma, inverse)
        torch.cuda.synchronize()
        want = fused_gdn_reference(x, beta, gamma, inverse)
    assert fused_gdn.launches == before + 1
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("inverse", [False, True])
def test_kernel_matches_twin_on_wide_range_input(cuda, inverse):
    x, beta, gamma = _inputs(9, 256 * 384, 192, cuda, wide=True)
    with torch.inference_mode():
        got = fused_gdn(x, beta, gamma, inverse)
        want = fused_gdn_reference(x, beta, gamma, inverse)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("layer", ["analysis/gdn0", "analysis/gdn1", "analysis/gdn2",
                                   "synthesis/igdn0", "synthesis/igdn1", "synthesis/igdn2"])
@pytest.mark.parametrize("wide", [False, True])
def test_kernel_matches_twin_on_checkpoint_params(cuda, layer, wide):
    transform, name = layer.split("/")
    raw = convert.load_flax_msgpack(CKPT)["params"]["params"][transform][name]
    beta = parameters.nonneg_apply(torch.from_numpy(np.asarray(raw["beta"])), 1e-6)
    gamma = parameters.nonneg_apply(torch.from_numpy(np.asarray(raw["gamma"])), 0.0)
    x = _inputs(len(layer), 4551, 192, "cpu", wide=wide)[0]
    x, beta, gamma = x.to(cuda), beta.to(cuda), gamma.to(cuda)
    inverse = name.startswith("i")
    with torch.inference_mode():
        got = fused_gdn(x, beta, gamma, inverse)
        want = fused_gdn_reference(x, beta, gamma, inverse)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("inverse", [False, True])
def test_kernel_rows_do_not_depend_on_their_tile(cuda, inverse):
    """A row's result is the same, bit for bit, whichever tile and place in a
    tile it lands on (batch-1 and batch-8 decodes rely on it)."""
    x, beta, gamma = _inputs(4, 200_000, 192, cuda)
    with torch.inference_mode():
        full = fused_gdn(x, beta, gamma, inverse)
        for lo, hi in ((0, 64), (64 * 777, 64 * 778), (1000, 1100), (199_937, 200_000)):
            alone = fused_gdn(x[lo:hi].contiguous(), beta, gamma, inverse)
            assert torch.equal(alone, full[lo:hi]), (lo, hi)


@pytest.mark.parametrize("c", [8, 16, 40])
@pytest.mark.parametrize("rows", [1, 4551, 200_000])
@pytest.mark.parametrize("inverse", [False, True])
def test_kernel_at_any_width_matches_twin(cuda, c, rows, inverse):
    """C not a multiple of 32 goes through one K1 launch at the padded
    width and comes back at C, contiguous, within the kernel tolerance."""
    x, beta, gamma = _inputs(c * 7 + rows, rows, c, cuda)
    x = x.reshape(rows, 1, c)
    before = fused_gdn.launches
    with torch.inference_mode():
        got = fused_gdn(x, beta, gamma, inverse)
        torch.cuda.synchronize()
        want = fused_gdn_reference(x, beta, gamma, inverse)
    assert fused_gdn.launches == before + 1
    assert got.shape == x.shape and got.is_contiguous()
    torch.testing.assert_close(got, want, **TOL)


def test_kernel_takes_leading_dims(cuda):
    x, beta, gamma = _inputs(1, 2 * 7 * 9, 192, cuda)
    x4 = x.reshape(2, 7, 9, 192)
    with torch.inference_mode():
        got = fused_gdn(x4, beta, gamma)
        want = fused_gdn_reference(x4, beta, gamma)
    assert got.shape == x4.shape
    torch.testing.assert_close(got, want, **TOL)


def test_kernel_rejects_what_it_cannot_take(cuda):
    x, beta, gamma = _inputs(2, 64, 192, cuda)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="contiguous"):
            fused_gdn(x.t(), beta, gamma[:64, :64].contiguous())
        with pytest.raises(TypeError, match="float32"):
            fused_gdn(x.double(), beta, gamma)
        x224, b224, g224 = _inputs(3, 64, 224, cuda)
        with pytest.raises(ValueError, match="unsupported"):
            fused_gdn(x224, b224, g224)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_gdn(x.requires_grad_(), beta, gamma)


def test_codec_on_card_round_trip_matches_cpu(cuda):
    torch.manual_seed(0)
    cfg = bmshj2018.Config(num_filters=32, num_latents=32, num_hyperlatents=32)
    cpu_model = bmshj2018.BMSHJ2018Model(cfg)
    gpu_model = bmshj2018.BMSHJ2018Model(cfg)
    gpu_model.load_state_dict(cpu_model.state_dict())
    cpu = bmshj2018.Codec(cpu_model, device="cpu")
    gpu = bmshj2018.Codec(gpu_model, device=cuda,
                          tables={"side": cpu.side_em.tables, "main": cpu.em.tables})
    rng = np.random.RandomState(0)
    images = (rng.rand(3, 96, 130, 3) * 255).astype(np.uint8)
    before = fused_gdn.launches
    blobs = gpu.compress_batch(images)
    out = gpu.decompress_batch(blobs)
    assert fused_gdn.launches == before + 6
    assert out.shape == images.shape and out.dtype == np.uint8
    assert gpu.compress_batch(images) == blobs
    np.testing.assert_array_equal(gpu.decompress(blobs[2]), out[2])
    iter_out = np.concatenate(list(gpu.decompress_iter(gpu.compress_iter([images[:1], images[1:]]))))
    np.testing.assert_array_equal(iter_out, out)
    # The CPU codec's own round trip lands within one level.
    cpu_out = cpu.decompress_batch(cpu.compress_batch(images))
    assert np.abs(cpu_out.astype(np.int16) - out.astype(np.int16)).max() <= 1


# -- fused_gdn_general: GDN at any width and dtype ------------------------------

# Significand bits of each storage type: two ulps of the twin's output
# bound a low-precision result (both accumulate the norm in float32 and
# round once, in another order).
_BITS = {torch.bfloat16: 8, torch.float16: 11}


def _assert_general_close(got, want):
    if want.dtype == torch.float32:
        torch.testing.assert_close(got, want, **TOL)
    elif want.dtype == torch.float64:
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    else:
        # An ulp of the output type; below its smallest normal, the
        # subnormal spacing.
        g, w = got.double(), want.double()
        ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(torch.finfo(want.dtype).tiny)))
                         - (_BITS[want.dtype] - 1))
        assert ((g - w).abs() / ulp).max().item() <= 2


# Widths past every tile edge of the kernel (mma tiles of 8 and 16, chunks
# of 16 and 32 input channels, slices of 128 output channels), on 4551 rows,
# a multiple of no row tile.
@pytest.mark.parametrize("c", [224, 256, 320, 1, 33, 193, 2, 4, 31, 64, 255, 512, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("inverse", [False, True])
def test_general_kernel_matches_twin(cuda, c, dtype, inverse):
    x, beta, gamma = (t.to(dtype) for t in _inputs(c * 3 + inverse, 4551, c, cuda))
    before = fused_gdn_general.launches
    with torch.inference_mode():
        got = fused_gdn_general(x, beta, gamma, inverse)
        torch.cuda.synchronize()
        want = fused_gdn_reference(x, beta, gamma, inverse)
    assert fused_gdn_general.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    _assert_general_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("inverse", [False, True])
def test_general_kernel_rows_do_not_depend_on_their_tile(cuda, dtype, inverse):
    x, beta, gamma = (t.to(dtype) for t in _inputs(6, 70_000, 320, cuda))
    with torch.inference_mode():
        full = fused_gdn_general(x, beta, gamma, inverse)
        for lo, hi in ((0, 1), (31, 97), (69_990, 70_000)):
            alone = fused_gdn_general(x[lo:hi].contiguous(), beta, gamma, inverse)
            assert torch.equal(alone, full[lo:hi]), (lo, hi)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.float16])
def test_general_kernel_replays_in_a_cuda_graph(cuda, dtype):
    """Captured in a CUDA graph (``util.graphs.Segment``, as the jit decode
    captures it), the kernel replays to the bytes of an eager call, and each
    replay counts its one launch."""
    from compression_tpu_torch.util.graphs import Segment

    x, beta, gamma = (t.to(dtype) for t in _inputs(7, 4551, 320, cuda))
    stream = torch.cuda.Stream()
    segment = Segment(lambda v: fused_gdn_general(v, beta, gamma), [x], stream=stream)
    with torch.no_grad():
        eager = fused_gdn_general(x, beta, gamma)
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            segment(x)  # warm-up, capture, first replay
            before = fused_gdn_general.launches
            replayed = segment(x)
        torch.cuda.synchronize()
    assert segment.replay_launches == {fused_gdn_general: 1}
    assert fused_gdn_general.launches == before + 1
    assert torch.equal(replayed, eager)


def test_general_kernel_rejects_what_it_cannot_take(cuda):
    x, beta, gamma = _inputs(2, 64, 256, cuda)
    with torch.inference_mode():
        with pytest.raises(TypeError, match="beta is torch.float64"):
            fused_gdn_general(x, beta.double(), gamma)
        with pytest.raises(ValueError, match="contiguous"):
            fused_gdn_general(x, beta, gamma.t())
    with pytest.raises(RuntimeError, match="no backward"):
        fused_gdn_general(x.requires_grad_(), beta, gamma)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_layer_at_256_on_card_matches_cpu(cuda, dtype, inverse):
    """The GDN layer at C = 256 (the general kernel's route) under autograd:
    output and the gradients of x and the raw parameters on the card
    against the CPU's, from the same weights and inputs."""
    from compression_tpu_torch.layers import GDN

    gen = torch.Generator().manual_seed(256 + inverse)
    x = torch.randn(2, 24, 16, 256, generator=gen)
    w = torch.randn(2, 24, 16, 256, generator=gen)
    results = []
    for device in ("cpu", cuda):
        layer = GDN(256, inverse=inverse, dtype=None if dtype == torch.float32 else dtype)
        with torch.no_grad():
            layer.gamma.add_(0.02 * torch.rand(256, 256, generator=torch.Generator().manual_seed(1)))
        layer.to(device)
        xd = x.to(device, dtype).clone().requires_grad_()
        before = fused_gdn_general.launches, fused_gdn.launches
        y = layer(xd)
        torch.sum(y * w.to(device, dtype)).backward()
        if device != "cpu":
            assert (fused_gdn_general.launches, fused_gdn.launches) == (before[0] + 1, before[1])
        results.append([t.detach().cpu() for t in (y, xd.grad, layer.beta.grad, layer.gamma.grad)])
    tol = TOL if dtype == torch.float32 else dict(rtol=1e-12, atol=1e-12)
    for got, want in zip(results[1], results[0]):
        torch.testing.assert_close(got, want, rtol=tol["rtol"],
                                   atol=tol["atol"] * want.abs().max().item())


def _tiny_bmshj2018(cuda):
    torch.manual_seed(0)
    cfg = bmshj2018.Config(num_filters=32, num_latents=32, num_hyperlatents=32)
    cpu_model = bmshj2018.BMSHJ2018Model(cfg)
    gpu_model = bmshj2018.BMSHJ2018Model(cfg)
    gpu_model.load_state_dict(cpu_model.state_dict())
    return bmshj2018.Codec(gpu_model, device=cuda)


def test_jit_decode_on_card_matches_decompress_batch(cuda):
    codec = _tiny_bmshj2018(cuda)
    rng = np.random.RandomState(1)
    images = (rng.rand(3, 96, 130, 3) * 255).astype(np.uint8)
    blobs = codec.compress_batch(images)
    want = codec.decompress_batch(blobs)
    for _ in range(2):
        np.testing.assert_array_equal(codec.decompress_batch_jit(blobs), want)
    assert len(codec._jit_decoders) == 1
    program = next(iter(codec._jit_decoders.values()))
    assert program.rows.graph is not None and program.synth.graph is not None
    np.testing.assert_array_equal(codec.decompress_batch_jit(blobs[1:2])[0], want[1])
    other = (rng.rand(1, 64, 64, 3) * 255).astype(np.uint8)
    blob = codec.compress_batch(other)
    np.testing.assert_array_equal(codec.decompress_batch_jit(blob), codec.decompress_batch(blob))
    assert len(codec._jit_decoders) == 3
    device_blobs = codec.compress_batch(images, coder="device")
    before = rans.rans_decode.launches
    np.testing.assert_array_equal(codec.decompress_batch_jit(device_blobs),
                                  codec.decompress_batch(device_blobs))
    assert rans.rans_decode.launches == before + 2


def test_jit_decode_counts_kernel_launches_on_every_replay(cuda):
    """A warm jit decode replays two CUDA graphs: the synthesis' three IGDN
    launch K1 three times, and the counts say so on every replay; a cold
    call counts its eager warm-up and its first replay, not the capture."""
    codec = _tiny_bmshj2018(cuda)
    blobs = codec.compress_batch((np.random.RandomState(2).rand(2, 64, 96, 3) * 255)
                                 .astype(np.uint8))
    before = fused_gdn.launches
    codec.decompress_batch_jit(blobs)  # warm-up (3) + replay (3)
    assert fused_gdn.launches == before + 6
    program = next(iter(codec._jit_decoders.values()))
    assert program.synth.replay_launches == {fused_gdn: 3}
    assert program.rows.replay_launches == {}
    for _ in range(3):
        before = fused_gdn.launches, fused_gdn_general.launches
        codec.decompress_batch_jit(blobs)
        assert (fused_gdn.launches, fused_gdn_general.launches) == (before[0] + 3, before[1])
    # The card's own trace of a warm call shows the kernels the counts say.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    before = fused_gdn.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        codec.decompress_batch_jit(blobs)
        torch.cuda.synchronize()
    names = [k.name() for k in prof.profiler.kineto_results.events()
             if k.device_type() == DeviceType.CUDA]
    k1 = sum("gdn_kernel" in n and "gdn_general_kernel" not in n for n in names)
    assert k1 == fused_gdn.launches - before == 3
    assert not any("gdn_general_kernel" in n for n in names)


# -- K3 / K2: the rANS kernels -------------------------------------------------


def _rans_tables(rng, R=6, P=12, max_syms=40):
    """Random quantized CDF rows (escape last); row 0 is the degenerate
    full-mass row (one symbol owns all 2^P slots)."""
    rows, lengths = [], []
    for _ in range(R):
        n = rng.randint(2, max_syms)
        rows.append(pmf_to_quantized_cdf(rng.rand(n) ** 2 + 1e-3, [n], P)[0])
        lengths.append(n + 1)
    rows[0], lengths[0] = np.array([0, 1 << P, 1 << P]), 3
    cdf = np.zeros((R, max(len(c) for c in rows)), np.int32)
    for r, c in enumerate(rows):
        cdf[r, : len(c)] = c
    return CdfTables(cdf=cdf, cdf_length=np.array(lengths, np.int32),
                     cdf_offset=rng.randint(-20, 20, R).astype(np.int32),
                     offset=np.zeros(R), precision=P)


def _rans_elements(rng, tables, B, N, escape_frac=0.25):
    """int32 values (25% escapes; row 0 only its one symbol) and uint8
    rows. Image B-1 of a batch starts with two escapes at the int32 limits,
    where the payload arithmetic wraps (the NumPy spec, in int64, does not;
    the spec is compared on image 0 only)."""
    rows = rng.randint(0, tables.num_cdfs, (B, N))
    lo = tables.cdf_offset[rows].astype(np.int64)
    n_sym = np.maximum(tables.cdf_length[rows] - 2, 1)
    wide = rng.randint(-5000, 5000, (B, N)).astype(np.int64)
    vals = np.where(rng.rand(B, N) < 1 - escape_frac,
                    lo + (rng.rand(B, N) * n_sym).astype(np.int64), wide)
    vals = np.where(rows == 0, lo, vals)
    if B > 1 and N > 1:
        rows[-1, :2] = tables.num_cdfs - 1
        vals[-1, :2] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max]
    return torch.from_numpy(vals.astype(np.int32)), torch.from_numpy(rows.astype(np.uint8))


@pytest.mark.parametrize("K", [4, 16, 128])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("N", [1, 1000, 4099])
def test_rans_kernels_match_twins_and_spec(cuda, K, B, N):
    rng = np.random.RandomState(K + B + N)
    tables = _rans_tables(rng)
    t = rans.RansTables(tables)
    vals, rows = _rans_elements(rng, tables, B, N)
    cap = 3 * N + 2 * K + 64
    before = (rans.rans_encode.launches, rans.rans_decode.launches)
    got = rans.rans_encode(t, vals.to(cuda), rows.to(cuda), K, cap)
    torch.cuda.synchronize()
    assert rans.rans_encode.launches == before[0] + 2  # the fields, then the lanes
    want = rans.rans_encode_reference(t, vals, rows, K, cap)
    for g, w in zip(got, want):  # words, lengths, overflow: identical
        assert torch.equal(g.cpu(), w)
    stream, lengths = got[0].cpu().numpy(), got[1].cpu().numpy()
    assert stream[0, : lengths[0]].tobytes() == rans_ref.rans_encode(
        vals[0].numpy(), rows[0].numpy(), tables, K)
    for r in (rows, rows.int()):
        out, ok = rans.rans_decode(t, got[0], r.to(cuda), K, N)
        torch.cuda.synchronize()
        assert ok.all() and torch.equal(out.cpu(), vals)
    assert rans.rans_decode.launches == before[1] + 2


def test_rans_overflow_and_corrupt_streams_match_twins(cuda):
    rng = np.random.RandomState(1)
    tables = _rans_tables(rng)
    t = rans.RansTables(tables)
    N, K = 3000, 16
    vals, rows = _rans_elements(rng, tables, 8, N)
    for cap in (1, 2 * K, 1500):  # too small: the kept tail, lengths, flags
        got = rans.rans_encode(t, vals.to(cuda), rows.to(cuda), K, cap)
        want = rans.rans_encode_reference(t, vals, rows, K, cap)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
        assert got[2].all()
    stream, lengths, _ = rans.rans_encode_reference(t, vals, rows, K, 3 * N + 2 * K + 64)
    bad = stream.clone()
    for b in range(8):  # a different corruption per image
        pos = [0, 2 * K - 1, 2 * K + 5, int(lengths[b]) // 2, int(lengths[b]) - 1, 7][b % 6]
        bad[b, pos] ^= 0x5A5A
    for s in (bad, stream[:, : int(lengths.min()) // 2].contiguous()):
        out, ok = rans.rans_decode(t, s.to(cuda), rows.to(cuda), K, N)
        want_out, want_ok = rans.rans_decode_reference(t, s, rows, K, N)
        assert torch.equal(ok.cpu(), want_ok) and torch.equal(out.cpu(), want_out)
        assert not want_ok.all()


def _rans_round_trip(t, tables, vals, rows, K, cuda, variant):
    """K3 then K2 on the card against the twins; the launches counted for
    the variant."""
    N = vals.shape[1]
    cap = 3 * N + 2 * K + 64
    got = rans.rans_encode(t, vals.to(cuda), rows.to(cuda), K, cap)
    want = rans.rans_encode_reference(t, vals, rows, K, cap)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    before = dict(rans.rans_decode.variant_launches)
    out, ok = rans.rans_decode(t, got[0], rows.to(cuda), K, N)
    torch.cuda.synchronize()
    assert ok.all() and torch.equal(out.cpu(), vals)
    assert rans.rans_decode.variant_launches[variant] == before[variant] + 1
    return want


@pytest.mark.parametrize("R,max_syms", [(48, 300), (64, 2000)])
def test_rans_global_variants_match_twins(cuda, R, max_syms):
    """Tables over the shared-memory budget (precision 15: 2,048 buckets a
    row; and 64 rows of up to 2,000 symbols) take K2's variant that reads
    them through L1."""
    rng = np.random.RandomState(R)
    tables = _rans_tables(rng, R=R, P=15, max_syms=max_syms)
    t = rans.RansTables(tables)
    assert rans.decode_variant(t) == "global"
    vals, rows = _rans_elements(rng, tables, 4, 5000)
    stream, lengths, _ = _rans_round_trip(t, tables, vals, rows, 128, cuda, "global")
    bad = stream.clone()
    bad[1, int(lengths[1]) // 3] ^= 0x1234
    out, ok = rans.rans_decode(t, bad.to(cuda), rows.to(cuda), 128, 5000)
    want_out, want_ok = rans.rans_decode_reference(t, bad, rows, 128, 5000)
    assert torch.equal(ok.cpu(), want_ok) and torch.equal(out.cpu(), want_out)


@pytest.mark.parametrize("K", [1, 4, 33, 48, 200, 1024])
@pytest.mark.parametrize("N", [1, 48, 3001])
def test_rans_kernels_at_odd_lanes_and_one_step(cuda, K, N):
    """K not a multiple of 32 (and 1024, 32 lanes a thread in K2), T = 1
    (N <= K) and ragged T."""
    rng = np.random.RandomState(K * 7 + N)
    tables = _rans_tables(rng)
    vals, rows = _rans_elements(rng, tables, 3, N)
    _rans_round_trip(rans.RansTables(tables), tables, vals, rows, K, cuda, "on_chip")


def test_rans_decode_ring_refills_and_reads_past_cap(cuda):
    """Streams far longer than K2's 8,192-word ring (25% escapes: three
    words an escaped element), then the same streams corrupt and truncated
    so the reads run past cap and clip at cap - 1."""
    rng = np.random.RandomState(8)
    tables = _rans_tables(rng)
    t = rans.RansTables(tables)
    N, K = 60_000, 16
    vals, rows = _rans_elements(rng, tables, 4, N, escape_frac=0.5)
    stream, lengths, _ = _rans_round_trip(t, tables, vals, rows, K, cuda, "on_chip")
    assert int(lengths.min()) > 4 * 8192
    bad = stream.clone()
    for b in range(4):
        bad[b, [2 * K + 3, 9000, 20_000, int(lengths[b]) - 2][b]] ^= 0x00FF
    for s in (bad, stream[:, : 9000].contiguous(), stream[:, : 2 * K + 1].contiguous()):
        out, ok = rans.rans_decode(t, s.to(cuda), rows.to(cuda), K, N)
        want_out, want_ok = rans.rans_decode_reference(t, s, rows, K, N)
        assert torch.equal(ok.cpu(), want_ok) and torch.equal(out.cpu(), want_out)
        assert not want_ok.all()


def test_rans_main_path_tables_decode_on_chip(cuda):
    """The codec's y tables (64 rows at precision 12) fit in shared memory:
    the main path's decode runs the on-chip variant."""
    from compression_tpu_torch.distributions import NoisyNormal
    from compression_tpu_torch.entropy_models import LocationScaleIndexedEntropyModel

    tables = LocationScaleIndexedEntropyModel(NoisyNormal, coding_rank=3)._em.build_tables()
    t = rans.RansTables(tables)
    assert rans.decode_variant(t) == "on_chip"
    rng = np.random.RandomState(9)
    vals, rows = _rans_elements(rng, tables, 2, 40_000, escape_frac=0.02)
    _rans_round_trip(t, tables, vals, rows, 128, cuda, "on_chip")


def test_rans_kernels_reject_what_they_cannot_take(cuda):
    tables = _rans_tables(np.random.RandomState(2))
    t = rans.RansTables(tables)
    vals, rows = _rans_elements(np.random.RandomState(3), tables, 2, 100)
    vals, rows = vals.to(cuda), rows.to(cuda)
    with pytest.raises(TypeError, match="int32"):
        rans.rans_encode(t, vals.long(), rows, 8, 400)
    with pytest.raises(TypeError, match="uint8 or int32"):
        rans.rans_encode(t, vals, rows.long(), 8, 400)
    with pytest.raises(ValueError, match="lanes unsupported"):
        rans.rans_encode(t, vals, rows, 2048, 400)
    stream = torch.zeros(2, 10, dtype=torch.uint16, device=cuda)
    with pytest.raises(ValueError, match="cannot hold"):
        rans.rans_decode(t, stream, rows, 8, 100)
    with pytest.raises(TypeError, match="uint16"):
        rans.rans_decode(t, stream.int(), rows, 2, 100)
    bad = _rans_tables(np.random.RandomState(2))
    bad.cdf[1, int(bad.cdf_length[1]) - 1] -= 1  # the row no longer reaches 2^P
    with pytest.raises(ValueError, match="well-formed"):
        rans.rans_encode(rans.RansTables(bad), vals, rows, 8, 400)


def test_codec_device_coder_on_card(cuda):
    torch.manual_seed(1)
    cfg = bmshj2018.Config(num_filters=32, num_latents=32, num_hyperlatents=32)
    cpu_model = bmshj2018.BMSHJ2018Model(cfg)
    gpu_model = bmshj2018.BMSHJ2018Model(cfg)
    gpu_model.load_state_dict(cpu_model.state_dict())
    cpu = bmshj2018.Codec(cpu_model, device="cpu")
    gpu = bmshj2018.Codec(gpu_model, device=cuda,
                          tables={"side": cpu.side_em.tables, "main": cpu.em.tables})
    rng = np.random.RandomState(1)
    images = (rng.rand(3, 96, 130, 3) * 255).astype(np.uint8)
    before = (rans.rans_encode.launches, rans.rans_decode.launches, fused_gdn.launches)
    blobs = gpu.compress_batch(images, coder="device")
    out = gpu.decompress_batch(blobs)
    assert (rans.rans_encode.launches, rans.rans_decode.launches,
            fused_gdn.launches) == (before[0] + 2, before[1] + 1, before[2] + 6)
    fields = [PackedTensors(b).unpack([object, object, np.int32, np.int32, np.int32])
              for b in blobs]
    assert {int(f[4][0]) for f in fields} == {128}
    # Bit-equal to the host-coded decode on the card, deterministic,
    # batch-1 equal to the batch decode, and through the iterators.
    np.testing.assert_array_equal(out, gpu.decompress_batch(gpu.compress_batch(images)))
    assert gpu.compress_batch(images, coder="device") == blobs
    np.testing.assert_array_equal(gpu.decompress(blobs[2]), out[2])
    piped = list(gpu.compress_iter([images[:1], images[1:]], coder="device"))
    assert piped[0] + piped[1] == blobs
    np.testing.assert_array_equal(np.concatenate(list(gpu.decompress_iter(piped))), out)
    # The card's y words are what the CPU codec's coder (the twin) writes
    # for the card's symbols and rows, with the same (pinned) tables.
    x = torch.from_numpy(pad_to_multiple_np(images, cfg.downscale)[0])
    with torch.inference_mode():
        y_sym, _, z_hat = gpu._front(x.to(cuda))
        rows = gpu._rows(z_hat)
    n = len(images)
    enc, _dec, K, cap = rans_for(cpu, y_sym[0].numel())
    stream, lengths, overflow = enc(y_sym.reshape(n, -1).cpu(), rows.reshape(n, -1).cpu())
    assert K == 128 and not overflow.any()
    for b in range(n):
        assert bytes(fields[b][0][0]) == stream[b, : int(lengths[b])].numpy().tobytes()


# -- training: K1 under autograd, one step against the CPU --------------------


@pytest.mark.parametrize("c", [8, 16, 32, 40, 64, 128, 192])
@pytest.mark.parametrize("rows", [1, 4551, 131_072])
@pytest.mark.parametrize("inverse", [False, True])
def test_function_gradients_match_twin_autograd(cuda, c, rows, inverse):
    """FusedGDN (K1 forward, plain-op backward) against autograd through
    the twin on the same card tensors: one K1 launch, y within the kernel's
    tolerance, dx/dbeta/dgamma within 1e-4 relative and 1e-4 of each one's
    largest entry (fp32 products in another order)."""
    x, beta, gamma = _inputs(rows + c, rows, c, cuda)
    gy = torch.randn(rows, c, device=cuda, generator=torch.Generator(cuda).manual_seed(rows))
    results = []
    for fn in (lambda *a: FusedGDN.apply(*a, inverse),
               lambda *a: fused_gdn_reference(*a, inverse)):
        leaves = [t.clone().requires_grad_() for t in (x, beta, gamma)]
        before = fused_gdn.launches
        y = fn(*leaves)
        launched = fused_gdn.launches - before
        y.backward(gy)
        torch.cuda.synchronize()
        results.append((y.detach(), *(t.grad for t in leaves), launched))
    (y, dx, db, dg, n), (y_ref, dx_ref, db_ref, dg_ref, n_ref) = results
    assert (n, n_ref) == (1, 0)
    torch.testing.assert_close(y, y_ref, **TOL)
    for got, want in ((dx, dx_ref), (db, db_ref), (dg, dg_ref)):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-4 * want.abs().max().item())


def test_train_step_on_card_matches_cpu(cuda):
    """One quantized (training=False) step of a C = 32 model: the card's
    loss and every gradient against the same step on the CPU (loss 1e-4
    relative; gradients 1e-3 relative plus 1e-3 of each one's largest
    entry: K1's 3xTF32 forward and cuDNN's fp32 sums). Adam's first update
    is about lr * sign(gradient), so near-zero gradients whose sign differs
    move params apart by 2 lr: the update itself is held to optax on the
    CPU (tests/test_torch_train.py)."""
    cfg = bmshj2018.Config(num_filters=32, num_latents=32, num_hyperlatents=32)
    tcfg = common.TrainConfig(learning_rate=1e-3)
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 128, 128, 3).astype(np.float32))
    out = []
    for device in ("cpu", cuda):
        model = bmshj2018.BMSHJ2018Model(cfg, seed=3).to(device)
        optimizer = common.make_optimizer(model, tcfg)
        loss, _ = common.train_step(model, optimizer,
                                    bmshj2018.make_loss_fn(model, training=False),
                                    x.to(device), None, common.lr_schedule(tcfg))
        out.append((loss.item(), {n: p.grad.cpu() for n, p in model.named_parameters()}))
    (loss_cpu, g_cpu), (loss_gpu, g_gpu) = out
    np.testing.assert_allclose(loss_gpu, loss_cpu, rtol=1e-4)
    for n in g_cpu:
        torch.testing.assert_close(g_gpu[n], g_cpu[n], rtol=1e-3,
                                   atol=1e-3 * g_cpu[n].abs().max().item(), msg=n)


def test_train_step_launches_k1_six_times(cuda):
    """One training step (noise from a card generator) launches K1 once per
    GDN layer, in the forward only, and no rANS kernel."""
    cfg = bmshj2018.Config(num_filters=64, num_latents=64, num_hyperlatents=32)
    tcfg = common.TrainConfig()
    model = bmshj2018.BMSHJ2018Model(cfg).to(cuda)
    optimizer = common.make_optimizer(model, tcfg)
    x = torch.rand(2, 128, 128, 3, device=cuda)
    gen = torch.Generator(cuda).manual_seed(0)
    counts = (fused_gdn.launches, rans.rans_encode.launches, rans.rans_decode.launches)
    loss, _ = common.train_step(model, optimizer, bmshj2018.make_loss_fn(model), x, gen,
                                common.lr_schedule(tcfg))
    torch.cuda.synchronize()
    assert np.isfinite(loss.item())
    assert (fused_gdn.launches - counts[0], rans.rans_encode.launches - counts[1],
            rans.rans_decode.launches - counts[2]) == (6, 0, 0)


# -- the other families on the card ---------------------------------------------


@pytest.mark.parametrize("arch", ["bls2017", "bmshj2018"])
def test_bls2017_round_trip_on_card_matches_cpu(cuda, arch):
    """A C = 32 bls2017 (or bmshj2018-factorized) codec on the card: K1
    launches over one round trip (4 or 6), byte-identical re-compression,
    and a reconstruction within one level of the CPU codec's on the same
    tables."""
    cfg = bls2017.Config(num_filters=32, arch=arch)
    cpu = bls2017.Codec(bls2017.BLS2017Model(cfg, seed=2), device="cpu")
    gpu = bls2017.Codec(bls2017.BLS2017Model(cfg, seed=2), device=cuda,
                        tables=cpu.em.tables)
    image = (np.random.RandomState(2).rand(96, 130, 3) * 255).astype(np.uint8)
    before = fused_gdn.launches
    blob = gpu.compress(image)
    out = gpu.decompress(blob)
    assert fused_gdn.launches == before + (4 if arch == "bls2017" else 6)
    assert out.shape == image.shape and gpu.compress(image) == blob
    cpu_out = cpu.decompress(cpu.compress(image))
    assert np.abs(cpu_out.astype(np.int16) - out.astype(np.int16)).max() <= 1


@pytest.mark.parametrize("c", [8, 32])
def test_mbt2018_round_trip_on_card_matches_cpu(cuda, c):
    """A small mbt2018 codec on the card (C = 8 runs K1 padded) with both
    coders: launches over one device-coded round trip (K1 6, K3 2, K2 1),
    the device coder's reconstruction bit-equal to the host coder's,
    batch-1 decode equal to the batch decode, and the CPU codec within one
    level on the same tables."""
    cfg = mbt2018.Config(num_filters=c, num_latents=c, num_hyperlatents=c)
    cpu = mbt2018.Codec(mbt2018.MBT2018Model(cfg, seed=4), device="cpu")
    gpu = mbt2018.Codec(mbt2018.MBT2018Model(cfg, seed=4), device=cuda,
                        tables={"side": cpu.side_em.tables, "main": cpu.em.tables})
    images = (np.random.RandomState(3).rand(3, 96, 130, 3) * 255).astype(np.uint8)
    before = (rans.rans_encode.launches, rans.rans_decode.launches, fused_gdn.launches)
    blobs = gpu.compress_batch(images, coder="device")
    out = gpu.decompress_batch(blobs)
    assert (rans.rans_encode.launches, rans.rans_decode.launches,
            fused_gdn.launches) == (before[0] + 2, before[1] + 1, before[2] + 6)
    host = gpu.compress_batch(images)
    np.testing.assert_array_equal(gpu.decompress_batch(host), out)
    assert gpu.compress_batch(images, coder="device") == blobs
    np.testing.assert_array_equal(gpu.decompress(blobs[1]), out[1])
    cpu_out = cpu.decompress_batch(cpu.compress_batch(images))
    assert np.abs(cpu_out.astype(np.int16) - out.astype(np.int16)).max() <= 1


def test_mbt2018_train_step_on_card_matches_cpu(cuda):
    """One quantized (training=False) step of a C = 32 mbt2018 model, card
    against CPU: the loss (1e-4 relative) and every gradient (1e-3 relative
    plus 1e-3 of its largest entry), as for bmshj2018."""
    cfg = mbt2018.Config(num_filters=32, num_latents=32, num_hyperlatents=32)
    tcfg = common.TrainConfig(learning_rate=1e-3)
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 128, 128, 3).astype(np.float32))
    out = []
    for device in ("cpu", cuda):
        model = mbt2018.MBT2018Model(cfg, seed=3).to(device)
        optimizer = common.make_optimizer(model, tcfg)
        loss, _ = common.train_step(model, optimizer,
                                    mbt2018.make_loss_fn(model, training=False),
                                    x.to(device), None, common.lr_schedule(tcfg))
        out.append((loss.item(), {n: p.grad.cpu() for n, p in model.named_parameters()}))
    (loss_cpu, g_cpu), (loss_gpu, g_gpu) = out
    np.testing.assert_allclose(loss_gpu, loss_cpu, rtol=1e-4)
    for n in g_cpu:
        torch.testing.assert_close(g_gpu[n], g_cpu[n], rtol=1e-3,
                                   atol=1e-3 * g_cpu[n].abs().max().item(), msg=n)


# -- b2018 and ms2020 at full width on the card ----------------------------------


def _pair(make, cuda):
    """The same seeded model on the CPU and on the card."""
    cpu = make()
    gpu = make()
    gpu.load_state_dict(cpu.state_dict())
    return cpu, gpu.to(cuda)


@pytest.mark.parametrize("q", [0, 3, (1, 2)])
def test_b2018_forward_on_card_matches_cpu(cuda, q):
    """b2018-gdn at 192 filters: the analysis at a scalar quality and one
    quality per example within 1e-4 (cuDNN and K1 against the CPU); the
    synthesis of the same rounded latents within 1e-4; the rates of the
    quantized forward within 1e-3 relative (a latent at a rounding tie may
    round the other way)."""
    cpu, gpu = _pair(lambda: b2018.B2018Model(b2018.Config(num_filters=192), seed=2), cuda)
    x = torch.from_numpy(np.random.RandomState(4).rand(2, 96, 128, 3).astype(np.float32))
    qt = torch.tensor(q)
    with torch.no_grad():
        gains = cpu.gain[qt] if qt.ndim == 0 else cpu.gain[qt][:, None, None, :]
        y_cpu = cpu.analysis(x) * gains
        y_gpu = gpu.analysis(x.to(cuda)) * gains.to(cuda)
        torch.testing.assert_close(y_gpu.cpu(), y_cpu, rtol=1e-4, atol=1e-4)
        y_hat = torch.round(y_cpu)
        inv = cpu.inv_gain[qt] if qt.ndim == 0 else cpu.inv_gain[qt][:, None, None, :]
        torch.testing.assert_close(gpu.synthesis((y_hat * inv).to(cuda)).cpu(),
                                   cpu.synthesis(y_hat * inv), rtol=1e-4, atol=1e-4)
        before = fused_gdn.launches
        _, bits_gpu = gpu(x.to(cuda), None, qt.to(cuda), training=False)
        assert fused_gdn.launches == before + 4
        _, bits_cpu = cpu(x, None, qt, training=False)
    torch.testing.assert_close(bits_gpu.cpu(), bits_cpu, rtol=1e-3, atol=0)


def test_b2018_codec_and_train_step_on_card(cuda):
    """b2018-gdn at 192: K1 4 launches over one round trip and over one
    training step; each quality's blob carries it; re-compression is
    byte-identical; the reconstruction within one level of the CPU codec's
    on the same tables."""
    cpu_model, gpu_model = _pair(
        lambda: b2018.B2018Model(b2018.Config(num_filters=192), seed=3), cuda)
    cpu = b2018.Codec(cpu_model, device="cpu")
    gpu = b2018.Codec(gpu_model, device=cuda, tables=cpu.tables)
    image = (np.random.RandomState(5).rand(96, 130, 3) * 255).astype(np.uint8)
    for quality in (1, 4):
        before = fused_gdn.launches
        blob = gpu.compress(image, quality=quality)
        out = gpu.decompress(blob)
        assert fused_gdn.launches == before + 4
        assert PackedTensors(blob).unpack_one(2, np.int32)[2] == quality - 1
        assert out.shape == image.shape and gpu.compress(image, quality=quality) == blob
        cpu_out = cpu.decompress(cpu.compress(image, quality=quality))
        assert np.abs(cpu_out.astype(np.int16) - out.astype(np.int16)).max() <= 1
    tcfg = common.TrainConfig(lr_scales=(("params/gain", 10.0),))
    optimizer = common.make_optimizer(gpu_model, tcfg)
    counts = (fused_gdn.launches, rans.rans_encode.launches, rans.rans_decode.launches)
    loss, _ = common.train_step(gpu_model, optimizer, b2018.make_loss_fn(gpu_model),
                                torch.rand(4, 128, 128, 3, device=cuda),
                                torch.Generator(cuda).manual_seed(0), common.lr_schedule(tcfg))
    torch.cuda.synchronize()
    assert np.isfinite(loss.item())
    assert (fused_gdn.launches - counts[0], rans.rans_encode.launches - counts[1],
            rans.rans_decode.launches - counts[2]) == (4, 0, 0)


def test_ms2020_pieces_on_card_match_cpu(cuda):
    """ms2020 at full width (192/320/192, 10 slices): the latents, the
    supports and every slice's mean, scale and LRP on the card against the
    CPU on the same inputs (the CPU's decoded slices as context), within
    1e-4; the quantized loss within 1e-3 relative."""
    cpu, gpu = _pair(lambda: ms2020.MS2020Model(ms2020.Config(), seed=4), cuda)
    x = torch.from_numpy(np.random.RandomState(6).rand(2, 128, 128, 3).astype(np.float32))

    def close(got, want):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)

    with torch.no_grad():
        y, z = cpu.encode_latents(x)
        for got, want in zip(gpu.encode_latents(x.to(cuda)), (y, z)):
            close(got, want)
        sup = cpu.supports_from_zhat(torch.round(z))
        gsup = [t.to(cuda) for t in sup]
        for got, want in zip(gpu.supports_from_zhat(torch.round(z).to(cuda)), sup):
            close(got, want)
        decoded = []
        for i in range(10):
            mu, sigma = cpu.slice_params(i, *sup, decoded)
            gmu, gsigma = gpu.slice_params(i, *gsup, [d.to(cuda) for d in decoded])
            close(gmu, mu)
            close(gsigma, sigma)
            y_hat = torch.round(y[..., 32 * i : 32 * i + 32] - mu) + mu
            lrp = cpu.slice_lrp(i, sup[0], decoded + [y_hat])
            close(gpu.slice_lrp(i, gsup[0], [d.to(cuda) for d in decoded + [y_hat]]), lrp)
            decoded.append(y_hat + lrp)
        before = fused_gdn.launches
        loss_gpu, _ = ms2020.make_loss_fn(gpu, training=False)(x.to(cuda))
        assert fused_gdn.launches == before + 6
        loss_cpu, _ = ms2020.make_loss_fn(cpu, training=False)(x)
    np.testing.assert_allclose(loss_gpu.item(), loss_cpu.item(), rtol=1e-3)


def test_ms2020_device_round_trip_equals_host_coder_on_card(cuda):
    """ms2020 at full width on 3 images of 96x130 (padded to 128x192): the
    device coder's round trip launches K1 6, K3 20 (2 a slice) and K2 10
    (1 a slice) and decodes to the host coder's reconstruction; a blob
    decodes alone as in the batch; re-compression is byte-identical; each
    slice's words are what the CPU coder (the twin) writes for the card's
    symbols and rows; a training step launches K1 6 and no rANS kernel."""
    model = ms2020.MS2020Model(ms2020.Config(), seed=5)
    codec = ms2020.Codec(model, device=cuda)
    images = (np.random.RandomState(7).rand(3, 96, 130, 3) * 255).astype(np.uint8)
    before = (rans.rans_encode.launches, rans.rans_decode.launches, fused_gdn.launches)
    blobs = codec.compress_batch(images, coder="device")
    out = codec.decompress_batch(blobs)
    assert (rans.rans_encode.launches, rans.rans_decode.launches,
            fused_gdn.launches) == (before[0] + 20, before[1] + 10, before[2] + 6)
    assert all(num_fields(b) == 10 + 4 for b in blobs)
    host = codec.compress_batch(images)
    assert all(num_fields(b) == 10 + 3 for b in host)
    np.testing.assert_array_equal(codec.decompress_batch(host), out)
    np.testing.assert_array_equal(codec.decompress(blobs[1]), out[1])
    assert codec.compress_batch(images, coder="device") == blobs
    with torch.inference_mode():
        syms, _, rows, _ = codec._encode_slices(images)
    _enc, _dec, K, cap = rans_for(codec, syms[0][0].numel())
    for i in (0, 9):
        stream, lengths, _ = rans.rans_encode_reference(
            codec._rans_tables, syms[i].reshape(3, -1).cpu(), rows[i].reshape(3, -1).cpu(),
            K, cap)
        for b in range(3):
            want = stream[b, : int(lengths[b])].numpy().tobytes()
            assert bytes(PackedTensors(blobs[b]).unpack_one(i, object)[0]) == want
    tcfg = common.TrainConfig()
    optimizer = common.make_optimizer(model, tcfg)
    model.train()
    counts = (fused_gdn.launches, rans.rans_encode.launches, rans.rans_decode.launches)
    loss, _ = common.train_step(model, optimizer, ms2020.make_loss_fn(model),
                                torch.rand(2, 128, 128, 3, device=cuda),
                                torch.Generator(cuda).manual_seed(0), common.lr_schedule(tcfg))
    torch.cuda.synchronize()
    assert np.isfinite(loss.item())
    assert (fused_gdn.launches - counts[0], rans.rans_encode.launches - counts[1],
            rans.rans_decode.launches - counts[2]) == (6, 0, 0)


def test_rans_kernels_match_twins_on_an_ms2020_slice(cuda):
    """K3 and K2 against their twins on slice 0 of a full-width ms2020
    codec's real symbols and rows for 2 images of 768x512 (N = 49,152 a
    slice, K = 128): identical words, lengths, flags and values."""
    codec = ms2020.Codec(ms2020.MS2020Model(ms2020.Config(), seed=6), device=cuda)
    yy, xx = np.mgrid[0:512, 0:768].astype(np.float32)
    image = np.stack([xx / 3, yy / 2, (np.sin(xx / 17) * 0.5 + 0.5) * 255], -1)
    images = np.stack([np.clip(image + s * 40, 0, 255).astype(np.uint8) for s in range(2)])
    with torch.inference_mode():
        syms, _, rows, _ = codec._encode_slices(images)
        values, slice_rows = syms[0].reshape(2, -1), rows[0].reshape(2, -1)
        _enc, _dec, K, cap = rans_for(codec, values.shape[1])
        assert (values.shape[1], K, cap) == (49_152, 128, 3 * 49_152 + 2 * 128 + 64)
        tables = codec._rans_tables
        got = rans.rans_encode(tables, values, slice_rows, K, cap)
        want = rans.rans_encode_reference(tables, values, slice_rows, K, cap)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert not got[2].any()
        out, ok = rans.rans_decode(tables, got[0], slice_rows, K, values.shape[1])
        want_out, want_ok = rans.rans_decode_reference(tables, got[0], slice_rows, K,
                                                       values.shape[1])
        assert torch.equal(out, want_out) and torch.equal(ok, want_ok)
        assert bool(ok.all()) and torch.equal(out, values)


# -- HiFiC ------------------------------------------------------------------------


def test_hific_codec_on_card_matches_cpu(cuda):
    """hific-mi at full width on 3 images of 96x130 (padded to 128x192): a
    device-coded round trip launches K3 2, K2 1 and no K1, and decodes to
    the host coder's reconstruction; a blob decodes alone as in the batch;
    re-compression is byte-identical; the CPU codec on the same tables is
    within one level."""
    cfg = hific.get_config("hific-mi")
    cpu = hific.Codec(hific.HificModel(cfg, seed=3), device="cpu")
    gpu = hific.Codec(hific.HificModel(cfg, seed=3), device=cuda,
                      tables={"side": cpu.side_em.tables, "main": cpu.em.tables})
    images = (np.random.RandomState(8).rand(3, 96, 130, 3) * 255).astype(np.uint8)
    before = (rans.rans_encode.launches, rans.rans_decode.launches, fused_gdn.launches)
    blobs = gpu.compress_batch(images, coder="device")
    out = gpu.decompress_batch(blobs)
    assert (rans.rans_encode.launches, rans.rans_decode.launches,
            fused_gdn.launches) == (before[0] + 2, before[1] + 1, before[2])
    assert all(num_fields(b) == 5 and PackedTensors(b).model == "hific-mi" for b in blobs)
    host = gpu.compress_batch(images)
    assert all(num_fields(b) == 4 for b in host)
    np.testing.assert_array_equal(gpu.decompress_batch(host), out)
    np.testing.assert_array_equal(gpu.decompress(blobs[1]), out[1])
    assert gpu.compress_batch(images, coder="device") == blobs
    cpu_out = cpu.decompress_batch(cpu.compress_batch(images))
    assert np.abs(cpu_out.astype(np.int16) - out.astype(np.int16)).max() <= 1


def test_hific_joint_step_on_card_matches_cpu(cuda, monkeypatch):
    """One joint G/D step of a small HiFiC (8 latents, 4 hyperlatents, one
    residual block) on 2 crops of 128x128, the noise drawn once on the
    CPU, run on the CPU in float64 (the reference), on the card in float64
    and float32, and on the CPU in float32. float64: the card's losses
    within 1e-10 relative of the CPU's, and every G and D gradient and D's
    spectral-norm state within 1e-8 of its largest entry. float32: the
    losses within 1e-4 relative of the CPU's, the spectral-norm state
    within 1e-3, and the gradients, each against float64, no further from
    it on the card than 3x the CPU's distance, for the worst tensor and the
    median one (a ReLU at the 2 x 8 x 8 latents that flips where a forward
    is an ulp from 0 moves a gradient by ~1/128 of its sum, so float32 is
    not held to the CPU's float32). No GDN, rANS or 3x3 convolution kernel
    launches in a training step; ChannelNorm's kernel launches once a norm (13 calls) on
    the card, in float32 and in float64 (its general path)."""
    cfg = hific.HificConfig(name="hific-test", target_rate=0.3, num_latents=8,
                            num_hyperlatents=4, num_residual_blocks=1)
    gen = torch.Generator().manual_seed(1)
    noise = [torch.rand(shape, generator=gen) - 0.5
             for shape in ((2, 2, 2, 4), (2, 8, 8, 8), (2, 2, 2, 8))]
    x = torch.from_numpy(np.random.RandomState(2).rand(2, 128, 128, 3).astype(np.float32))
    runs = {}
    for device, dtype in (("cpu", torch.float64), (cuda, torch.float64),
                          (cuda, torch.float32), ("cpu", torch.float32)):
        queue = list(noise)
        for module in (continuous_batched, continuous_indexed):
            monkeypatch.setattr(module, "uniform_noise",
                                lambda t, g: queue.pop(0).to(t.device, t.dtype))
        model = hific.HificModel(cfg, seed=3).to(device, dtype)
        disc = hific.Discriminator(cfg.num_latents, seed=4).to(device, dtype)
        lpips = hific_lpips.LPIPS(seed=5).requires_grad_(False).to(device, dtype)
        step, _, _ = hific.make_train_steps(model, disc, lpips, cfg)
        counts = (fused_gdn.launches, rans.rans_encode.launches, rans.rans_decode.launches,
                  conv3x3.launches)
        norms = fused_channel_norm.launches
        metrics = step(x.to(device, dtype), None)
        assert queue == []
        assert (fused_gdn.launches, rans.rans_encode.launches,
                rans.rans_decode.launches, conv3x3.launches) == counts
        assert fused_channel_norm.launches - norms == (13 if device == cuda else 0)
        tensors = {**{f"G {n}": p.grad.cpu() for n, p in model.named_parameters()},
                   **{f"D {n}": p.grad.cpu() for n, p in disc.named_parameters()},
                   **{f"D {n}": b.cpu() for n, b in disc.named_buffers()}}
        runs[device, dtype] = ({k: v.item() for k, v in metrics.items()}, tensors)
    m_ref, t_ref = runs["cpu", torch.float64]
    for (m_gpu, t_gpu), (m_cpu, t_cpu), loss_tol in (
            (runs[cuda, torch.float64], runs["cpu", torch.float64], 1e-10),
            (runs[cuda, torch.float32], runs["cpu", torch.float32], 1e-4)):
        for k in ("g_loss", "d_loss"):
            np.testing.assert_allclose(m_gpu[k], m_cpu[k], rtol=loss_tol, err_msg=k)
    t64 = runs[cuda, torch.float64][1]
    for n, want in t_ref.items():
        torch.testing.assert_close(t64[n], want, rtol=0,
                                   atol=1e-8 * want.abs().max().item(), msg=n)
    (_, t_gpu), (_, t_cpu) = runs[cuda, torch.float32], runs["cpu", torch.float32]

    def rel(got, want):
        return (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)

    for n in t_ref:
        if n.endswith((".u", ".sigma")):
            assert rel(t_gpu[n], t_cpu[n]) <= 1e-3, n
    grads = [n for n in t_ref if not n.endswith((".u", ".sigma"))]
    card = np.array([rel(t_gpu[n], t_ref[n]) for n in grads])
    cpu = np.array([rel(t_cpu[n], t_ref[n]) for n in grads])
    assert card.max() <= 3 * cpu.max(), (card.max(), cpu.max())
    assert np.median(card) <= 3 * np.median(cpu), (np.median(card), np.median(cpu))


# -- HiFiC's fused ChannelNorm -------------------------------------------------------

# The main path's calls, (N, H, W, C) and (bias, relu, residual), of a batch of
# eight 768x512 images: the encoder's five norms, then the decoder's norm_in,
# norm_head, a residual block's two and the up-path's four.
NORM_CALLS = [
    ((8, 512, 768, 60), (True, True, False)), ((8, 256, 384, 120), (True, True, False)),
    ((8, 128, 192, 240), (True, True, False)), ((8, 64, 96, 480), (True, True, False)),
    ((8, 32, 48, 960), (True, True, False)), ((8, 32, 48, 220), (False, False, False)),
    ((8, 32, 48, 960), (True, False, False)), ((8, 32, 48, 960), (True, False, True)),
    ((8, 64, 96, 480), (True, True, False)), ((8, 128, 192, 240), (True, True, False)),
    ((8, 256, 384, 120), (True, True, False)), ((8, 512, 768, 60), (True, True, False)),
]
# Kernel against twin: at HiFiC's widths, with 16 rows or more and 16-byte
# aligned rows, the kernel sums in torch.mean's order as of torch
# ATEN_ORDER_TORCH and rounds every op as the twin's ops do, so the two are
# equal bit for bit; test_channel_norm_sums_rows_as_torch_mean alone holds
# that, and the other tests hold those cases to NORM_ULPS ulps of the largest
# output (a mean an ulp off moves a whole row's outputs by about an ulp of
# the row's scale, whatever the output's own size), so that another
# torch's order fails the one test that names the cause. Elsewhere (other
# widths, rows only 4-byte aligned, or fewer rows, where ATen picks wider
# blocks) the sums take other orders, which moves a row's mean and variance
# by a few ulps and an output of these inputs (|out| < ~10) by under 1e-6.
NORM_TOL = dict(rtol=1e-5, atol=1e-5)
NORM_ULPS = 4
NORM_WIDTHS = (60, 120, 220, 240, 480, 960)


def _norm_inputs(shape, bias, residual, device, seed=0, offset=0):
    """x with mean 3 and std 5 a row, gamma and beta around 1 and 0, bias
    and residual normal, drawn on ``device``; ``offset`` floats of slack
    before each tensor (an offset of 1 leaves it 4-byte aligned only)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    c = shape[-1]

    def draw(*s):
        n = int(np.prod(s))
        return torch.randn(n + offset, generator=gen, device=device)[offset:].view(*s)

    x = draw(*shape).mul_(5).add_(3)
    gamma, beta = draw(c).mul_(0.3).add_(1), draw(c).mul_(0.3)
    return (x, gamma, beta, draw(c) if bias else None, draw(*shape) if residual else None)


def _norm_id(shape, flags):
    return "x".join(map(str, shape)) + "-" + "".join("01"[f] for f in flags)


def _assert_ulps(got, want, msg=None):
    """``got`` within NORM_ULPS ulps of ``want``'s largest magnitude."""
    tol = NORM_ULPS * torch.finfo(want.dtype).eps * want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=0, atol=tol, msg=msg)


def test_channel_norm_sums_rows_as_torch_mean(cuda):
    """The float32 kernel's mean and rstd of each row at every distinct
    call of a HiFiC round trip (8x768x512), bit for bit against torch.mean
    of the biased row and the twin's rstd: the kernel copies the order in
    which ATen's reduction sums a row, read from one torch release, and
    HiFiC's latents at rounding ties (the benchmark's hific-mi
    ``pixels_off``) depend on it."""
    for shape, (bias, relu, residual) in sorted(set(NORM_CALLS)):
        x, gamma, beta, b, r = _norm_inputs(shape, bias, residual, cuda, seed=shape[-1])
        with torch.inference_mode():
            _, mean, rstd = channel_norm_kernel._kernel_forward(x, gamma, beta, b, r, relu,
                                                                1e-3, stats=True)
            v = x if b is None else x + b
            want_mean = torch.mean(v, dim=-1, keepdim=True)
            _, _, want_rstd = channel_norm_kernel._reference(x, gamma, beta, b, r, relu, 1e-3)
            off = int((mean != want_mean).sum()) + int((rstd != want_rstd).sum())
        assert off == 0, (
            f"{_norm_id(shape, (bias, relu, residual))}: {off} of {2 * mean.numel()} row "
            f"statistics differ from torch.mean's; the kernel sums rows in ATen's order as of "
            f"torch {channel_norm_kernel.ATEN_ORDER_TORCH}, this is torch {torch.__version__}: "
            "read Reduce.cuh's order for a row of C floats and update Layout and row_sum in "
            "csrc/channel_norm.cu")


@pytest.mark.parametrize("shape,flags", sorted(set(NORM_CALLS)),
                         ids=[_norm_id(*call) for call in sorted(set(NORM_CALLS))])
def test_channel_norm_kernel_matches_twin_at_the_main_path(cuda, shape, flags):
    """Every distinct call of a HiFiC round trip at 8x768x512, one launch
    each, the output and the saved mean and rstd within NORM_ULPS ulps of
    the twin's (bit for bit where ATen's order is the kernel's: see
    test_channel_norm_sums_rows_as_torch_mean)."""
    bias, relu, residual = flags
    x, gamma, beta, b, r = _norm_inputs(shape, bias, residual, cuda, seed=shape[-1])
    before = fused_channel_norm.launches
    with torch.inference_mode():
        got, mean, rstd = channel_norm_kernel._kernel_forward(x, gamma, beta, b, r, relu, 1e-3,
                                                              stats=True)
        torch.cuda.synchronize()
        assert fused_channel_norm.launches == before + 1
        want, want_mean, want_rstd = channel_norm_kernel._reference(x, gamma, beta, b, r, relu,
                                                                    1e-3)
        _assert_ulps(got, want, "out")
        _assert_ulps(mean, want_mean, "mean")
        _assert_ulps(rstd, want_rstd, "rstd")
        assert torch.equal(fused_channel_norm(x, gamma, beta, b, r, relu), got)


@pytest.mark.parametrize("flags", list(itertools.product((False, True), repeat=3)),
                         ids=lambda f: "".join("01"[v] for v in f))
@pytest.mark.parametrize("c", [60, 120, 220, 240, 480, 960, 1, 37, 100, 1000])
@pytest.mark.parametrize("rows,offset", [(1, 0), (4551, 0), (4551, 1)])
def test_channel_norm_kernel_at_any_width_matches_twin(cuda, c, rows, offset, flags):
    """Each flag combination at HiFiC's widths (the float4 path: 4 rows a
    warp below 128 channels, one from 128) and at other widths or rows only
    4-byte aligned (``offset`` 1: the general path), with rows that leave
    a warp's last group part empty: within NORM_ULPS ulps where NORM_TOL's
    note says the two are equal bit for bit, else within NORM_TOL."""
    bias, relu, residual = flags
    x, gamma, beta, b, r = _norm_inputs((rows, c), bias, residual, cuda, seed=c + rows,
                                        offset=offset)
    with torch.inference_mode():
        got = fused_channel_norm(x, gamma, beta, b, r, relu)
        torch.cuda.synchronize()
        want = fused_channel_norm_reference(x, gamma, beta, b, r, relu)
    if c in NORM_WIDTHS and rows >= 16 and offset == 0:
        _assert_ulps(got, want)
    else:
        torch.testing.assert_close(got, want, **NORM_TOL)


@pytest.mark.parametrize("c", [60, 120, 960, 37])
def test_channel_norm_rows_do_not_depend_on_the_batch(cuda, c):
    """A row's result is bit-equal alone, at any place in a call of
    200,000 rows, and on a second run."""
    x, gamma, beta, b, r = _norm_inputs((200_000, c), True, True, cuda, seed=c)
    with torch.inference_mode():
        whole = fused_channel_norm(x, gamma, beta, b, r, True)
        again = fused_channel_norm(x, gamma, beta, b, r, True)
        for at in (0, 1, 4, 12_345, 199_999):
            alone = fused_channel_norm(x[at:at + 1].clone(), gamma, beta, b,
                                       r[at:at + 1].clone(), True)
            assert torch.equal(alone, whole[at:at + 1]), at
    assert torch.equal(whole, again)


@pytest.mark.parametrize("flags", list(itertools.product((False, True), repeat=3)),
                         ids=lambda f: "".join("01"[v] for v in f))
@pytest.mark.parametrize("c", [60, 960, 37])
def test_channel_norm_gradients_on_card(cuda, c, flags):
    """FusedChannelNorm on the card (the kernel forward, the plain-op
    backward) against autograd through the twin on the card: the output
    within NORM_ULPS ulps at HiFiC's widths, else within NORM_TOL, the gradients of
    x, gamma, beta, bias and residual within 1e-4 of their largest entry
    (other summation orders over 4,551 rows in float32)."""
    bias, relu, residual = flags
    tensors = _norm_inputs((3, 37, 41, c), bias, residual, cuda, seed=c)
    w = torch.randn(tensors[0].shape, device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    runs = []
    for fn in (fused_channel_norm, fused_channel_norm_reference):
        leaves = [t.clone().requires_grad_() if t is not None else None for t in tensors]
        before = fused_channel_norm.launches
        out = fn(*leaves, relu=relu)
        launched = fused_channel_norm.launches - before
        (out * w).sum().backward()
        runs.append((out.detach(), [t.grad if t is not None else None for t in leaves],
                     launched))
    (got, grads, launched), (want, want_grads, _) = runs
    assert launched == 1
    if c in NORM_WIDTHS:
        _assert_ulps(got, want)
    else:
        torch.testing.assert_close(got, want, **NORM_TOL)
    for name, g, h in zip(("x", "gamma", "beta", "bias", "residual"), grads, want_grads):
        if h is None:
            assert g is None, name
            continue
        torch.testing.assert_close(g, h, rtol=0, atol=1e-4 * h.abs().max().item(), msg=name)


@pytest.mark.parametrize("flags", [(False, False, False), (True, True, False),
                                   (True, False, True)], ids=lambda f: "".join("01"[v] for v in f))
@pytest.mark.parametrize("c", [60, 960, 37])
def test_channel_norm_kernel_in_float64_matches_twin(cuda, c, flags):
    """float64 (HiFiC's float64 checks) takes the general path: one launch,
    the output, mean and rstd within 1e-13 of the twin's largest entry, and
    the gradients under autograd within 1e-12 of their largest entry."""
    bias, relu, residual = flags
    tensors = [t.double() if t is not None else None
               for t in _norm_inputs((5, 7, 11, c), bias, residual, cuda, seed=c)]
    before = fused_channel_norm.launches
    with torch.inference_mode():
        got, mean, rstd = channel_norm_kernel._kernel_forward(*tensors, relu, 1e-3, stats=True)
        want, want_mean, want_rstd = channel_norm_kernel._reference(*tensors, relu, 1e-3)
    assert fused_channel_norm.launches == before + 1 and got.dtype == torch.float64
    for name, g, h in (("out", got, want), ("mean", mean, want_mean), ("rstd", rstd, want_rstd)):
        torch.testing.assert_close(g, h, rtol=0, atol=1e-13 * h.abs().max().item(), msg=name)
    w = torch.randn(tensors[0].shape, device=cuda, dtype=torch.float64,
                    generator=torch.Generator(cuda).manual_seed(1))
    grads = []
    for fn in (fused_channel_norm, fused_channel_norm_reference):
        leaves = [t.clone().requires_grad_() if t is not None else None for t in tensors]
        (fn(*leaves, relu=relu) * w).sum().backward()
        grads.append([t.grad for t in leaves if t is not None])
    for g, h in zip(*grads):
        torch.testing.assert_close(g, h, rtol=0, atol=1e-12 * h.abs().max().item())


def test_hific_float32_norms_take_rows_as_the_convolutions_leave_them(cuda, monkeypatch):
    """Over a float32 hific-mi round trip on the card every convolution
    before a norm (through ``SignalConv2D.convolve`` or the 3x3 kernel), and
    the latents before ``norm_in``, leave contiguous rows, so the networks'
    ``.contiguous()`` before a norm copies nothing there (cuDNN's float64
    convolutions leave NCHW memory, which it copies)."""
    from compression_tpu_torch.layers.signal_conv import SignalConv2D
    from compression_tpu_torch.models.hific import archs as hific_archs

    seen = []
    gpu = hific.Codec(hific.HificModel(hific.get_config("hific-mi"), seed=3), device=cuda)
    before_norm = [conv for net in (gpu.model.encoder, gpu.model.generator)
                   for name, conv in net.named_modules()
                   if isinstance(conv, SignalConv2D) and name != "conv_out"]

    def spy(conv, only=None):
        def run(*args, **kwargs):
            y = conv(*args, **kwargs)
            if only is None or any(args[0] is c for c in only):
                seen.append(y.is_contiguous())
            return y
        return run

    monkeypatch.setattr(SignalConv2D, "convolve", spy(SignalConv2D.convolve, before_norm))
    monkeypatch.setattr(hific_archs, "conv3x3", spy(hific_archs.conv3x3))
    gpu.model.generator.register_forward_pre_hook(
        lambda module, args: seen.append(args[0].is_contiguous()))
    images = (np.random.RandomState(9).rand(2, 96, 130, 3) * 255).astype(np.uint8)
    gpu.decompress_batch(gpu.compress_batch(images, coder="device"))
    assert seen == [True] * (5 + 1 + 2 + 2 * 9 + 4 - 1)


def test_channel_norm_launches_on_the_codec_paths(cuda):
    """hific-mi's device-coded codec on 2 images of 96x130 launches the
    kernel 5 times a compressed batch and 24 a decoded one (9 residual
    blocks); a bmshj2018 round trip launches it 0 times."""
    gpu = hific.Codec(hific.HificModel(hific.get_config("hific-mi"), seed=3), device=cuda)
    images = (np.random.RandomState(8).rand(2, 96, 130, 3) * 255).astype(np.uint8)
    before = fused_channel_norm.launches
    blobs = gpu.compress_batch(images, coder="device")
    assert fused_channel_norm.launches == before + 5
    gpu.decompress_batch(blobs)
    assert fused_channel_norm.launches == before + 5 + 24
    codec = bmshj2018.Codec(bmshj2018.load_model(CKPT), device=cuda)
    codec.decompress_batch(codec.compress_batch(images, coder="device"))
    assert fused_channel_norm.launches == before + 5 + 24


# -- HiFiC's 3x3 convolution kernel -------------------------------------------------

# (N, H, W, cin, cout): a residual block's convolution and conv_in of a batch
# of eight 768x512 images, and a residual block of two 128x192 images (an
# 8x12 latent grid: tiles of 8x16 pixels past the grid's edge).
CONV_SHAPES = [(8, 32, 48, 960, 960), (8, 32, 48, 220, 960), (2, 8, 12, 960, 960)]


def _conv_inputs(shape, device, seed=0):
    n, h, w, cin, cout = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n, h, w, cin, generator=gen, device=device)
    weight = torch.randn(cout, cin, 3, 3, generator=gen, device=device) / (9 * cin) ** 0.5
    return x, weight


@pytest.mark.parametrize("shape", CONV_SHAPES, ids=["residual", "conv_in", "ragged"])
def test_conv3x3_kernel_is_as_near_float64_as_cudnn(cuda, shape):
    """The kernel's largest error against the float64 convolution is within
    2x of cuDNN's float32 (TF32 off), whose sums round to nearest on the
    CUDA cores; the twin on the card is that cuDNN call."""
    x, weight = _conv_inputs(shape, cuda)
    with torch.inference_mode():
        before = conv3x3.launches
        got = conv3x3(x, weight)
        assert conv3x3.launches == before + 1
        assert got.shape == shape[:3] + (shape[4],) and got.is_contiguous()
        want = conv3x3_reference(x.double(), weight.double())
        cudnn = conv3x3_reference(x, weight)
        err = (got.double() - want).abs().max().item()
        cudnn_err = (cudnn.double() - want).abs().max().item()
    assert err <= 2 * cudnn_err, (err, cudnn_err)


def test_conv3x3_rows_are_the_same_alone_as_in_a_batch(cuda):
    """An image's output is bit-equal alone and in a batch of 8, and on a
    second run."""
    x, weight = _conv_inputs(CONV_SHAPES[0], cuda, seed=1)
    with torch.inference_mode():
        batch = conv3x3(x, weight)
        assert torch.equal(conv3x3(x, weight), batch)
        for i in (0, 3, 7):
            assert torch.equal(conv3x3(x[i:i + 1].contiguous(), weight)[0], batch[i])


def test_conv3x3_follows_a_changed_weight(cuda):
    """The weight's TF32 split is kept while the weight is unchanged; an
    in-place change of the weight is never served from the old split."""
    x, weight = _conv_inputs((2, 8, 12, 64, 36), cuda, seed=2)
    weight = torch.nn.Parameter(weight)
    with torch.inference_mode():
        first = conv3x3(x, weight)
    with torch.no_grad():
        weight.mul_(-0.5)
    with torch.inference_mode():
        second = conv3x3(x, weight)
        want = conv3x3_reference(x.double(), weight.double())
    torch.testing.assert_close(second.double(), want, rtol=0, atol=1e-5)
    torch.testing.assert_close(second, -0.5 * first, rtol=1e-5, atol=1e-6)


def test_conv3x3_rejects_what_it_cannot_take(cuda):
    x, weight = _conv_inputs((1, 4, 4, 8, 12), cuda)
    with pytest.raises(TypeError):
        conv3x3(x.double(), weight.double())
    with pytest.raises(ValueError):
        conv3x3(x.permute(0, 2, 1, 3), weight)  # not contiguous
    with pytest.raises(ValueError):
        conv3x3(x[..., :6].contiguous(), weight[:, :6].contiguous())  # cin 6
    with pytest.raises(ValueError):
        conv3x3(x, weight.cpu())


def test_conv3x3_launches_on_the_codec_paths(cuda):
    """hific-mi's device-coded codec on 2 images of 96x130 launches the
    kernel 19 times a decoded batch (conv_in and 9 residual blocks' two) and
    none a compressed one; a bmshj2018 round trip launches it 0 times."""
    gpu = hific.Codec(hific.HificModel(hific.get_config("hific-mi"), seed=3), device=cuda)
    images = (np.random.RandomState(8).rand(2, 96, 130, 3) * 255).astype(np.uint8)
    before = conv3x3.launches
    blobs = gpu.compress_batch(images, coder="device")
    assert conv3x3.launches == before
    gpu.decompress_batch(blobs)
    assert conv3x3.launches == before + 19
    codec = bmshj2018.Codec(bmshj2018.load_model(CKPT), device=cuda)
    codec.decompress_batch(codec.compress_batch(images, coder="device"))
    assert conv3x3.launches == before + 19


@pytest.mark.parametrize("coder", ["host", "device"])
def test_cli_round_trip_on_card_equals_the_codec_api(cuda, coder, tmp_path, monkeypatch):
    """`tfci compress` / `tfci decompress` on the card (the trained
    checkpoint in a model directory under its registry name) write the
    bytes and the image the Codec API gives on the same table file."""
    import shutil

    from compression_tpu_torch.cli.tfci import main
    from compression_tpu_torch.entropy_models.continuous_base import load_tables
    from compression_tpu_torch.util import image as image_util

    models = tmp_path / "models"
    models.mkdir()
    ckpt = models / "bmshj2018-hyperprior.msgpack"
    shutil.copy(CKPT, ckpt)
    monkeypatch.setenv("TPC_MODEL_DIR", str(models))
    monkeypatch.delenv("TPC_TINY_MODELS", raising=False)
    monkeypatch.delenv("TPC_TABLE_CACHE_FILE", raising=False)
    yy, xx = np.mgrid[0:128, 0:192].astype(np.float32)
    image = np.stack([xx / 192 * 255, yy / 128 * 255, (xx + yy) % 64 * 4], -1).astype(np.uint8)
    png, tfci, out = (str(tmp_path / n) for n in ("in.png", "a.tfci", "out.png"))
    image_util.write_png(png, image)
    flags = ["--device-coder"] if coder == "device" else []
    assert main(["compress", "bmshj2018-hyperprior", png, tfci, *flags]) == 0
    assert main(["decompress", tfci, out]) == 0
    st = ckpt.stat()
    tables = load_tables(f"{ckpt}.{st.st_mtime_ns}.{st.st_size}.tables.npz")
    codec = bmshj2018.Codec(bmshj2018.load_model(CKPT), device=cuda, tables=tables)
    blob = codec.compress(image, coder)
    assert open(tfci, "rb").read() == blob
    np.testing.assert_array_equal(image_util.read_png(out), codec.decompress(blob))


# -- the rest of the library (chip_smoke.py phase 15 at a small size) ---------


def _rel(got, want):
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def test_universal_indexed_on_card_matches_cpu(cuda, monkeypatch):
    from compression_tpu_torch.distributions import NoisyNormal
    from compression_tpu_torch.entropy_models import universal

    em = universal.UniversalIndexedEntropyModel(
        lambda loc, scale: NoisyNormal(loc, scale), (64,),
        {"loc": torch.zeros_like, "scale": continuous_indexed.log_scale_fn},
        coding_rank=3, compression=True)
    assert em.tables.num_cdfs == 960
    gen = torch.Generator().manual_seed(0)
    idx = torch.rand(2, 12, 8, 24, generator=gen) * 63
    y = torch.randn(2, 12, 8, 24, generator=gen) * continuous_indexed.log_scale_fn(idx)
    noise = torch.rand(y.shape, generator=gen) - 0.5
    monkeypatch.setattr(universal, "uniform_noise", lambda t, g: noise.to(t.device, t.dtype))
    out = []
    for device in (cuda, "cpu"):
        yd = y.to(device).detach().requires_grad_()
        idd = idx.to(device).detach().requires_grad_()
        _, bits = em(yd, idd, training=True)
        bits.sum().backward()
        out.append((bits, yd.grad, idd.grad))
    for got, want in zip(*out):
        assert _rel(got, want) <= 1e-4
    strings = em.compress(y.to(cuda), idx.to(cuda))
    assert strings == em.compress(y, idx)
    y_hat = em.decompress(strings, idx.to(cuda))
    assert np.abs(y_hat - y.numpy()).max() <= 0.5 + 1e-6
    y_eval = em(y.to(cuda), idx.to(cuda), training=False)[0].cpu().numpy()
    np.testing.assert_allclose(y_eval, y_hat, atol=1e-5)


def test_universal_batched_on_card_round_trip(cuda):
    from compression_tpu_torch.entropy_models import UniversalBatchedEntropyModel

    model = bmshj2018.load_model(CKPT).to(cuda)
    em = UniversalBatchedEntropyModel(model.hyperprior(), coding_rank=3, compression=True)
    assert len(np.unique(em.tables.offset)) > 1
    z = torch.randn(2, 6, 4, 128, generator=torch.Generator().manual_seed(1)) * 3
    strings = em.compress(z.to(cuda))
    assert strings == em.compress(z)
    z_hat = em.decompress(strings, (6, 4))
    assert np.abs(z_hat - z.numpy()).max() <= 0.5 + 1e-6
    np.testing.assert_allclose(em(z.to(cuda), training=False)[0].detach().cpu().numpy(),
                               z_hat, atol=1e-5)


def test_power_law_on_card(cuda):
    from compression_tpu_torch.entropy_models import PowerLawEntropyModel

    em = PowerLawEntropyModel(coding_rank=3)
    y = torch.randn(3, 8, 6, 32, generator=torch.Generator().manual_seed(2)) * 3
    assert _rel(em.penalty(y.to(cuda)), em.penalty(y)) <= 1e-5
    strings = em.compress(y.to(cuda))
    assert strings == em.compress(y)
    np.testing.assert_array_equal(em.decompress(strings, tuple(y.shape)), np.round(y.numpy()))


def test_priors_on_card_match_cpu(cuda):
    import dataclasses

    from compression_tpu_torch.distributions import (
        Logistic,
        MixtureSameFamily,
        NoisyLogisticMixture,
        NoisySoftRoundedDeepFactorized,
        UniformNoiseAdapter,
        helpers,
    )
    from compression_tpu_torch.distributions.base import map_tensors

    @dataclasses.dataclass(frozen=True)
    class NoTails(MixtureSameFamily):
        def _lower_tail(self, tail_mass):
            return None

        def _upper_tail(self, tail_mass):
            return None

    gen = torch.Generator().manual_seed(3)
    logits, loc, scale = torch.randn(3, 192, 3, generator=gen)
    scale = torch.exp(scale * 0.5)
    priors = [
        NoisySoftRoundedDeepFactorized(alpha=5.0, generator=gen, batch_shape=(192,)),
        NoisyLogisticMixture(logits, loc * 2, scale),
        UniformNoiseAdapter(NoTails(logits, Logistic(loc * 2, scale))),
    ]
    y = torch.round(torch.randn(2, 4, 6, 192, generator=gen) * 4)
    for prior in priors:
        card = map_tensors(lambda t: t.to(cuda), prior)
        em = continuous_batched.ContinuousBatchedEntropyModel(card, coding_rank=3,
                                                              compression=True)
        want = continuous_batched.ContinuousBatchedEntropyModel(prior, coding_rank=3,
                                                                compression=True).tables
        np.testing.assert_array_equal(em.tables.cdf, want.cdf)
        for fn in (helpers.quantization_offset,
                   lambda p: helpers.lower_tail(p, em.tail_mass),
                   lambda p: helpers.upper_tail(p, em.tail_mass)):
            assert _rel(fn(card), fn(prior)) <= 1e-5
        yd = y.to(cuda).detach().requires_grad_()
        _, bits = em(yd, training=False)
        bits.sum().backward()
        assert torch.isfinite(yd.grad).all()
        cpu = continuous_batched.ContinuousBatchedEntropyModel(prior, coding_rank=3)
        assert _rel(bits, cpu(y, training=False)[1]) <= 1e-5


@pytest.mark.parametrize("kind", ["reflect_down", "separable_up", "rdft", "conv1d", "conv3d"])
def test_signal_conv_variants_on_card_match_cpu(cuda, kind):
    from compression_tpu_torch.layers import SignalConv1D, SignalConv2D, SignalConv3D

    mod, shape = {
        "reflect_down": (SignalConv2D(32, 48, 5, corr=True, strides_down=2,
                                      padding="same_reflect", use_bias=True), (2, 17, 14, 32)),
        "separable_up": (SignalConv2D(32, 2, 5, corr=False, strides_up=2, padding="same_zeros",
                                      channel_separable=True), (2, 9, 7, 32)),
        "rdft": (SignalConv2D(32, 48, 5, corr=True, strides_down=2, padding="same_zeros",
                              kernel_param="rdft"), (2, 16, 16, 32)),
        "conv1d": (SignalConv1D(32, 48, 5, corr=True, strides_down=2,
                                padding="same_reflect"), (2, 50, 32)),
        "conv3d": (SignalConv3D(32, 16, 3, corr=False, strides_up=2, padding="same_reflect"),
                   (1, 3, 5, 4, 32)),
    }[kind]
    x = torch.randn(shape, generator=torch.Generator().manual_seed(4))
    out = []
    for device in (cuda, "cpu"):
        m = mod.to(device)
        m.zero_grad(set_to_none=True)
        xd = x.to(device).detach().requires_grad_()
        y = m(xd)
        (y * y).sum().backward()
        out.append([y, xd.grad] + [p.grad for p in m.parameters()])
    for got, want in zip(*out):
        assert _rel(got, want) <= 1e-5


def test_cdf_twin_on_card_matches_cpp(cuda):
    from compression_tpu_torch.codec import pmf_to_quantized_cdf_torch

    rng = np.random.RandomState(5)
    lengths = rng.randint(2, 257, 200).astype(np.int32)
    pmf = rng.dirichlet(np.ones(300) * 0.3, 200)
    pmf[0] = 0.0
    pmf[1, :5] = [np.inf, 1.0, 0.0, -1.0, np.nan]
    for precision in (8, 12, 16):
        want = pmf_to_quantized_cdf(pmf, lengths, precision)
        got = pmf_to_quantized_cdf_torch(torch.from_numpy(pmf).to(cuda),
                                         torch.from_numpy(lengths).to(cuda), precision)
        assert got.device.type == cuda.type
        np.testing.assert_array_equal(got.cpu().numpy(), want)


def test_rows_past_256_levels_on_card(cuda):
    from compression_tpu_torch.distributions import NoisyNormal

    sigma = torch.exp(torch.rand(2, 9, 7, generator=torch.Generator().manual_seed(6)) * 8 - 3)
    for levels, dtype in ((64, torch.uint8), (300, torch.uint16), (70000, torch.int32)):
        em = continuous_indexed.LocationScaleIndexedEntropyModel(NoisyNormal, num_scales=levels)
        got = em.rows(sigma.to(cuda))
        assert got.dtype == dtype and got.device.type == cuda.type
        got, want = got.cpu().to(torch.int64).numpy(), em.rows(sigma).to(torch.int64).numpy()
        # float32 log on the card and the CPU may differ by an ulp; at 70,000
        # levels that moves an index lying within an ulp of a half level.
        frac = em.inverse_scale_fn(sigma).numpy() % 1.0
        at_half = np.abs(frac - 0.5) < 1e-2
        assert np.all((got == want) | at_half) and np.abs(got - want).max() <= 1


def test_toy_sources_on_card(cuda):
    from compression_tpu_torch.models import toy_sources as toy

    model, history = toy.train(toy.Config(hidden=16, layers=2), steps=20, batch_size=128,
                               device=cuda)
    assert history and all(np.isfinite(r) for _, r, _ in history)
    x = toy.banana(torch.Generator(device=cuda).manual_seed(1), 64)
    x_hat, strings = toy.compress_samples(model, x)
    assert x_hat.device.type == cuda.type and len(strings) == 64
    rate, dist = toy.rd_point_ecvq(toy.banana, 1.0, num_codewords=32, steps=5, eval_n=1024,
                                   device=cuda)
    assert rate > 0 and dist > 0


def test_trace_and_annotate_on_card(cuda, tmp_path):
    from compression_tpu_torch.util.profiling import annotate, trace

    with trace(str(tmp_path)) as prof:
        with annotate("library"):
            (torch.randn(256, 256, device=cuda) @ torch.randn(256, 256, device=cuda)).sum()
        torch.cuda.synchronize()
    text = (tmp_path / "trace.json").read_text()
    assert "library" in text
    assert any(e.device_type.name == "CUDA" for e in prof.events())


def test_a_launch_goes_to_the_span_open_on_its_thread(cuda):
    """Kernels launched inside spans on two worker threads that live one
    after the other (the second may get the first's pthread ident), on the
    main thread, and by autograd's device thread under the main thread's
    span, are each attributed to that span by the benchmark's join of device
    activities to the runtime calls that launched them."""
    import threading
    import time

    from torch.profiler import ProfilerActivity, profile

    from benchmark import spans as bench_spans
    from compression_tpu_torch.util.profiling import recording, span

    x = torch.randn(1024, 1024, device=cuda)
    w = torch.randn(1024, 1024, device=cuda, requires_grad=True)
    torch.cuda.synchronize()

    def work(name):
        with span(name):
            for _ in range(3):
                (x * 2.0).sin()
            torch.cuda.synchronize()
    with recording() as spans, profile(activities=[ProfilerActivity.CPU,
                                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.time_ns()
        with span("main/forward"):
            loss = (x @ w).cos().sum()
        for name in ("worker/a", "worker/b"):
            t = threading.Thread(target=work, args=(name,))
            t.start()
            t.join(timeout=60)
            assert not t.is_alive()
        with span("main/backward"):
            loss.backward()
        torch.cuda.synchronize()
        t1 = time.time_ns()
    main = threading.get_native_id()
    got = bench_spans.by_span(prof, spans, {"all": (t0, t1)}, main)
    device = got["all"]["device"]
    activities, launches = bench_spans.join(prof)
    seen = [(start - t0, corr, launches.get(corr)) for start, _, corr in activities
            if t0 <= start < t1]
    assert set(device) == {"main/forward", "worker/a", "worker/b", "main/backward"}, (
        device, main, [(s.name, s.start_ns - t0, s.end_ns - t0, s.thread, s.pthread)
                       for s in spans], seen)
    assert all(v > 0 for v in device.values())


# -- the multi-device layer, 4 shards of one card -------------------------------


def _card_mesh(cuda, n=4):
    from compression_tpu_torch.parallel.data_parallel import Mesh

    return Mesh((torch.device("cuda", torch.cuda.current_device()),) * n)


def test_dp_step_on_card_matches_cpu(cuda):
    """A 4-shard quantized (training=False) data-parallel step of a C = 32
    model on one card against the same step over 4 CPU shards: loss 1e-4
    relative, every mean gradient 1e-3 relative plus 1e-3 of its largest
    entry (test_train_step_on_card_matches_cpu's tolerance); K1 6 launches a
    shard."""
    from compression_tpu_torch.parallel import make_dp_step, make_mesh
    from compression_tpu_torch.parallel.data_parallel import shard_generators

    cfg = bmshj2018.Config(num_filters=32, num_latents=32, num_hyperlatents=32)
    x = torch.from_numpy(np.random.RandomState(0).rand(4, 128, 128, 3).astype(np.float32))
    out = []
    for mesh in (make_mesh(4, device="cpu"), _card_mesh(cuda)):
        model = bmshj2018.BMSHJ2018Model(cfg, seed=3).to(mesh.devices[0])
        step = make_dp_step(lambda m, b, g: bmshj2018.make_loss_fn(m, training=False)(b, g),
                            torch.optim.SGD(model.parameters(), lr=1e-3), mesh=mesh)
        before = fused_gdn.launches
        metrics = step(model, x, shard_generators(0, mesh))
        out.append((metrics["loss"].item(), fused_gdn.launches - before,
                    {n: p.grad.cpu() for n, p in model.named_parameters()}))
    (loss_cpu, k1_cpu, g_cpu), (loss_gpu, k1_gpu, g_gpu) = out
    assert (k1_cpu, k1_gpu) == (0, 24)
    np.testing.assert_allclose(loss_gpu, loss_cpu, rtol=1e-4)
    for n in g_cpu:
        torch.testing.assert_close(g_gpu[n], g_cpu[n], rtol=1e-3,
                                   atol=1e-3 * g_cpu[n].abs().max().item(), msg=n)


def test_spatial_codec_on_four_shards_of_the_card(cuda):
    """bmshj2018 from the checkpoint, one 512x768 image over 4 shards of
    the card: K1 3 launches a shard a transform pass (12 a compress), the
    standard host blob decoded twice to the same image, y within 1e-4 of
    its largest entry of the dense codec's, and the reconstruction within
    one level of the dense decode of the same blob."""
    from compression_tpu_torch.parallel.spatial import gather_rows

    model = bmshj2018.load_model(CKPT)
    image = (np.random.RandomState(5).rand(512, 768, 3) * 255).astype(np.uint8)
    mesh = _card_mesh(cuda)
    sc = bmshj2018.SpatialCodec(model, mesh)
    before = fused_gdn.launches
    blob = sc.compress(image)
    assert fused_gdn.launches == before + 12
    out = sc.decompress(blob)
    np.testing.assert_array_equal(sc.decompress(blob), out)
    assert out.shape == image.shape and len(PackedTensors(blob).describe()) == 5
    x = torch.from_numpy(image[None]).to(mesh.devices[0]).float() / 255.0
    with torch.inference_mode():
        y = gather_rows(bmshj2018.sharded_analyze(sc.model, x, mesh))
        want = sc.model.analysis(x)
    torch.testing.assert_close(y, want, rtol=0, atol=1e-4 * want.abs().max().item())
    dense = sc.codec.decompress(blob)
    assert np.abs(dense.astype(np.int16) - out.astype(np.int16)).max() <= 1


def test_sharded_charm_decode_on_card_is_byte_equal(cuda):
    """A 32-filter ms2020 (40 latents in 10 slices) over 4 shards of the
    card, 6 images (padded to 8): byte-equal to ``Codec.decompress_batch``
    with both coders; K2 once a slice a shard on device-coded blobs."""
    from compression_tpu_torch.parallel import ShardedCharmCodec

    cfg = ms2020.Config(num_filters=32, num_latents=40, num_hyperlatents=32)
    model = ms2020.MS2020Model(cfg, seed=1)
    codec = ms2020.make_codec(model, torch.device("cuda", torch.cuda.current_device()))
    images = (np.random.RandomState(8).rand(6, 128, 192, 3) * 255).astype(np.uint8)
    sharded = ShardedCharmCodec(model, _card_mesh(cuda))
    for coder in ("host", "device"):
        blobs = codec.compress_batch(images, coder=coder)
        before = rans.rans_decode.launches
        out = sharded.decompress_batch(blobs)
        launched = rans.rans_decode.launches - before
        assert launched == (4 * cfg.num_slices if coder == "device" else 0)
        np.testing.assert_array_equal(out, codec.decompress_batch(blobs))
