"""Tests of the port that need the card: the CUDA kernels (K1 fused GDN at
any width up to 192, K3/K2 rANS encode/decode) against their plain twins, K1
under autograd, the codecs on the card (bmshj2018 with either coder,
bls2017 in both archs, mbt2018 with either coder, b2018 at 192 filters,
ms2020 and HiFiC at full width with either coder), and training steps
(HiFiC's joint G/D step among them), against the CPU path. They skip without a GPU. This file imports neither JAX nor the JAX package, so on a machine
without JAX run it alone, without the suite's conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import pathlib

import numpy as np
import pytest
import torch

from compression_tpu_torch import convert
from compression_tpu_torch.codec import pmf_to_quantized_cdf, rans, rans_ref
from compression_tpu_torch.entropy_models.continuous_base import CdfTables
from compression_tpu_torch.layers import fused_gdn, fused_gdn_reference, parameters
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
    not held to the CPU's float32). No kernel of the port launches in a
    training step."""
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
        counts = (fused_gdn.launches, rans.rans_encode.launches, rans.rans_decode.launches)
        metrics = step(x.to(device, dtype), None)
        assert queue == []
        assert (fused_gdn.launches, rans.rans_encode.launches,
                rans.rans_decode.launches) == counts
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
