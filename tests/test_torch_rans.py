"""The port's device rANS coder against the JAX package's: the plain twins of
the kernels K3 (encode) and K2 (decode), the port's copy of the NumPy spec,
the table bundle, the lane-count rule and the blob plumbing. The same numpy
inputs, made from a seed, go through both packages; integers must be equal
(no tolerance)."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compression_tpu.codec import rans as jax_rans
from compression_tpu.codec import rans_ref as jax_rans_ref
from compression_tpu.codec._numpy_ref import pmf_to_quantized_cdf
from compression_tpu.distributions.uniform_noise import NoisyNormal as JaxNoisyNormal
from compression_tpu.entropy_models import LocationScaleIndexedEntropyModel as JaxLocScale
from compression_tpu.entropy_models.continuous_base import CdfTables
from compression_tpu.models import device_coding as jax_dc
from compression_tpu_torch.codec import rans, rans_ref
from compression_tpu_torch.distributions import NoisyNormal
from compression_tpu_torch.entropy_models import LocationScaleIndexedEntropyModel
from compression_tpu_torch.models import device_coding as dc

torch.set_num_threads(1)

P = 12
FULL_MASS = [0, 1 << P, 1 << P]  # one symbol owns all 2^P slots; no escape mass


def _tables(rng, R=6, max_syms=24, full_mass_row=False):
    """Random quantized CDF rows (escape symbol last), as the JAX tests
    build them; optionally row 0 is the degenerate full-mass row."""
    rows, lengths = [], []
    for _ in range(R):
        n = rng.randint(2, max_syms)  # n symbols incl. the escape symbol
        rows.append(pmf_to_quantized_cdf(rng.rand(n) ** 2 + 1e-3, P))
        lengths.append(n + 1)
    if full_mass_row:
        rows[0], lengths[0] = np.array(FULL_MASS), 3
    cdf = np.zeros((R, max(len(c) for c in rows)), np.int32)
    for r, c in enumerate(rows):
        cdf[r, : len(c)] = c
    return CdfTables(
        cdf=cdf,
        cdf_length=np.array(lengths, np.int32),
        cdf_offset=rng.randint(-20, 20, R).astype(np.int32),
        offset=np.zeros(R),
        precision=P,
    )


def _elements(rng, tables, shape, escape_frac=0.1, full_mass_row=False,
              extremes=False):
    """int32 values and rows. With ``extremes`` the first two elements are
    escapes at the int32 limits, where the coder's u32 payload arithmetic
    wraps as XLA's does (the NumPy spec computes in int64 and differs
    there, so spec comparisons leave them out)."""
    rows = rng.randint(0, tables.num_cdfs, shape).astype(np.int32)
    lo = tables.cdf_offset[rows].astype(np.int64)
    n_sym = tables.cdf_length[rows] - 2
    wide = rng.randint(-5000, 5000, shape).astype(np.int64)
    vals = np.where(
        rng.rand(*shape) < 1 - escape_frac,
        lo + (rng.rand(*shape) * np.maximum(n_sym, 1)).astype(np.int64),
        wide,
    )
    if full_mass_row:  # row 0 can only code its one symbol
        vals = np.where(rows == 0, lo, vals)
    if extremes:
        rows.flat[:2] = tables.num_cdfs - 1
        vals.flat[:2] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max]
    return vals.astype(np.int32), rows


def _jax_encode(tables, K, cap, vals, rows):
    s, n, o = jax_rans.make_rans_encoder(tables, K, cap)(
        jnp.asarray(vals), jnp.asarray(rows))
    return np.asarray(s), np.asarray(n), np.asarray(o)


def _encode(tables, K, cap, vals, rows):
    s, n, o = rans.make_rans_encoder(tables, K, cap)(
        torch.from_numpy(vals), torch.from_numpy(rows))
    assert s.dtype == torch.uint16 and n.dtype == torch.int32 and o.dtype == torch.bool
    return s.numpy(), n.numpy(), o.numpy()


def _jax_decode(tables, K, N, stream, rows):
    v, ok = jax_rans.make_rans_decoder(tables, K, N)(
        jnp.asarray(stream), jnp.asarray(rows))
    return np.asarray(v), np.asarray(ok)


def _decode(tables, K, N, stream, rows):
    v, ok = rans.make_rans_decoder(tables, K, N)(
        torch.from_numpy(np.array(stream)), torch.from_numpy(rows))
    assert v.dtype == torch.int32 and ok.dtype == torch.bool
    return v.numpy(), ok.numpy()


@pytest.mark.parametrize("N,K", [(64, 4), (1000, 16), (37, 8), (128, 128)])
def test_encoder_matches_jax_and_spec(N, K):
    rng = np.random.RandomState(N + K)
    tables = _tables(rng)
    vals, rows = _elements(rng, tables, (1, N))
    cap = 3 * N + 2 * K + 8
    got = _encode(tables, K, cap, vals, rows)
    want = _jax_encode(tables, K, cap, vals, rows)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert not got[2][0]
    words = got[0][0, : got[1][0]].tobytes()
    assert words == rans_ref.rans_encode(vals, rows, tables, K)
    assert words == jax_rans_ref.rans_encode(vals, rows, tables, K)


@pytest.mark.parametrize("N,K", [(64, 4), (1000, 16), (37, 8)])
def test_round_trip_and_cross_decode(N, K):
    rng = np.random.RandomState(2 * N + K)
    tables = _tables(rng)
    vals, rows = _elements(rng, tables, (1, N), escape_frac=0.25, extremes=True)
    cap = 3 * N + 2 * K + 8
    ours, lengths, _ = _encode(tables, K, cap, vals, rows)
    theirs, _, _ = _jax_encode(tables, K, cap, vals, rows)
    np.testing.assert_array_equal(ours, theirs)
    for stream in (ours, theirs):  # each package decodes both streams
        for decode in (_decode, _jax_decode):
            out, ok = decode(tables, K, N, stream, rows)
            assert ok.all()
            np.testing.assert_array_equal(out, vals)


def test_batched_streams_are_independent_with_uint8_rows():
    rng = np.random.RandomState(77)
    tables = _tables(rng)
    N, K, B = 256, 16, 4
    vals, rows = _elements(rng, tables, (B, N), escape_frac=0.25)
    cap = 3 * N + 2 * K + 8
    ours = _encode(tables, K, cap, vals, rows)
    narrow = _encode(tables, K, cap, vals, rows.astype(np.uint8))
    want = _jax_encode(tables, K, cap, vals, rows)
    for g, n, w in zip(ours, narrow, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(n, w)
    out, ok = _decode(tables, K, N, ours[0], rows.astype(np.uint8))
    assert ok.all()
    np.testing.assert_array_equal(out, vals)
    for b in range(B):  # each image's stream equals its solo encode
        solo = rans_ref.rans_encode(vals[b], rows[b], tables, K)
        assert ours[0][b, : ours[1][b]].tobytes() == solo


@pytest.mark.parametrize("full_mass", ["exact", "pmf"])
def test_degenerate_full_mass_row(full_mass):
    """A row whose one symbol owns all 2^P slots (f = 2^P: the push is an
    identity and emits nothing; the f << (32-P) trap), and the JAX test's
    near-full row (4095:1)."""
    rng = np.random.RandomState(11)
    if full_mass == "exact":
        tables = _tables(rng, R=3, full_mass_row=True)
        vals, rows = _elements(rng, tables, (2, 300), escape_frac=0.25,
                               full_mass_row=True)
        rows[:, :100] = 0
        vals[:, :100] = tables.cdf_offset[0]
    else:
        cdf = pmf_to_quantized_cdf(np.array([4095.0, 1.0]), P)[None].astype(np.int32)
        tables = CdfTables(cdf=cdf, cdf_length=np.array([3], np.int32),
                           cdf_offset=np.array([0], np.int32),
                           offset=np.zeros(1), precision=P)
        vals, rows = np.zeros((2, 300), np.int32), np.zeros((2, 300), np.int32)
    K = 8
    cap = 3 * 300 + 2 * K + 8
    ours = _encode(tables, K, cap, vals, rows)
    want = _jax_encode(tables, K, cap, vals, rows)
    for g, w in zip(ours, want):
        np.testing.assert_array_equal(g, w)
    out, ok = _decode(tables, K, 300, ours[0], rows)
    assert ok.all()
    np.testing.assert_array_equal(out, vals)
    assert ours[0][0, : ours[1][0]].tobytes() == rans_ref.rans_encode(
        vals[0], rows[0], tables, K)


@pytest.mark.parametrize("cap", [1, 40, 120])
def test_too_small_cap_overflows_like_jax(cap):
    rng = np.random.RandomState(cap)
    tables = _tables(rng)
    N, K = 200, 8
    vals, rows = _elements(rng, tables, (3, N), escape_frac=0.25, extremes=True)
    got = _encode(tables, K, cap, vals, rows)
    want = _jax_encode(tables, K, cap, vals, rows)
    for g, w in zip(got, want):  # buffer (the kept tail), lengths, flags
        np.testing.assert_array_equal(g, w)
    assert got[2].all() and (got[1] > cap).all()


def test_corrupt_streams_give_jax_ok_flags():
    rng = np.random.RandomState(5)
    tables = _tables(rng)
    N, K = 500, 16
    vals, rows = _elements(rng, tables, (1, N), escape_frac=0.25, extremes=True)
    cap = 3 * N + 2 * K + 8
    stream, lengths, _ = _encode(tables, K, cap, vals, rows)
    length = int(lengths[0])
    bad = []
    for pos in (0, 2 * K - 1, 2 * K + 5, length // 2, length - 1):
        s = stream.copy()
        s[0, pos] ^= 0x5A5A
        bad.append(s)
    bad.append(stream[:, : length // 2].copy())  # truncated: reads clip
    flags = []
    for s in bad:
        out, ok = _decode(tables, K, N, s, rows)
        jout, jok = _jax_decode(tables, K, N, s, rows)
        np.testing.assert_array_equal(ok, jok)
        np.testing.assert_array_equal(out, jout)
        flags.append(bool(ok[0]))
    assert not all(flags) and not flags[-1]


def test_rans_tables_equal_jax_on_the_main_tables():
    jax_tables = JaxLocScale(JaxNoisyNormal, coding_rank=3)._em.build_tables()
    ours = rans.RansTables(
        LocationScaleIndexedEntropyModel(NoisyNormal, coding_rank=3)._em.build_tables())
    theirs = jax_rans.RansTables(jax_tables)
    assert ours.slot2sym.shape == (64, 1 << 12)
    for name in ("fc", "slot2sym", "escape", "cdf_offset"):
        got, want = getattr(ours, name), np.asarray(getattr(theirs, name))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    assert (ours.num_rows, ours.maxlen, ours.precision) == (
        theirs.num_rows, theirs.maxlen, theirs.precision)
    with pytest.raises(ValueError, match="precision <= 15"):
        rans.RansTables(CdfTables(cdf=jax_tables.cdf, cdf_length=jax_tables.cdf_length,
                                  cdf_offset=jax_tables.cdf_offset,
                                  offset=jax_tables.offset, precision=16))


@pytest.mark.parametrize("cap_k", [None, "1", "2", "32"])
def test_rans_for_picks_jax_lanes_and_capacity(monkeypatch, cap_k):
    if cap_k is None:
        monkeypatch.delenv("TPC_RANS_K", raising=False)
    else:
        monkeypatch.setenv("TPC_RANS_K", cap_k)
    tables = _tables(np.random.RandomState(0))
    for N in (294_912, 4096, 100, 37, 1):
        ours = types.SimpleNamespace(em=types.SimpleNamespace(tables=tables))
        theirs = types.SimpleNamespace(em=types.SimpleNamespace(tables=tables))
        got, want = dc.rans_for(ours, N), jax_dc.rans_for(theirs, N)
        assert got[2:] == want[2:], (N, got[2:], want[2:])
        assert dc.rans_for(ours, N) is got  # cached per (N, K)
        assert dc.rans_for(ours, N, 4)[2:] == (4, 3 * N + 8 + 64)
    if cap_k is None:
        assert dc.rans_for(ours, 294_912)[2:] == (128, 885_056)


def test_spec_copy_matches_the_jax_spec():
    rng = np.random.RandomState(9)
    tables = _tables(rng, full_mass_row=True)
    np.testing.assert_array_equal(
        rans_ref.build_slot_table(tables.cdf, tables.cdf_length, P),
        jax_rans_ref.build_slot_table(tables.cdf, tables.cdf_length, P))
    vals, rows = _elements(rng, tables, (300,), escape_frac=0.3, full_mass_row=True)
    for K in (1, 3, 16):
        data = rans_ref.rans_encode(vals, rows, tables, K)
        assert data == jax_rans_ref.rans_encode(vals, rows, tables, K)
        np.testing.assert_array_equal(
            rans_ref.rans_decode(data, rows, tables, K, len(vals)), vals)
    with pytest.raises(ValueError, match="integrity"):
        rans_ref.rans_decode(data[: len(data) // 4 * 2], rows, tables, 16, len(vals))


def test_wrappers_take_the_twin_for_cpu_tensors_only():
    rng = np.random.RandomState(3)
    tables = _tables(rng)
    vals, rows = _elements(rng, tables, (2, 90))
    t = rans.RansTables(tables)
    before = (rans.rans_encode.launches, rans.rans_decode.launches)
    v, r = torch.from_numpy(vals), torch.from_numpy(rows)
    stream, lengths, overflow = rans.rans_encode(t, v, r, 8, 400)
    want = rans.rans_encode_reference(t, v, r, 8, 400)
    for g, w in zip((stream, lengths, overflow), want):
        assert torch.equal(g, w)
    out, ok = rans.rans_decode(t, stream, r, 8, 90)
    assert ok.all() and torch.equal(out, v)
    assert (rans.rans_encode.launches, rans.rans_decode.launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        rans.rans_encode(t, v.to("meta"), r.to("meta"), 8, 400)
    with pytest.raises(ValueError, match="unsupported device"):
        rans.rans_decode(t, stream.to("meta"), r.to("meta"), 8, 90)


def test_stream_helpers_match_jax():
    rng = np.random.RandomState(4)
    words = [rng.randint(0, 1 << 16, n).astype(np.uint16) for n in (5, 1500, 700)]
    np.testing.assert_array_equal(dc.pad_words(words), jax_dc.pad_words(words))
    assert dc.pad_words(words).shape == (3, 2048)
    padded = dc.pad_words(words)
    lengths = np.array([5, 1500, 700], np.int32)
    assert dc.fetch_streams(torch.from_numpy(padded), lengths) == jax_dc.fetch_streams(
        jnp.asarray(padded), lengths) == [w.tobytes() for w in words]
