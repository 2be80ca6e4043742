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


def _tables(rng, R=6, max_syms=24, full_mass_row=False, precision=P):
    """Random quantized CDF rows (escape symbol last), as the JAX tests
    build them; optionally row 0 is the degenerate full-mass row."""
    rows, lengths = [], []
    for _ in range(R):
        n = rng.randint(2, max_syms)  # n symbols incl. the escape symbol
        rows.append(pmf_to_quantized_cdf(rng.rand(n) ** 2 + 1e-3, precision))
        lengths.append(n + 1)
    if full_mass_row:
        rows[0], lengths[0] = np.array([0, 1 << precision, 1 << precision]), 3
    cdf = np.zeros((R, max(len(c) for c in rows)), np.int32)
    for r, c in enumerate(rows):
        cdf[r, : len(c)] = c
    return CdfTables(
        cdf=cdf,
        cdf_length=np.array(lengths, np.int32),
        cdf_offset=rng.randint(-20, 20, R).astype(np.int32),
        offset=np.zeros(R),
        precision=precision,
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


def test_full_mass_row_at_precision_15():
    """At P = 15 a full-mass row's f = 2^15 fills bit 31 of its packed
    f|c. The port reads it unsigned and writes the NumPy spec's stream,
    which it decodes. The JAX coder sign-extends f there (its exact divide
    then leaves its domain, d <= 2^15): its stream differs from the spec's
    and it cannot decode the spec's (a fault of the reference)."""
    rng = np.random.RandomState(15)
    tables = _tables(rng, R=4, full_mass_row=True, precision=15)
    vals, rows = _elements(rng, tables, (2, 300), escape_frac=0.25, full_mass_row=True)
    K, cap = 16, 3 * 300 + 2 * 16 + 8
    words, lengths, _ = _encode(tables, K, cap, vals, rows)
    for b in range(2):
        assert words[b, : lengths[b]].tobytes() == rans_ref.rans_encode(
            vals[b], rows[b], tables, K)
    out, ok = _decode(tables, K, 300, words, rows)
    assert ok.all()
    np.testing.assert_array_equal(out, vals)
    assert not np.array_equal(_jax_encode(tables, K, cap, vals, rows)[0], words)
    assert not _jax_decode(tables, K, 300, words, rows)[1].all()


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


# -- the kernels' decompositions, emulated in numpy ------------------------


@pytest.fixture(scope="module")
def main_tables():
    """The main (y) tables: 64 rows at precision 12, as the checkpoint's
    codec builds them."""
    return JaxLocScale(JaxNoisyNormal, coding_rank=3)._em.build_tables()


def _blob_parts(t):
    """The table blob of ``csrc/rans.cu``: row info, f|c, buckets."""
    blob = t.blob.numpy()
    info = blob[: t.fc_words].reshape(-1, 4).astype(np.int64)
    fcr = blob[t.fc_words: t.bucket_words].view(np.uint32).astype(np.int64)
    nb = 1 << (t.precision - t.bucket_bits)
    words = blob.view(np.uint16)
    bucket = words[2 * t.bucket_words: 2 * t.bucket_words + t.num_rows * nb]
    return info, fcr, bucket.reshape(t.num_rows, nb).astype(np.int64)


def _emulate_encode(t, vals, rows, K, cap):
    """K3 as ``csrc/rans.cu`` splits it: (1) every lane walks its steps on
    its own, reading the blob's row info and f|c, and records its three
    candidate words and its two flags a step; (2) word positions from the
    flags alone (head, then per step main / payload-lo / payload-hi words in
    ascending lane order, a step starting after the words of the steps
    before it) and the cut at cap."""
    L, M16, M32 = 1 << 16, 0xFFFF, 0xFFFFFFFF
    Pt = t.precision
    info, fcr, _ = _blob_parts(t)
    B, N = vals.shape
    T = -(-N // K)
    out = np.zeros((B, cap), np.uint16)
    lengths = np.zeros(B, np.int32)
    for b in range(B):
        r = np.clip(rows[b].astype(np.int64), 0, t.num_rows - 1)
        start, E, off = info[r, 0], info[r, 1], info[r, 2]
        s = ((vals[b].astype(np.int64) - off + (1 << 31)) & M32) - (1 << 31)
        in_range = (s >= 0) & (s < E)
        e = np.where(s >= E, ((s - E) & M32) * 2, ((-s) & M32) * 2 - 1) & M32
        fcv = fcr[start + np.where(in_range, s, E)]

        def pad(a, fill):
            return np.concatenate([a, np.full(T * K - N, fill, a.dtype)]).reshape(T, K)

        valid, esc = pad(np.ones(N, bool), False), pad(~in_range, False)
        f, c, e = pad(fcv >> 16, 1), pad(fcv & M16, 0), pad(e, 0)
        rec = np.zeros((T, 3, K), np.uint16)  # slots: main, payload-lo, payload-hi
        em = np.zeros((T, K), bool)
        x = np.full(K, L, np.int64)
        for step in range(T - 1, -1, -1):  # phase 1: no lane looks at another
            ok, es = valid[step], esc[step]
            rec[step, 2] = x & M16
            rec[step, 1] = e[step] >> 16
            x = np.where(es, (x & ~M16 & M32) | (e[step] & M16), x)
            em[step] = ok & ((x >> (32 - Pt)) >= f[step])
            rec[step, 0] = x & M16
            x = np.where(em[step], x >> 16, x)
            fs = np.maximum(f[step], 1)
            x = np.where(ok, (((x // fs) << Pt) + x % fs + c[step]) & M32, x)
        # Phase 2: positions from the flags, then the placement.
        count = em.sum(1) + 2 * esc.sum(1)
        first = 2 * K + np.concatenate([[0], np.cumsum(count)[:-1]])
        total = 2 * K + int(count.sum())
        stream = np.zeros(total, np.uint16)
        stream[0: 2 * K: 2], stream[1: 2 * K: 2] = x >> 16, x & M16
        for step in range(T):
            pos = first[step]
            for slot, mask in ((0, em[step]), (1, esc[step]), (2, esc[step])):
                words = rec[step, slot, mask]
                stream[pos: pos + len(words)] = words
                pos += len(words)
        keep = min(total, cap)
        out[b, :keep] = stream[:keep]
        lengths[b] = total
    return out, lengths, lengths > cap


@pytest.mark.parametrize("cap", [1, 40, 120, None])
@pytest.mark.parametrize("K", [4, 16, 128])
@pytest.mark.parametrize("which", ["main", "synthetic"])
def test_encoder_decomposition_matches_jax(main_tables, which, K, cap):
    """The lane pass + compaction of K3, emulated, is byte-equal to the JAX
    encoder (words, lengths, overflow): the checkpoint's tables and
    synthetic ones with a full-mass row, 25% escapes with two at the int32
    limits, a ragged N, and caps that cut the stream."""
    rng = np.random.RandomState(K + (cap or 0))
    tables = main_tables if which == "main" else _tables(rng, full_mass_row=True)
    N = 3 * K + 7 if K == 128 else 203
    vals, rows = _elements(rng, tables, (2, N), escape_frac=0.25,
                           full_mass_row=which == "synthetic", extremes=True)
    cap = cap or 3 * N + 2 * K + 64
    got = _emulate_encode(rans.RansTables(tables), vals, rows, K, cap)
    want = _jax_encode(tables, K, cap, vals, rows)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _emulate_lookup(t, slots):
    """K2's symbol lookup on the blob, for every row at once: the bucket's
    first symbol, then forward while the next entry's c is <= the slot.
    Returns the symbols [R, len(slots)] and the search steps taken."""
    info, fcr, bucket = _blob_parts(t)
    start = info[:, :1]
    m = bucket[:, slots >> t.bucket_bits]
    steps = np.zeros_like(m)
    while True:
        more = (fcr[start + m + 1] & 0xFFFF) <= slots
        if not more.any():
            return m, fcr[start + m], steps
        m, steps = m + more, steps + more


@pytest.mark.parametrize("bits", [2, 3, 4])
@pytest.mark.parametrize("which", ["main", "full_mass", "p15", "p4"])
def test_decoder_tables_give_the_slot_table(main_tables, which, bits):
    """For every (row, slot), the ragged f|c, its row starts and the slot
    buckets (of 2^bits slots) give slot2sym's symbol and fc's entry; row
    info gives the escape and offset."""
    rng = np.random.RandomState(len(which))
    tables = {
        "main": lambda: main_tables,
        "full_mass": lambda: _tables(rng, R=9, full_mass_row=True),
        "p15": lambda: _tables(rng, R=5, max_syms=300, full_mass_row=True, precision=15),
        "p4": lambda: _tables(rng, R=4, max_syms=6, full_mass_row=True, precision=4),
    }[which]()
    t = rans.RansTables(tables, bucket_bits=bits)
    slots = np.arange(1 << t.precision)
    m, fcv, steps = _emulate_lookup(t, slots)
    np.testing.assert_array_equal(m, t.slot2sym.numpy())
    want_fc = np.take_along_axis(t.fc.numpy().astype(np.int64) & 0xFFFFFFFF, m, 1)
    np.testing.assert_array_equal(fcv, want_fc)
    info = _blob_parts(t)[0]
    np.testing.assert_array_equal(info[:, 1], t.escape.numpy())
    np.testing.assert_array_equal(info[:, 2], t.cdf_offset.numpy())
    assert steps.max() < 1 << t.bucket_bits  # the search stays in its bucket
    # The jax package's (padded) tables say the same.
    theirs = jax_rans.RansTables(tables)
    np.testing.assert_array_equal(m, np.asarray(theirs.slot2sym))


def test_decoder_variant_budget(main_tables):
    """K2 holds the blob in shared memory when it fits beside the rings
    (512 + 16,384 + 32,768 bytes) in a block's 232,448 bytes, else reads it
    through L1; rows that are not well-formed CDFs have no blob."""
    t = rans.RansTables(main_tables)
    assert t.table_bytes == 118_624 and rans.decode_variant(t) == "on_chip"
    rng = np.random.RandomState(1)
    big = rans.RansTables(_tables(rng, R=48, max_syms=40, precision=15))
    # 48 rows of 4,096 two-byte buckets alone are 393,216 bytes.
    assert big.table_bytes > 232_448 - 49_664
    assert rans.decode_variant(big) == "global"
    for R in range(1, 64):  # the rule is exactly the byte count
        sized = rans.RansTables(_tables(np.random.RandomState(R), R=R, max_syms=8,
                                        precision=14))
        fits = 49_664 + sized.table_bytes <= 232_448
        assert rans.decode_variant(sized) == ("on_chip" if fits else "global")
        words = -(-(4 * R + int(sized.escape.sum()) + 2 * R) // 4) * 4  # row info, f|c
        words += R * (1 << (14 - sized.bucket_bits)) // 2  # two-byte buckets
        assert sized.table_bytes == 4 * -(-words // 4) * 4
    bad = _tables(rng)
    bad.cdf[2, int(bad.cdf_length[2]) - 1] -= 1  # no longer reaches 2^P
    assert rans.RansTables(bad).blob is None
    with pytest.raises(ValueError, match="well-formed"):
        rans.decode_variant(bad)

