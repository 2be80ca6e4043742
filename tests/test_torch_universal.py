"""The port's universal-quantization entropy models against the JAX
package's: CDF tables (the batched model's per-channel dither, the indexed
model's 15-level tiles, one and two index dimensions), range-coder strings
with the tables pinned, decoded across the packages both ways, the eval
path on the codec grid, and the expected gradients (at the reference test's
rtol 1e-4, atol 1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compression_tpu import entropy_models as jem
from compression_tpu.distributions.deep_factorized import DeepFactorized as JaxDF
from compression_tpu.ops.math_ops import perturb_and_apply
from compression_tpu.distributions.uniform_noise import (
    NoisyNormal as JaxNoisyNormal,
    UniformNoiseAdapter as JaxUNA,
)
from compression_tpu_torch import entropy_models as em
from compression_tpu_torch.distributions import (
    DeepFactorized,
    NoisyNormal,
    UniformNoiseAdapter,
)
from compression_tpu_torch.entropy_models import universal

torch.set_num_threads(1)

GRAD_TOL = dict(rtol=1e-4, atol=1e-6)  # tests/test_entropy_models.py:257


def _priors(channels, seed):
    jax_base = JaxDF.create(jax.random.PRNGKey(seed), batch_shape=(channels,))
    leaves = [tuple(torch.from_numpy(np.array(a)) for a in f)
              for f in (jax_base.matrices, jax_base.biases, jax_base.factors)]
    return JaxUNA(jax_base), UniformNoiseAdapter(DeepFactorized(*leaves))


def _assert_tables_equal(got, want):
    np.testing.assert_array_equal(got.cdf, want.cdf)
    np.testing.assert_array_equal(got.cdf_length, want.cdf_length)
    np.testing.assert_array_equal(got.cdf_offset, want.cdf_offset)
    np.testing.assert_array_equal(got.offset, want.offset)
    assert got.precision == want.precision


def _scale_fns(jnp_or_torch, a=-1.0, b=0.5):
    lib = jnp_or_torch
    return {"loc": lambda i: lib.zeros_like(i), "scale": lambda i: lib.exp(a + b * i)}


def _indexed(index_ranges=(8,), levels=5, **kw):
    """The same indexed model in both packages (NoisyNormal, scale from the
    index; with two index dimensions the second shifts the location)."""
    if len(index_ranges) == 1:
        jfns, tfns = _scale_fns(jnp), _scale_fns(torch)
    else:
        jfns = {"loc": lambda i: 0.25 * i[..., 1], "scale": lambda i: jnp.exp(-1.0 + 0.5 * i[..., 0])}
        tfns = {"loc": lambda i: 0.25 * i[..., 1], "scale": lambda i: torch.exp(-1.0 + 0.5 * i[..., 0])}
    want = jem.UniversalIndexedEntropyModel(
        lambda loc, scale: JaxNoisyNormal(loc=loc, scale=scale), index_ranges, jfns,
        coding_rank=1, num_noise_levels=levels, **kw)
    got = em.UniversalIndexedEntropyModel(
        lambda loc, scale: NoisyNormal(loc, scale), index_ranges, tfns,
        coding_rank=1, num_noise_levels=levels, **kw)
    return got, want


@pytest.mark.parametrize("levels", [4, 15])
def test_dither_and_levels_equal_jax(levels):
    from compression_tpu.entropy_models import universal as jax_universal

    idx = np.arange(100000)
    np.testing.assert_array_equal(universal._dither(idx, levels),
                                  jax_universal._dither(idx, levels))
    got, want = _indexed(levels=levels)
    np.testing.assert_array_equal(got._position_levels(4096), want._position_levels(4096))
    np.testing.assert_array_equal(got._position_dither(4096), want._position_dither(4096))


@pytest.mark.parametrize("channels,seed", [(4, 7), (3, 12)])
def test_batched_tables_and_strings_equal_jax(channels, seed):
    jax_prior, prior = _priors(channels, seed)
    want_model = jem.UniversalBatchedEntropyModel(jax_prior, coding_rank=3, compression=True)
    got_model = em.UniversalBatchedEntropyModel(prior, coding_rank=3, compression=True)
    _assert_tables_equal(got_model.tables, want_model.tables)
    assert len(np.unique(got_model.tables.offset)) > 1
    y = np.random.RandomState(6).randn(2, 5, 5, channels).astype(np.float32) * 2
    want = want_model.compress(jnp.asarray(y))
    got = got_model.compress(torch.from_numpy(y))
    assert got == want
    y_hat = got_model.decompress(want, (5, 5))
    np.testing.assert_array_equal(y_hat, np.asarray(want_model.decompress(got, (5, 5))))
    assert np.abs(y_hat - y).max() <= 0.5 + 1e-6


def test_batched_eval_path_matches_codec_grid_and_jax():
    jax_prior, prior = _priors(4, 12)
    want_model = jem.UniversalBatchedEntropyModel(jax_prior, coding_rank=3, compression=True)
    model = em.UniversalBatchedEntropyModel(prior, coding_rank=3, compression=True)
    y = np.random.RandomState(13).randn(1, 4, 4, 4).astype(np.float32) * 2
    y_eval, bits = model(torch.from_numpy(y), training=False)
    np.testing.assert_allclose(y_eval.numpy(), model.decompress(model.compress(torch.from_numpy(y)), (4, 4)), atol=1e-5)
    want_eval, want_bits = want_model(jnp.asarray(y), training=False)
    np.testing.assert_allclose(y_eval.numpy(), np.asarray(want_eval), rtol=0, atol=1e-6)
    np.testing.assert_allclose(bits.numpy(), np.asarray(want_bits), rtol=1e-5)


def test_batched_expected_grads_equal_jax_and_formula():
    jax_prior, prior = _priors(2, 11)
    y = np.asarray([0.3, -1.2])
    u = np.asarray([0.21, -0.37])
    jax_model = jem.UniversalBatchedEntropyModel(jax_prior, coding_rank=1)

    def jax_loss(yy):
        log2_p = perturb_and_apply(lambda t: jax_model._log2_prob(jax_prior, t),
                                   yy, jnp.asarray(u))
        return -jnp.sum(log2_p)

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(y)))
    model = em.UniversalBatchedEntropyModel(prior, coding_rank=1)
    yt = torch.tensor(y, requires_grad=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(universal, "uniform_noise", lambda t, g: torch.from_numpy(u))
        y_tilde, bits = model(yt, training=True)
    bits.sum().backward()
    np.testing.assert_allclose(y_tilde.detach().numpy(), y + u)
    np.testing.assert_allclose(yt.grad.numpy(), want, **GRAD_TOL)
    lp = lambda t: prior.log_prob(torch.tensor(t)).numpy() / np.log(2)  # noqa: E731
    np.testing.assert_allclose(yt.grad.numpy(), -(lp(y + 0.5) - lp(y - 0.5)), **GRAD_TOL)


def test_batched_plain_grads_without_expected_grads():
    _, prior = _priors(2, 11)
    model = em.UniversalBatchedEntropyModel(prior, coding_rank=1, expected_grads=False)
    y = torch.tensor([0.3, -1.2], requires_grad=True)
    y_tilde, bits = model(y, torch.Generator().manual_seed(0))
    bits.sum().backward()
    t = (y_tilde.detach()).requires_grad_()
    (-prior.log_prob(t) / np.log(2)).sum().backward()
    np.testing.assert_allclose(y.grad.numpy(), t.grad.numpy(), rtol=1e-6)


def test_indexed_expected_grads_flow_to_indexes_and_equal_jax(monkeypatch):
    got_model, want_model = _indexed(levels=15)
    rng = np.random.RandomState(20)
    y = rng.randn(16)
    idx = np.random.RandomState(21).uniform(1, 6, 16)
    u = rng.uniform(-0.5, 0.5, 16)
    monkeypatch.setattr(jax.random, "uniform", lambda *a, **k: jnp.asarray(u))
    monkeypatch.setattr(universal, "uniform_noise", lambda t, g: torch.from_numpy(u))

    def jax_loss(yy, ii):
        _, bits = want_model(yy, ii, rng=jax.random.PRNGKey(0), training=True)
        return jnp.sum(bits)

    want_bits = float(jax_loss(jnp.asarray(y), jnp.asarray(idx)))
    want_gy, want_gi = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(y), jnp.asarray(idx))
    yt = torch.tensor(y, requires_grad=True)
    it = torch.tensor(idx, requires_grad=True)
    _, bits = got_model(yt, it, training=True)
    bits.sum().backward()
    np.testing.assert_allclose(float(bits.sum().detach()), want_bits, rtol=1e-6)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(want_gy), **GRAD_TOL)
    np.testing.assert_allclose(it.grad.numpy(), np.asarray(want_gi), **GRAD_TOL)
    assert np.all(np.isfinite(it.grad.numpy())) and np.any(it.grad.numpy() != 0)


@pytest.mark.parametrize("index_ranges,levels", [((8,), 5), ((8,), 15), ((4, 3), 15)])
def test_indexed_tables_strings_and_cross_decode(index_ranges, levels):
    got_model, want_model = _indexed(index_ranges, levels, compression=True)
    _assert_tables_equal(got_model.tables, want_model.tables)
    assert got_model.tables.num_cdfs == int(np.prod(index_ranges)) * levels
    rng = np.random.RandomState(7)
    y = rng.randn(2, 30) * 2
    if len(index_ranges) == 1:
        idx = rng.randint(0, index_ranges[0], (2, 30)).astype(np.float64)
    else:
        idx = np.stack([rng.randint(0, r, (2, 30)) for r in index_ranges], -1).astype(np.float64)
    want = want_model.compress(jnp.asarray(y), jnp.asarray(idx))
    got = got_model.compress(torch.from_numpy(y), torch.from_numpy(idx))
    assert got == want
    y_hat = got_model.decompress(want, torch.from_numpy(idx))
    np.testing.assert_array_equal(y_hat, np.asarray(want_model.decompress(got, jnp.asarray(idx))))
    assert np.abs(y_hat - y).max() <= 0.5 + 1e-6


def test_indexed_eval_path_matches_codec_grid_and_jax():
    got_model, want_model = _indexed((6,), 4, compression=True)
    yv = np.random.RandomState(14).randn(25)
    idx = np.random.RandomState(15).randint(0, 6, 25).astype(float)
    y_eval, bits = got_model(torch.from_numpy(yv), torch.from_numpy(idx), training=False)
    y_codec = got_model.decompress(
        got_model.compress(torch.from_numpy(yv[None]), torch.from_numpy(idx[None])),
        torch.from_numpy(idx[None]))[0]
    np.testing.assert_allclose(y_eval.numpy(), y_codec, atol=1e-5)
    want_eval, want_bits = want_model(jnp.asarray(yv), jnp.asarray(idx), training=False)
    np.testing.assert_allclose(y_eval.numpy(), np.asarray(want_eval), rtol=0, atol=1e-12)
    np.testing.assert_allclose(float(bits), float(want_bits), rtol=1e-6)


def test_phase15_universal_tables_equal_jax():
    """The card's (a) model: NoisyNormal over the 64 log-spaced scales x 15
    noise levels = 960 rows."""
    from compression_tpu.entropy_models import log_scale_fn as jax_log_scale_fn

    want = jem.UniversalIndexedEntropyModel(
        lambda loc, scale: JaxNoisyNormal(loc=loc, scale=scale), (64,),
        {"loc": lambda i: jnp.zeros_like(i), "scale": jax_log_scale_fn},
        coding_rank=3, compression=True).tables
    got = em.UniversalIndexedEntropyModel(
        lambda loc, scale: NoisyNormal(loc, scale), (64,),
        {"loc": lambda i: torch.zeros_like(i), "scale": em.log_scale_fn},
        coding_rank=3, compression=True).tables
    assert got.num_cdfs == 960
    _assert_tables_equal(got, want)
