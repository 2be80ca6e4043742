"""The port's Logistic, mixtures, round / soft-round adapters, the Noisy*
constructors and the log-CDF tail fallback against the JAX package's, on
the same numpy inputs: densities, CDFs and tails in float64 at 1e-9
relative (float32 at 1e-6), integer CDF tables exactly; and the reference's
own properties (tests/test_distributions.py:101-190)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from compression_tpu import distributions as jd
from compression_tpu.distributions import helpers as jax_helpers
from compression_tpu.distributions.base import register_distribution_pytree
from compression_tpu.entropy_models import ContinuousBatchedEntropyModel as JaxBatched
from compression_tpu_torch import distributions as d
from compression_tpu_torch.distributions import helpers
from compression_tpu_torch.entropy_models import ContinuousBatchedEntropyModel

torch.set_num_threads(1)

F64 = dict(rtol=1e-9, atol=1e-12)
F32 = dict(rtol=1e-6, atol=1e-7)


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_tables_equal(got, want):
    np.testing.assert_array_equal(got.cdf, want.cdf)
    np.testing.assert_array_equal(got.cdf_length, want.cdf_length)
    np.testing.assert_array_equal(got.cdf_offset, want.cdf_offset)


def _df_pair(channels, seed=0, dtype=np.float32):
    base = jd.DeepFactorized.create(jax.random.PRNGKey(seed), (channels,),
                                    dtype=jnp.float64 if dtype == np.float64 else jnp.float32)
    port = d.DeepFactorized(*(tuple(_t(a) for a in f)
                              for f in (base.matrices, base.biases, base.factors)))
    return base, port


def _mixture_params(seed, shape=(3,), k=3):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape, k), rng.randn(*shape, k) * 2,
            np.exp(rng.uniform(-1, 1, shape + (k,))))


PAIRS = {
    "logistic": lambda: (jd.NoisyLogistic(jnp.asarray([-0.5, 1.3]), jnp.asarray([0.8, 2.0])),
                         d.NoisyLogistic(_t([-0.5, 1.3]), _t([0.8, 2.0]))),
    "normal_mixture": lambda: (jd.NoisyNormalMixture(*map(jnp.asarray, _mixture_params(1))),
                               d.NoisyNormalMixture(*map(_t, _mixture_params(1)))),
    "logistic_mixture": lambda: (jd.NoisyLogisticMixture(*map(jnp.asarray, _mixture_params(2))),
                                 d.NoisyLogisticMixture(*map(_t, _mixture_params(2)))),
    "rounded_normal": lambda: (jd.NoisyRoundedNormal(jnp.asarray([0.2, -1.1]), jnp.asarray([1.0, 3.0])),
                               d.NoisyRoundedNormal(_t([0.2, -1.1]), _t([1.0, 3.0]))),
    "soft_rounded_normal": lambda: (
        jd.NoisySoftRoundedNormal(jnp.asarray([0.2, -1.1]), jnp.asarray([1.0, 3.0]), alpha=3.0),
        d.NoisySoftRoundedNormal(_t([0.2, -1.1]), _t([1.0, 3.0]), alpha=3.0)),
    "soft_rounded_df": lambda: (
        jd.NoisySoftRoundAdapter(_df_pair(3, 4, np.float64)[0], alpha=7.0),
        d.NoisySoftRoundAdapter(_df_pair(3, 4, np.float64)[1], alpha=7.0)),
    "rounded_df": lambda: (jd.NoisyRoundAdapter(_df_pair(2, 5, np.float64)[0]),
                           d.NoisyRoundAdapter(_df_pair(2, 5, np.float64)[1])),
}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_densities_cdfs_and_grid_equal_jax(name):
    want, got = PAIRS[name]()
    assert tuple(got.batch_shape) == tuple(want.batch_shape)
    n = int(np.prod(got.batch_shape))
    y = np.linspace(-9.3, 9.7, 77)[:, None].repeat(n, 1).reshape((77,) + tuple(got.batch_shape))
    for fn in ("log_prob", "prob", "log_cdf", "log_survival_function"):
        np.testing.assert_allclose(getattr(got, fn)(_t(y)).numpy(),
                                   np.asarray(getattr(want, fn)(jnp.asarray(y))), **F64, err_msg=fn)
    for fn in ("quantization_offset", "lower_tail", "upper_tail"):
        args = () if fn == "quantization_offset" else (2.0 ** -8,)
        np.testing.assert_allclose(getattr(helpers, fn)(got, *args).numpy(),
                                   np.asarray(getattr(jax_helpers, fn)(want, *args)),
                                   rtol=1e-6, atol=1e-9, err_msg=fn)


def test_logistic_matches_scipy_and_jax():
    dist = d.Logistic(torch.tensor(-0.5, dtype=torch.float64), torch.tensor(0.8, dtype=torch.float64))
    x = np.linspace(-30, 30, 61)
    np.testing.assert_allclose(dist.log_prob(_t(x)).numpy(),
                               scipy.stats.logistic.logpdf(x, -0.5, 0.8), rtol=1e-9)
    want = jd.Logistic(jnp.asarray(-0.5), jnp.asarray(0.8))
    np.testing.assert_allclose(dist.log_prob(_t(x)).numpy(), np.asarray(want.log_prob(jnp.asarray(x))), **F64)
    np.testing.assert_allclose(dist.cdf(_t(x)).numpy(), np.asarray(want.cdf(jnp.asarray(x))), **F64)
    np.testing.assert_allclose(dist.survival_function(_t(x)).numpy(),
                               np.asarray(want.survival_function(jnp.asarray(x))), **F64)
    tm = 0.01
    np.testing.assert_allclose(d.lower_tail(dist, tm).numpy(), scipy.stats.logistic.ppf(tm / 2, -0.5, 0.8), rtol=1e-9)
    np.testing.assert_allclose(d.upper_tail(dist, tm).numpy(), scipy.stats.logistic.isf(tm / 2, -0.5, 0.8), rtol=1e-9)


def test_float32_logistic_tails_stay_float32_as_jax():
    loc = np.asarray([0.1, -2.0], np.float32)
    scale = np.asarray([0.7, 3.0], np.float32)
    want = jd.Logistic(jnp.asarray(loc), jnp.asarray(scale))
    got = d.Logistic(_t(loc), _t(scale))
    for fn in ("_lower_tail", "_upper_tail"):
        w = np.asarray(getattr(want, fn)(2.0 ** -8))
        g = getattr(got, fn)(2.0 ** -8)
        assert g.dtype == torch.float32 and w.dtype == np.float32
        np.testing.assert_allclose(g.numpy(), w, **F32)


def test_mixture_noisy_integrates_to_one():
    noisy = d.NoisyNormalMixture(logits=_t([0.0, 1.0]), loc=_t([-2.0, 2.0]), scale=_t([0.5, 1.0]))
    y = torch.linspace(-10, 10, 8001, dtype=torch.float64)
    np.testing.assert_allclose(float(torch.trapezoid(noisy.prob(y), y)), 1.0, rtol=1e-4)
    assert noisy.batch_shape == ()


def test_mixture_offset_is_weighted_component_offset():
    logits, loc, scale = _mixture_params(3)
    got = d.MixtureSameFamily(_t(logits), d.Normal(_t(loc), _t(scale)))
    w = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    np.testing.assert_allclose(got._quantization_offset().numpy(), (w * loc).sum(-1), rtol=1e-12)
    np.testing.assert_allclose(got._lower_tail(0.01).numpy(),
                               scipy.stats.norm.ppf(0.005, loc, scale).min(-1), rtol=1e-9)


def test_round_adapter_pmf():
    noisy = d.NoisyRoundAdapter(d.Normal(_t(0.2), _t(1.0)))
    for n in [-2, -1, 0, 1, 2]:
        expected = scipy.stats.norm.cdf(n + 0.5, 0.2) - scipy.stats.norm.cdf(n - 0.5, 0.2)
        np.testing.assert_allclose(float(noisy.prob(_t(float(n)))), expected, rtol=1e-5)


@pytest.mark.parametrize("alpha", [1.0, 5.0])
def test_soft_round_adapter_integrates(alpha):
    noisy = d.NoisySoftRoundedNormal(0.0, 1.0, alpha=alpha)
    y = torch.linspace(-10, 10, 8001, dtype=torch.float64)
    np.testing.assert_allclose(float(torch.trapezoid(noisy.prob(y), y)), 1.0, rtol=1e-3)


def test_soft_round_high_alpha_near_hard():
    soft = d.NoisySoftRoundedNormal(0.0, 1.0, alpha=500.0)
    hard = d.NoisyRoundedNormal(0.0, 1.0)
    np.testing.assert_allclose(float(soft.prob(_t(0.0))), float(hard.prob(_t(0.0))), rtol=1e-2)


def test_noisy_deep_factorized_constructors():
    gen = torch.Generator().manual_seed(3)
    for make in (d.NoisyDeepFactorized, d.NoisyRoundedDeepFactorized):
        dist = make(generator=torch.Generator().manual_seed(3), batch_shape=(4,))
        assert dist.batch_shape == (4,)
    soft = d.NoisySoftRoundedDeepFactorized(alpha=2.0, generator=gen, batch_shape=(2, 3))
    assert soft.batch_shape == (2, 3) and float(soft.base.alpha) == 2.0
    # The constructors draw the biases as DeepFactorizedPrior does.
    from compression_tpu_torch.layers.priors import DeepFactorizedPrior

    prior = DeepFactorizedPrior((4,), generator=torch.Generator().manual_seed(3))
    made = d.NoisyDeepFactorized(generator=torch.Generator().manual_seed(3), batch_shape=(4,))
    for a, b in zip(prior.biases, made.base.biases):
        torch.testing.assert_close(a.detach(), b, rtol=0, atol=0)


# -- DeepFactorized (tests/test_distributions.py's TestDeepFactorized) ----------


def _df64(shape):
    return d.DeepFactorized.create(torch.Generator().manual_seed(0), shape, dtype=torch.float64)


def test_deep_factorized_cdf_monotone_and_bounded():
    dist = _df64((3,))
    x = torch.linspace(-300, 300, 601, dtype=torch.float64)[:, None]
    c = dist.cdf(x).numpy()
    assert np.all((c >= 0) & (c <= 1)) and np.all(np.diff(c, axis=0) >= -1e-9)
    assert np.all(c[0] < 1e-3) and np.all(c[-1] > 1 - 1e-3)
    np.testing.assert_allclose(dist.survival_function(x).numpy(), 1 - c, atol=1e-12)


@pytest.mark.parametrize("noisy", [False, True])
def test_deep_factorized_density_integrates_to_one(noisy):
    dist = _df64((1,))
    if noisy:
        dist = d.UniformNoiseAdapter(dist)
    x = torch.linspace(-400, 400, 64001, dtype=torch.float64)[:, None]
    total = torch.trapezoid(torch.exp(dist.log_prob(x))[:, 0], x[:, 0])
    np.testing.assert_allclose(float(total), 1.0, rtol=1e-3)


def test_deep_factorized_tails_bracket_mass_and_offset_is_median():
    dist = _df64((4,))
    tm = 2 ** -8
    lo, hi = d.lower_tail(dist, tm), d.upper_tail(dist, tm)
    assert lo.shape == (4,) and hi.shape == (4,)
    np.testing.assert_array_less(lo.numpy(), hi.numpy())
    np.testing.assert_allclose(dist.cdf(lo).numpy(), tm / 2, rtol=1e-4)
    np.testing.assert_allclose(dist.survival_function(hi).numpy(), tm / 2, rtol=1e-4)
    np.testing.assert_allclose(dist.cdf(dist._quantization_offset()).numpy(), 0.5, atol=1e-6)


def test_deep_factorized_create_equals_jax_init_but_the_biases():
    """Constant matrices and zero factors as the JAX init; the biases are
    U(-1/2, 1/2) from each package's own random stream."""
    want = jd.DeepFactorized.create(jax.random.PRNGKey(0), (2, 3), num_filters=(3, 4),
                                    init_scale=7.0)
    got = d.DeepFactorized.create(torch.Generator().manual_seed(0), (2, 3),
                                  num_filters=(3, 4), init_scale=7.0)
    for g, w in zip(got.matrices + got.factors, want.matrices + want.factors):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    for g, w in zip(got.biases, want.biases):
        assert g.shape == w.shape and float(g.abs().max()) <= 0.5


def test_map_tensors_round_trip():
    """The port's counterpart of the pytree round trip: the same
    distribution after mapping every tensor (here to float64 and back)."""
    from compression_tpu_torch.distributions.base import map_tensors, tensors

    dist = d.NoisySoftRoundAdapter(map_tensors(lambda t: t.float(), _df64((2,))), alpha=3.0)
    back = map_tensors(lambda t: t.double(), dist)
    back = map_tensors(lambda t: t.float() if t.dtype == torch.float64 else t, back)
    x = torch.tensor([0.3, -0.7])
    torch.testing.assert_close(back.log_prob(x), dist.log_prob(x), rtol=0, atol=0)
    assert len(tensors(dist)) == 3 * 4 - 1 + 1


# -- the log-CDF tail fallback ---------------------------------------------------


@register_distribution_pytree
@dataclasses.dataclass(frozen=True)
class _JaxNoTails(jd.MixtureSameFamily):
    """A mixture without analytic tails: the helpers must root-find them."""

    def _lower_tail(self, tail_mass):
        return None

    def _upper_tail(self, tail_mass):
        return None


@dataclasses.dataclass(frozen=True)
class _NoTails(d.MixtureSameFamily):
    def _lower_tail(self, tail_mass):
        return None

    def _upper_tail(self, tail_mass):
        return None


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_tail_fallback_equals_jax(dtype):
    logits, loc, scale = (a.astype(dtype) for a in _mixture_params(4, (5,)))
    want = _JaxNoTails(jnp.asarray(logits), jd.Logistic(jnp.asarray(loc), jnp.asarray(scale)))
    got = _NoTails(_t(logits), d.Logistic(_t(loc), _t(scale)))
    assert helpers._tail_dtype(got) == torch.from_numpy(np.zeros(0, dtype)).dtype
    assert jax_helpers._tail_dtype(want) == dtype
    tol = F32 if dtype == np.float32 else F64
    for fn in ("lower_tail", "upper_tail"):
        g = getattr(helpers, fn)(got, 2.0 ** -8)
        w = np.asarray(getattr(jax_helpers, fn)(want, 2.0 ** -8))
        assert g.dtype == torch.from_numpy(w).dtype
        np.testing.assert_allclose(g.numpy(), w, **tol, err_msg=fn)
    # The roots are where the mixture's CDF is tail_mass / 2.
    lo = helpers.lower_tail(got, 2.0 ** -8)
    np.testing.assert_allclose(got.cdf(lo.double()).numpy(), 2.0 ** -9, rtol=1e-4 if dtype == np.float32 else 1e-9)


def test_tail_fallback_tables_equal_jax():
    logits, loc, scale = (a.astype(np.float32) for a in _mixture_params(5, (4,)))
    want = JaxBatched(jd.UniformNoiseAdapter(_JaxNoTails(
        jnp.asarray(logits), jd.Logistic(jnp.asarray(loc), jnp.asarray(scale)))),
        coding_rank=1).build_tables()
    got = ContinuousBatchedEntropyModel(d.UniformNoiseAdapter(_NoTails(
        _t(logits), d.Logistic(_t(loc), _t(scale)))), coding_rank=1).build_tables()
    _assert_tables_equal(got, want)
    np.testing.assert_allclose(got.offset, want.offset, rtol=0, atol=1e-6)


def test_tail_dtype_of_a_distribution_without_float_tensors():
    @dataclasses.dataclass(frozen=True)
    class Empty(d.Distribution):
        pass

    assert helpers._tail_dtype(Empty()) == torch.float32


# -- the card's (d) priors at a small width ------------------------------------


def test_phase15_priors_tables_equal_jax():
    """NoisySoftRoundedDeepFactorized and a 3-component NoisyLogisticMixture
    (float32 parameters, as the card's step builds them) at 8 channels."""
    base, port = _df_pair(8, 9)
    want = JaxBatched(jd.NoisySoftRoundAdapter(base, alpha=4.0), coding_rank=3).build_tables()
    got = ContinuousBatchedEntropyModel(d.NoisySoftRoundAdapter(port, alpha=4.0),
                                        coding_rank=3).build_tables()
    _assert_tables_equal(got, want)
    np.testing.assert_allclose(got.offset, want.offset, rtol=0, atol=1e-6)
    logits, loc, scale = (a.astype(np.float32) for a in _mixture_params(6, (8,)))
    want = JaxBatched(jd.NoisyLogisticMixture(*map(jnp.asarray, (logits, loc, scale))),
                      coding_rank=3).build_tables()
    got = ContinuousBatchedEntropyModel(d.NoisyLogisticMixture(*map(_t, (logits, loc, scale))),
                                        coding_rank=3).build_tables()
    _assert_tables_equal(got, want)
    np.testing.assert_allclose(got.offset, want.offset, rtol=0, atol=1e-6)


def test_phase15_priors_training_rate_equals_jax():
    base, port = _df_pair(8, 9)
    y = (np.random.RandomState(2).randn(2, 3, 4, 8) * 3).astype(np.float32)
    want_model = JaxBatched(jd.NoisySoftRoundAdapter(base, alpha=4.0), coding_rank=3)
    got_model = ContinuousBatchedEntropyModel(d.NoisySoftRoundAdapter(port, alpha=4.0), coding_rank=3)
    want, want_g = jax.value_and_grad(
        lambda v: jnp.sum(want_model._log2_prob(want_model.prior, v)))(jnp.asarray(y))
    yt = _t(y).requires_grad_()
    got = got_model._log2_prob(got_model.prior, yt).sum()
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(want_g), rtol=1e-4, atol=1e-6)
