"""The port's indexed-model extensions against the JAX package's: several
index dimensions (tables, rows, strings byte-identical and decoded across
both packages), rows() past 256 levels (uint16, then int32),
LocationScaleIndexedEntropyModel's scale_fn / inverse_scale_fn and its
coding calls, the _table_offsets hook, and perturb_and_apply's gradients
(rtol 1e-4, atol 1e-6, the reference test's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compression_tpu import entropy_models as jem
from compression_tpu.distributions.uniform_noise import NoisyNormal as JaxNoisyNormal
from compression_tpu.ops.math_ops import perturb_and_apply as jax_perturb_and_apply
from compression_tpu_torch import entropy_models as em
from compression_tpu_torch.distributions import NoisyNormal
from compression_tpu_torch.ops import perturb_and_apply

torch.set_num_threads(1)

GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _assert_tables_equal(got, want):
    np.testing.assert_array_equal(got.cdf, want.cdf)
    np.testing.assert_array_equal(got.cdf_length, want.cdf_length)
    np.testing.assert_array_equal(got.cdf_offset, want.cdf_offset)
    np.testing.assert_array_equal(got.offset, want.offset)


def _two_dim(**kw):
    want = jem.ContinuousIndexedEntropyModel(
        lambda loc, scale: JaxNoisyNormal(loc=loc, scale=scale), (5, 3),
        {"loc": lambda i: 0.3 * i[..., 1], "scale": lambda i: jnp.exp(-0.5 + 0.6 * i[..., 0])},
        coding_rank=2, **kw)
    got = em.ContinuousIndexedEntropyModel(
        lambda loc, scale: NoisyNormal(loc, scale), (5, 3),
        {"loc": lambda i: 0.3 * i[..., 1], "scale": lambda i: torch.exp(-0.5 + 0.6 * i[..., 0])},
        coding_rank=2, **kw)
    return got, want


def _indexes(rng, shape):
    return np.stack([rng.uniform(-1, 6, shape), rng.uniform(-1, 3.5, shape)], -1)


def test_two_index_dims_tables_and_rows_equal_jax():
    got, want = _two_dim(compression=True)
    _assert_tables_equal(got.tables, want.tables)
    assert got.tables.num_cdfs == 15
    idx = _indexes(np.random.RandomState(0), (2, 4, 6))
    rows = got._flat_int_indexes(torch.from_numpy(idx))
    np.testing.assert_array_equal(rows, want._flat_int_indexes(jnp.asarray(idx)))
    np.testing.assert_array_equal(got.device_indexes(torch.from_numpy(idx)).numpy(),
                                  np.asarray(want.device_indexes(jnp.asarray(idx))))
    assert rows.min() >= 0 and rows.max() <= 14


def test_two_index_dims_strings_and_cross_decode():
    got, want = _two_dim(compression=True)
    rng = np.random.RandomState(1)
    y = rng.randn(3, 4, 6) * 3
    idx = _indexes(rng, (3, 4, 6))
    strings = got.compress(torch.from_numpy(y), torch.from_numpy(idx))
    assert strings == want.compress(jnp.asarray(y), jnp.asarray(idx))
    y_hat = got.decompress(strings, torch.from_numpy(idx))
    np.testing.assert_array_equal(y_hat, np.round(y))
    np.testing.assert_array_equal(np.asarray(want.decompress(strings, jnp.asarray(idx))), y_hat)


def test_two_index_dims_training_rate_and_index_gradients_equal_jax():
    got, want = _two_dim()
    rng = np.random.RandomState(2)
    y = rng.randn(2, 4, 6)
    idx = _indexes(rng, (2, 4, 6))

    def jax_bits(ii):
        return jnp.sum(want(jnp.asarray(y), ii, training=False)[1])

    want_bits, want_g = jax.value_and_grad(jax_bits)(jnp.asarray(idx))
    it = torch.from_numpy(idx).requires_grad_()
    _, bits = got(torch.from_numpy(y), it, training=False)
    bits.sum().backward()
    np.testing.assert_allclose(float(bits.sum().detach()), float(want_bits), rtol=1e-9)
    np.testing.assert_allclose(it.grad.numpy(), np.asarray(want_g), **GRAD_TOL)


@pytest.mark.parametrize("levels,dtype", [(64, torch.uint8), (300, torch.uint16),
                                          (70000, torch.int32)])
def test_rows_past_256_levels(levels, dtype):
    sigma = np.exp(np.random.RandomState(3).uniform(np.log(0.05), np.log(400.0), (2, 9, 7)))
    sigma = sigma.astype(np.float32)
    got = em.LocationScaleIndexedEntropyModel(NoisyNormal, num_scales=levels).rows(
        torch.from_numpy(sigma))
    want = np.asarray(jem.LocationScaleIndexedEntropyModel(
        JaxNoisyNormal, num_scales=levels).rows(jnp.asarray(sigma)))
    assert got.dtype == dtype and want.dtype == np.dtype(str(dtype).split(".")[1])
    np.testing.assert_array_equal(got.to(torch.int64).numpy(), want.astype(np.int64))
    assert int(got.to(torch.int64).max()) == levels - 1


def test_custom_scale_fns_equal_jax():
    """A linear scale table through scale_fn / inverse_scale_fn: tables,
    training rate, strings, decode with a location."""
    jax_model = jem.LocationScaleIndexedEntropyModel(
        JaxNoisyNormal, num_scales=12, scale_fn=lambda i: 0.2 + 0.5 * i,
        inverse_scale_fn=lambda s: (s - 0.2) / 0.5, coding_rank=1, compression=True)
    model = em.LocationScaleIndexedEntropyModel(
        NoisyNormal, num_scales=12, scale_fn=lambda i: 0.2 + 0.5 * i,
        inverse_scale_fn=lambda s: (s - 0.2) / 0.5, coding_rank=1, compression=True)
    _assert_tables_equal(model.tables, jax_model.tables)
    rng = np.random.RandomState(4)
    y = (rng.randn(3, 40) * 3).astype(np.float32)
    scale = rng.uniform(0.1, 6.0, (3, 40)).astype(np.float32)
    loc = rng.randn(3, 40).astype(np.float32)
    _, bits = model(torch.from_numpy(y), torch.from_numpy(scale), torch.from_numpy(loc), training=False)
    _, want_bits = jax_model(jnp.asarray(y), jnp.asarray(scale), jnp.asarray(loc), training=False)
    np.testing.assert_allclose(bits.numpy(), np.asarray(want_bits), rtol=1e-5)
    strings = model.compress(torch.from_numpy(y), torch.from_numpy(scale), torch.from_numpy(loc))
    assert strings == jax_model.compress(jnp.asarray(y), jnp.asarray(scale), jnp.asarray(loc))
    got = model.decompress(strings, torch.from_numpy(scale), torch.from_numpy(loc))
    np.testing.assert_array_equal(got, np.asarray(jax_model.decompress(
        strings, jnp.asarray(scale), jnp.asarray(loc))))
    symbols, rows = model.device_symbols(torch.from_numpy(y), torch.from_numpy(scale), torch.from_numpy(loc))
    want_symbols, want_rows = jax_model.device_symbols(jnp.asarray(y), jnp.asarray(scale), jnp.asarray(loc))
    np.testing.assert_array_equal(symbols.numpy(), np.asarray(want_symbols))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want_rows))
    assert model.compress_symbols(symbols.numpy(), rows.numpy()) == strings
    np.testing.assert_array_equal(
        model.decompress_rows(strings, rows.numpy(), rows.shape, torch.from_numpy(loc)), got)


def test_table_offsets_hook_overrides_the_offsets():
    """A subclass's _table_offsets places every row's grid (and skips the
    fused root-find), in both packages."""

    def make(base_cls, noisy, lib):
        class Shifted(base_cls):
            def _table_offsets(self, prior):
                return np.linspace(-0.4, 0.4, 6)

        return Shifted(noisy(lib.zeros(6), lib.linspace(0.5, 3.0, 6)), coding_rank=1,
                       compression=True)

    got = make(em.ContinuousBatchedEntropyModel, NoisyNormal, torch)
    want = make(jem.ContinuousBatchedEntropyModel, JaxNoisyNormal, jnp)
    np.testing.assert_array_equal(got.tables.offset, np.linspace(-0.4, 0.4, 6))
    _assert_tables_equal(got.tables, want.tables)


@pytest.mark.parametrize("with_arg", [False, True])
def test_perturb_and_apply_gradients_equal_jax(with_arg):
    rng = np.random.RandomState(5)
    x = rng.randn(9)
    u = rng.uniform(-0.5, 0.5, 9)
    a = rng.uniform(0.5, 2.0, 9)

    def jf(t, s=None):
        return jnp.sin(t) * (1.0 if s is None else s) + t ** 3

    def tf(t, s=None):
        return torch.sin(t) * (1.0 if s is None else s) + t ** 3

    jargs = (jnp.asarray(a),) if with_arg else ()
    want = jax.grad(lambda xx, *rest: jnp.sum(jax_perturb_and_apply(jf, xx, jnp.asarray(u), *rest) ** 2),
                    argnums=tuple(range(1 + len(jargs))))(jnp.asarray(x), *jargs)
    xt = torch.from_numpy(x).requires_grad_()
    ut = torch.from_numpy(u).requires_grad_()
    targs = (torch.from_numpy(a).requires_grad_(),) if with_arg else ()
    y = perturb_and_apply(tf, xt, ut, *targs)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jax_perturb_and_apply(
        jf, jnp.asarray(x), jnp.asarray(u), *jargs)), rtol=1e-12)
    (y ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want[0]), **GRAD_TOL)
    np.testing.assert_array_equal(ut.grad.numpy(), np.zeros(9))
    if with_arg:
        np.testing.assert_allclose(targs[0].grad.numpy(), np.asarray(want[1]), **GRAD_TOL)
    # Without expected gradients: plain autograd of f(x + u).
    xt.grad = None
    (perturb_and_apply(tf, xt, ut, *targs, expected_grads=False) ** 2).sum().backward()
    t = torch.from_numpy(x + u).requires_grad_()
    (tf(t, *[g.detach() for g in targs]) ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), t.grad.numpy(), rtol=1e-12)


# -- the indexed coding calls (tests/test_entropy_models.py's TestContinuousIndexed
# and TestLocationScale), now that the port codes with them ----------------------


def _one_dim(**kw):
    want = jem.ContinuousIndexedEntropyModel(
        lambda loc, scale: JaxNoisyNormal(loc=loc, scale=scale), (10,),
        {"loc": lambda i: jnp.zeros_like(i), "scale": lambda i: jnp.exp(-1.0 + 0.4 * i)}, **kw)
    got = em.ContinuousIndexedEntropyModel(
        lambda loc, scale: NoisyNormal(loc, scale), (10,),
        {"loc": lambda i: torch.zeros_like(i), "scale": lambda i: torch.exp(-1.0 + 0.4 * i)}, **kw)
    return got, want


def test_indexed_roundtrip_strings_equal_jax():
    got, want = _one_dim(coding_rank=1, compression=True)
    rng = np.random.RandomState(2)
    y = rng.randn(3, 50) * 4
    idx = rng.randint(0, 10, (3, 50)).astype(np.float64)
    strings = got.compress(torch.from_numpy(y), torch.from_numpy(idx))
    assert len(strings) == 3
    assert strings == want.compress(jnp.asarray(y), jnp.asarray(idx))
    np.testing.assert_allclose(got.decompress(strings, torch.from_numpy(idx)), np.round(y), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(want.decompress(strings, jnp.asarray(idx))),
                                  got.decompress(strings, torch.from_numpy(idx)))


def test_indexed_rate_sanity():
    got, _ = _one_dim(coding_rank=1, compression=True)
    rng = np.random.RandomState(3)
    scale_idx = np.full(4096, 7.0)
    y = torch.from_numpy(rng.randn(4096) * np.exp(-1.0 + 0.4 * scale_idx))
    _, bits_est = got(y, torch.from_numpy(scale_idx), training=False)
    actual = len(got.compress(y[None], torch.from_numpy(scale_idx)[None])[0]) * 8
    assert abs(actual - float(bits_est)) / float(bits_est) < 0.1, (actual, float(bits_est))


def test_location_scale_roundtrip_with_loc_equals_jax():
    model = em.LocationScaleIndexedEntropyModel(NoisyNormal, coding_rank=1, compression=True)
    jax_model = jem.LocationScaleIndexedEntropyModel(JaxNoisyNormal, coding_rank=1, compression=True)
    rng = np.random.RandomState(4)
    loc = rng.randn(2, 40) * 3
    scale = np.exp(rng.uniform(-1.5, 3, (2, 40)))
    y = loc + rng.randn(2, 40) * scale
    strings = model.compress(torch.from_numpy(y), torch.from_numpy(scale), loc=torch.from_numpy(loc))
    assert strings == jax_model.compress(jnp.asarray(y), jnp.asarray(scale), loc=jnp.asarray(loc))
    y_hat = model.decompress(strings, torch.from_numpy(scale), loc=torch.from_numpy(loc))
    want = model.quantize(torch.from_numpy(y), loc=torch.from_numpy(loc)).numpy()
    np.testing.assert_allclose(y_hat, want, atol=1e-5)
    assert em.GaussianConditional is em.LocationScaleIndexedEntropyModel
    assert em.EntropyBottleneck is em.ContinuousBatchedEntropyModel
