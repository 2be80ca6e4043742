"""The port's power-law entropy model and run-length gamma coder against
the JAX package's: the penalty and its gradient (float32 at 1e-6 relative),
quantize, and byte-identical run-length-gamma streams decoded across the
packages both ways."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compression_tpu.codec import host as jax_codec
from compression_tpu.entropy_models import PowerLawEntropyModel as JaxPowerLaw
from compression_tpu_torch.codec import host as codec
from compression_tpu_torch.entropy_models import PowerLawEntropyModel

torch.set_num_threads(1)


@pytest.mark.parametrize("alpha", [1.0, 0.3])
@pytest.mark.parametrize("coding_rank", [1, 2])
def test_penalty_and_gradient_equal_jax(alpha, coding_rank):
    x = (np.random.RandomState(8).randn(3, 4, 50) * 5).astype(np.float32)
    jax_model = JaxPowerLaw(coding_rank, alpha)
    want = np.asarray(jax_model.penalty(jnp.asarray(x)))
    want_grad = np.asarray(jax.grad(lambda v: jnp.sum(jax_model(v)))(jnp.asarray(x)))
    model = PowerLawEntropyModel(coding_rank, alpha)
    xt = torch.from_numpy(x).requires_grad_()
    got = model(xt)
    got.sum().backward()
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), want_grad, rtol=1e-6, atol=1e-7)


def test_rejects_nonpositive_alpha():
    with pytest.raises(ValueError, match="alpha"):
        PowerLawEntropyModel(1, alpha=0.0)


def test_quantize_is_straight_through():
    x = torch.tensor([0.4, -1.6, 2.5], requires_grad=True)
    y = PowerLawEntropyModel(1).quantize(x)
    y.sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), np.round(x.detach().numpy()))
    np.testing.assert_array_equal(x.grad.numpy(), np.ones(3))


@pytest.mark.parametrize("shape", [(200,), (3, 64), (2, 2, 33)])
def test_strings_byte_identical_and_cross_decode(shape):
    rng = np.random.RandomState(9)
    x = (rng.randn(*shape) * 10 * (rng.rand(*shape) < 0.3)).astype(np.float32)
    jax_model = JaxPowerLaw(coding_rank=1)
    model = PowerLawEntropyModel(coding_rank=1)
    want = jax_model.compress(jnp.asarray(x))
    got = model.compress(torch.from_numpy(x))
    assert got == want
    x_hat = model.decompress(want, shape)
    np.testing.assert_array_equal(x_hat, np.round(x))
    np.testing.assert_array_equal(np.asarray(jax_model.decompress(got, shape)), x_hat)
    with pytest.raises(ValueError, match="streams"):
        model.decompress(got[:1] if len(got) > 1 else got * 2, shape)


def test_sparse_costs_less():
    model = PowerLawEntropyModel(coding_rank=1)
    dense = torch.from_numpy(np.random.RandomState(9).randn(500) * 10)
    sparse = dense * (torch.arange(500) % 50 == 0)
    assert float(model.penalty(sparse)) < float(model.penalty(dense))
    assert len(model.compress(sparse)[0]) < len(model.compress(dense)[0])


def test_run_length_gamma_bytes_equal_jax():
    rng = np.random.RandomState(10)
    for n in (0, 1, 7, 1000):
        values = (rng.randint(-(2 ** 20), 2 ** 20, n) * (rng.rand(n) < 0.2)).astype(np.int32)
        if n:
            values[0] = np.iinfo(np.int32).min + 1
        blob = codec.run_length_gamma_encode(values)
        assert blob == jax_codec.run_length_gamma_encode(values)
        np.testing.assert_array_equal(codec.run_length_gamma_decode(blob, values.shape), values)
        np.testing.assert_array_equal(jax_codec.run_length_gamma_decode(blob, values.shape), values)
