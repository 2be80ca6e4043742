"""The port's entropy-coding stack against the JAX package's: CDF tables of
the committed checkpoint, CDF rows, range-coder bytes, the copied C++
sources, PackedTensors blobs, and the distributions and bound ops under
them."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compression_tpu.codec import host as jax_codec
from compression_tpu.distributions.deep_factorized import DeepFactorized as JaxDF
from compression_tpu.distributions import helpers as jax_helpers
from compression_tpu.distributions.uniform_noise import (
    NoisyNormal as JaxNoisyNormal,
    UniformNoiseAdapter as JaxUNA,
)
from compression_tpu.entropy_models import (
    ContinuousBatchedEntropyModel as JaxBatched,
    LocationScaleIndexedEntropyModel as JaxLocScale,
)
from compression_tpu.ops import math_ops as jax_math_ops
from compression_tpu.util import PackedTensors as JaxPackedTensors
from compression_tpu_torch import convert
from compression_tpu_torch.codec import host as codec
from compression_tpu_torch.distributions import (
    DeepFactorized,
    NoisyNormal,
    UniformNoiseAdapter,
    estimate_tails,
)
from compression_tpu_torch.entropy_models import (
    ContinuousBatchedEntropyModel,
    LocationScaleIndexedEntropyModel,
)
from compression_tpu_torch.ops import lower_bound, upper_bound
from compression_tpu_torch.util import PackedTensors

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CKPT = ROOT / "ckpt" / "bmshj2018.msgpack"


@pytest.fixture(scope="module")
def hyperprior_leaves():
    tree = convert.load_flax_msgpack(CKPT)
    hp = tree["params"]["params"]["hyperprior"]["deep_factorized"]
    return tuple(
        tuple(hp[field][str(i)] for i in range(len(hp[field])))
        for field in ("matrices", "biases", "factors")
    )


def _assert_integer_tables_equal(got, want):
    np.testing.assert_array_equal(got.cdf, want.cdf)
    np.testing.assert_array_equal(got.cdf_length, want.cdf_length)
    np.testing.assert_array_equal(got.cdf_offset, want.cdf_offset)
    assert got.precision == want.precision


def test_side_tables_of_the_checkpoint_equal_jax(hyperprior_leaves):
    jax_prior = JaxUNA(JaxDF(*(tuple(map(jnp.asarray, f)) for f in hyperprior_leaves)))
    prior = UniformNoiseAdapter(
        DeepFactorized(*(tuple(map(torch.from_numpy, f)) for f in hyperprior_leaves))
    )
    want = JaxBatched(jax_prior, coding_rank=3).build_tables()
    got = ContinuousBatchedEntropyModel(prior, coding_rank=3).build_tables()
    _assert_integer_tables_equal(got, want)
    # The offsets come from a float32 root-find in both packages. XLA's
    # float32 exp/log1p/tanh are not correctly rounded (they differ from
    # torch's in the last bit for most of the checkpoint's parameters), so
    # the crossing can land a few float32 ulps apart; the integer tables
    # above do not move.
    np.testing.assert_allclose(got.offset, want.offset, rtol=0, atol=1e-6)


def test_main_tables_equal_jax():
    want = JaxLocScale(JaxNoisyNormal, coding_rank=3)._em.build_tables()
    got = LocationScaleIndexedEntropyModel(NoisyNormal, coding_rank=3)._em.build_tables()
    _assert_integer_tables_equal(got, want)
    np.testing.assert_array_equal(got.offset, want.offset)


@pytest.mark.parametrize("seed", [0, 1])
def test_rows_equal_jax(seed):
    rng = np.random.RandomState(seed)
    sigma = np.exp(rng.uniform(np.log(0.05), np.log(400.0), (2, 6, 5, 192)))
    sigma = sigma.astype(np.float32)
    em = LocationScaleIndexedEntropyModel(NoisyNormal, coding_rank=3)
    got = em.rows(torch.from_numpy(sigma))
    want = JaxLocScale(JaxNoisyNormal, coding_rank=3).rows(jnp.asarray(sigma))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.min() == 0 and got.max() == 63


def test_range_coder_bytes_identical_and_cross_decode():
    tables = LocationScaleIndexedEntropyModel(NoisyNormal, coding_rank=3,
                                              compression=True).tables
    rng = np.random.RandomState(3)
    rows = rng.randint(0, 64, (3, 500)).astype(np.int32)
    values = np.round(rng.randn(3, 500) * np.exp(rows * 0.12) * 0.3)
    values = values.astype(np.int32)
    values[0, 7] = 4000    # escape path
    values[2, 9] = -90000  # escape path, negative
    args = (tables.cdf, tables.cdf_length, tables.cdf_offset, tables.precision)
    got = codec.entropy_encode(values, rows, *args)
    want = jax_codec.entropy_encode(values, rows, *args)
    assert got == want
    np.testing.assert_array_equal(jax_codec.entropy_decode(got, rows, *args), values)
    np.testing.assert_array_equal(codec.entropy_decode(want, rows, *args), values)


def test_pmf_to_quantized_cdf_identical():
    pmf = np.random.RandomState(4).dirichlet(np.ones(9), size=5)
    lengths = np.array([9, 5, 7, 9, 3], np.int32)
    np.testing.assert_array_equal(
        codec.pmf_to_quantized_cdf(pmf, lengths, 12),
        jax_codec.pmf_to_quantized_cdf(pmf, lengths, 12),
    )


@pytest.mark.parametrize("name", ["tpc_codec.cc", "range_coder.h"])
def test_copied_coder_sources_are_byte_identical(name):
    ours = ROOT / "compression_tpu_torch" / "codec" / "cc" / name
    theirs = ROOT / "compression_tpu" / "codec" / "cc" / name
    assert ours.read_bytes() == theirs.read_bytes()


def test_packed_tensors_byte_identical_both_ways():
    fields = [b"\x00\x01y-stream", b"z", np.array([512, 768], np.int32),
              np.array([8, 12], np.int32), np.array([1.5, -2.0], np.float32)]
    ours, theirs = PackedTensors(), JaxPackedTensors()
    for p in (ours, theirs):
        p.model = "bmshj2018-hyperprior"
        p.pack(fields)
    assert ours.string == theirs.string
    dtypes = [object, object, np.int32, np.int32, np.float32]
    for a, b in zip(PackedTensors(theirs.string).unpack(dtypes),
                    JaxPackedTensors(ours.string).unpack(dtypes)):
        np.testing.assert_array_equal(a, b)
    assert PackedTensors(theirs.string).model == "bmshj2018-hyperprior"


def test_deep_factorized_closed_form_log_prob_matches_jvp(hyperprior_leaves):
    x = np.linspace(-6, 6, 31)[:, None] + np.zeros((1, 128))
    jax_prior = JaxDF(*(tuple(map(jnp.asarray, f)) for f in hyperprior_leaves))
    prior = DeepFactorized(*(tuple(map(torch.from_numpy, f)) for f in hyperprior_leaves))
    # Even on a float64 grid, softplus(H) and tanh(a) are taken in float32
    # (then promoted) by both packages, and XLA's float32 values differ from
    # torch's in the last bit: ~1e-7 relative.
    want = np.asarray(jax_prior.log_prob(jnp.asarray(x)))
    got = prior.log_prob(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    want32 = np.asarray(jax_prior.log_prob(jnp.asarray(x, jnp.float32)))
    got32 = prior.log_prob(torch.from_numpy(x.astype(np.float32))).numpy()
    assert got32.dtype == np.float32
    np.testing.assert_allclose(got32, want32, rtol=1e-5, atol=1e-5)


def test_noisy_normal_prob_matches_jax():
    scale = np.exp(np.linspace(np.log(0.11), np.log(256.0), 64)).astype(np.float32)
    y = np.arange(-40, 41, dtype=np.float64)[:, None] + np.zeros((1, 64))
    want = JaxNoisyNormal(jnp.zeros(64, jnp.float32), jnp.asarray(scale)).prob(jnp.asarray(y))
    got = NoisyNormal(torch.zeros(64), torch.from_numpy(scale)).prob(torch.from_numpy(y))
    # float64 throughout; the two log_ndtr implementations differ by a few
    # 1e-9 relative only in the deep tail (densities ~1e-98).
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8, atol=1e-15)


def test_estimate_tails_matches_jax_on_exact_arithmetic():
    # A cubic whose float32 evaluation is exact enough to bisect identically.
    target = np.array([-3.0, 0.5, 7.25], np.float32)
    got = estimate_tails(lambda x: x * 2.0 + 1.0, torch.from_numpy(target), (3,))
    want = jax_helpers.estimate_tails(lambda x: x * 2.0 + 1.0, jnp.asarray(target), (3,))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["identity_if_towards", "disconnected", "identity"])
@pytest.mark.parametrize("upper", [False, True])
def test_bound_ops_values_and_gradients_match_jax(mode, upper):
    x = np.array([-2.0, -0.5, 0.0, 0.5, 2.0], np.float32)
    g = np.array([1.0, -1.0, 1.0, -1.0, 1.0], np.float32)
    jfn = jax_math_ops.upper_bound if upper else jax_math_ops.lower_bound
    tfn = upper_bound if upper else lower_bound
    want, vjp = jax.vjp(lambda v: jfn(v, 0.25, mode), jnp.asarray(x))
    (want_grad,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    got = tfn(xt, 0.25, mode)
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want_grad))
