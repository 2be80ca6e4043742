"""The port's plain torch CDF quantizer (the counterpart of
compression_tpu/codec/xla_cdf.py) against the C++ quantizer, row for row,
and against the JAX package's XLA one, as tests/test_codec.py:220-244 holds
the XLA one: integer rows, no tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compression_tpu.codec import pmf_to_quantized_cdf_xla
from compression_tpu_torch.codec import pmf_to_quantized_cdf, pmf_to_quantized_cdf_torch
from compression_tpu_torch.entropy_models import LocationScaleIndexedEntropyModel
from compression_tpu_torch.distributions import NoisyNormal

torch.set_num_threads(1)


def _pathological_rows(seed=0, num=24, max_len=17):
    rng = np.random.RandomState(seed)
    lengths = rng.randint(2, max_len + 1, num).astype(np.int32)
    pmf = rng.dirichlet(np.ones(max_len), num)
    # Pathological rows: zeros, non-finite, huge dynamic range.
    pmf[0] = 0.0
    pmf[1, : lengths[1]] = [np.inf] + [1.0] * (lengths[1] - 1)
    pmf[2, : lengths[2]] = 10.0 ** -rng.uniform(0, 18, lengths[2])
    return pmf, lengths


@pytest.mark.parametrize("precision", [8, 12, 16])
@pytest.mark.parametrize("seed", [0, 1])
def test_matches_cpp_and_xla_random_rows(precision, seed):
    pmf, lengths = _pathological_rows(seed)
    want = pmf_to_quantized_cdf(pmf, lengths, precision)
    got = pmf_to_quantized_cdf_torch(torch.from_numpy(pmf), torch.from_numpy(lengths), precision)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(pmf_to_quantized_cdf_xla(jnp.asarray(pmf), jnp.asarray(lengths), precision)))


def test_matches_cpp_on_the_main_tables_pmfs():
    """The PMF rows of the 64-scale NoisyNormal table, as the table build
    hands them to the C++ quantizer."""
    em = LocationScaleIndexedEntropyModel(NoisyNormal, coding_rank=3)._em
    captured = {}
    from compression_tpu_torch.entropy_models import continuous_base

    real = continuous_base.codec.pmf_to_quantized_cdf

    def spy(pmf, lengths, precision):
        captured.update(pmf=pmf, lengths=lengths, precision=precision)
        return real(pmf, lengths, precision)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(continuous_base.codec, "pmf_to_quantized_cdf", spy)
        tables = em.build_tables()
    got = pmf_to_quantized_cdf_torch(torch.from_numpy(captured["pmf"]),
                                     torch.from_numpy(captured["lengths"]),
                                     captured["precision"])
    np.testing.assert_array_equal(got.numpy(), tables.cdf)


def test_one_row_and_half_way_rounding():
    # 4096 * 0.5 / (0.5 + ...) lands exactly on x.5 for some entries: llround
    # (the C++ rounding) rounds away from zero, not to even.
    pmf = np.array([0.5, 0.3, 0.2, 0.0])
    got = pmf_to_quantized_cdf_torch(torch.from_numpy(pmf), torch.tensor([3]), 12)
    np.testing.assert_array_equal(got.numpy(), pmf_to_quantized_cdf(pmf, np.array([3], np.int32), 12))
    assert got[0, 0] == 0 and got[0, 3] == 1 << 12 and got[0, 4] == 0
    pmf = np.full((1, 8192), 1.0)  # every entry 0.5 before rounding
    got = pmf_to_quantized_cdf_torch(torch.from_numpy(pmf), torch.tensor([4096]), 12)
    np.testing.assert_array_equal(got.numpy(), pmf_to_quantized_cdf(pmf, np.array([4096], np.int32), 12))


def test_rejects_float32_and_bad_lengths():
    with pytest.raises(ValueError, match="float64"):
        pmf_to_quantized_cdf_torch(torch.ones(2, 4), torch.tensor([4, 4]), 12)
    with pytest.raises(ValueError, match="length"):
        pmf_to_quantized_cdf_torch(torch.ones(1, 4, dtype=torch.float64), torch.tensor([5]), 12)
