"""Range coding over fixed-capacity buffers (codec/buffer_ops.py): the
counterparts of tests/test_jax_ops.py, plus bytes equal to the JAX
package's make_jax_encoder on the same tables."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compression_tpu.codec import _numpy_ref as ref
from compression_tpu.codec.jax_ops import make_jax_encoder
from compression_tpu.entropy_models.continuous_base import CdfTables as JaxCdfTables
from compression_tpu_torch.codec import host
from compression_tpu_torch.codec.buffer_ops import make_buffer_decoder, make_buffer_encoder
from compression_tpu_torch.entropy_models.continuous_base import CdfTables


def _tables(num_cdfs=4, num_symbols=12, precision=12, seed=0):
    """Seeded tables (tests/test_jax_ops.py's), in both packages' types."""
    rng = np.random.default_rng(seed)
    pmf = rng.dirichlet(np.ones(num_symbols) * 0.7, size=num_cdfs)
    cdf = np.stack([ref.pmf_to_quantized_cdf(pmf[r], precision)
                    for r in range(num_cdfs)]).astype(np.int32)
    fields = dict(
        cdf=cdf,
        cdf_length=np.full((num_cdfs,), num_symbols + 1, np.int32),
        cdf_offset=rng.integers(-5, 5, num_cdfs).astype(np.int32),
        offset=np.zeros(num_cdfs),
        precision=precision,
    )
    return CdfTables(**fields), JaxCdfTables(**fields)


def test_roundtrip():
    tables, _ = _tables()
    enc, dec = make_buffer_encoder(tables), make_buffer_decoder(tables)
    rng = np.random.default_rng(1)
    indexes = rng.integers(0, 4, (3, 200)).astype(np.int32)
    values = (tables.cdf_offset[indexes] + rng.integers(-2, 10, (3, 200))).astype(np.int32)
    data, lengths = enc(torch.from_numpy(values), torch.from_numpy(indexes))
    assert data.dtype == torch.uint8 and data.shape == (3, host.encode_capacity(200, 12))
    assert lengths.dtype == torch.int32 and bool(torch.all(lengths > 0))
    out = dec(data, lengths, torch.from_numpy(indexes))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), values)
    # NumPy in, tensors out, the same values.
    np.testing.assert_array_equal(dec(data.numpy(), lengths.numpy(), indexes).numpy(), values)


def test_encode_matches_host_bytes_and_the_jax_encoder():
    tables, jax_tables = _tables(seed=2)
    rng = np.random.default_rng(3)
    indexes = rng.integers(0, 4, (2, 100)).astype(np.int32)
    values = (tables.cdf_offset[indexes] + rng.integers(0, 8, (2, 100))).astype(np.int32)
    data, lengths = make_buffer_encoder(tables)(values, indexes)
    expected = host.entropy_encode(values, indexes, tables.cdf, tables.cdf_length,
                                   tables.cdf_offset, tables.precision)
    jdata, jlengths = jax.jit(make_jax_encoder(jax_tables))(jnp.asarray(values),
                                                            jnp.asarray(indexes))
    np.testing.assert_array_equal(data.numpy(), np.asarray(jdata))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(jlengths))
    for i in range(2):
        assert data[i, : int(lengths[i])].numpy().tobytes() == expected[i]


def test_capacity_overflow_raises():
    tables, _ = _tables(seed=4)
    rng = np.random.default_rng(5)
    indexes = rng.integers(0, 4, (2, 50)).astype(np.int32)
    # Far outside every row's range: each symbol escapes.
    values = np.full((2, 50), 10_000, np.int32)
    enc = make_buffer_encoder(tables, capacity_per_symbol=0)
    with pytest.raises(ValueError, match=r"stream 0 \(\d+B\) exceeds capacity 64B"):
        enc(values, indexes)
    data, lengths = make_buffer_encoder(tables)(values, indexes)
    np.testing.assert_array_equal(
        make_buffer_decoder(tables)(data, lengths, indexes).numpy(), values)
