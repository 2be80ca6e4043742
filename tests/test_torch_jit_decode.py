"""The single-program decode (bmshj2018 ``Codec.decompress_batch_jit``):
the counterparts of tests/test_jit_decode.py on the tiny 8/8/4 bmshj2018,
the port's weights bridged from the JAX model's seeded params. On the CPU
the program runs its two device segments eagerly; the card, where they are
CUDA graphs, is tests/test_torch_cuda.py's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import serialization

from compression_tpu.models import bmshj2018 as jax_bmshj2018
from compression_tpu_torch import convert
from compression_tpu_torch.models import bmshj2018
from compression_tpu_torch.models.device_coding import num_fields

TINY = dict(num_filters=8, num_latents=8, num_hyperlatents=4)


@pytest.fixture(scope="module")
def tiny():
    """The JAX model, its params and codec, and the port's model with the
    same weights (through the msgpack bridge)."""
    jax_model = jax_bmshj2018.BMSHJ2018Model(jax_bmshj2018.Config(**TINY))
    params = jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32),
                            jax.random.PRNGKey(1), training=True)
    blob = serialization.to_bytes({"params": params, "step": 0})
    model = bmshj2018.BMSHJ2018Model(bmshj2018.Config(**TINY))
    model.load_state_dict(convert.params_from_numpy(convert.unpack_msgpack(blob)))
    return jax_bmshj2018.make_codec(jax_model, params), model


def _images(n, h, w, seed):
    return (np.random.RandomState(seed).rand(n, h, w, 3) * 255).astype(np.uint8)


def test_jit_decode_matches_host_path(tiny):
    _, model = tiny
    codec = bmshj2018.Codec(model, device="cpu")
    blobs = codec.compress_batch(_images(2, 96, 128, 11))
    want = codec.decompress_batch(blobs)
    np.testing.assert_array_equal(codec.decompress_batch_jit(blobs), want)
    # The second call reuses the program of the same (n, zshape).
    assert len(codec._jit_decoders) == 1
    np.testing.assert_array_equal(codec.decompress_batch_jit(blobs), want)
    assert len(codec._jit_decoders) == 1
    (key,) = codec._jit_decoders
    assert key == (2, (2, 2))
    assert "jit/code_y" in codec.timer.report()


def test_jit_decode_matches_the_jax_jit_decode_on_pinned_tables(tiny):
    jax_codec, model = tiny
    tables = {"side": jax_codec.side_em.tables, "main": jax_codec.em.tables}
    codec = bmshj2018.Codec(model, device="cpu", tables=tables)
    images = _images(2, 96, 128, 11)
    blobs = codec.compress_batch(images)
    assert blobs == jax_codec.compress_batch(images)
    np.testing.assert_array_equal(codec.decompress_batch_jit(blobs),
                                  jax_codec.decompress_batch_jit(blobs))


def test_jit_decode_single_image_other_shape(tiny):
    _, model = tiny
    codec = bmshj2018.Codec(model, device="cpu")
    codec.decompress_batch_jit(codec.compress_batch(_images(2, 96, 128, 11)))
    blob = codec.compress(_images(1, 64, 64, 3)[0])
    out = codec.decompress_batch_jit([blob])
    assert out.shape == (1, 64, 64, 3)
    np.testing.assert_array_equal(out[0], codec.decompress(blob))
    assert len(codec._jit_decoders) == 2  # a new key for the new shape


def test_jit_decode_routes_device_coded_blobs_to_rans(tiny):
    _, model = tiny
    codec = bmshj2018.Codec(model, device="cpu")
    images = _images(2, 96, 128, 7)
    blobs = codec.compress_batch(images, coder="device")
    assert all(num_fields(b) == 5 for b in blobs)
    np.testing.assert_array_equal(codec.decompress_batch_jit(blobs),
                                  codec.decompress_batch(blobs))
    np.testing.assert_array_equal(codec.decompress_batch_jit(blobs),
                                  codec.decompress_batch(codec.compress_batch(images)))
    assert not codec._jit_decoders


def test_encode_at_batch_2_jit_decode_at_batch_1(tiny):
    _, model = tiny
    codec = bmshj2018.Codec(model, device="cpu")
    blobs = codec.compress_batch(_images(2, 96, 128, 5))
    both = codec.decompress_batch_jit(blobs)
    for i, blob in enumerate(blobs):
        np.testing.assert_array_equal(codec.decompress_batch_jit([blob])[0], both[i])
    assert len(codec._jit_decoders) == 2  # n = 2, then n = 1


def test_jit_decode_program_does_not_depend_on_stream_lengths(tiny):
    """Flat and noisy images of one size code to streams of very different
    lengths; the device segments depend only on (n, zshape), so both
    batches share one program."""
    _, model = tiny
    codec = bmshj2018.Codec(model, device="cpu")
    flat = np.full((2, 96, 128, 3), 128, np.uint8)
    noisy = _images(2, 96, 128, 13)
    flat_blobs, noisy_blobs = codec.compress_batch(flat), codec.compress_batch(noisy)
    assert sum(map(len, flat_blobs)) < sum(map(len, noisy_blobs))
    for blobs in (flat_blobs, noisy_blobs):
        np.testing.assert_array_equal(codec.decompress_batch_jit(blobs),
                                      codec.decompress_batch(blobs))
    assert list(codec._jit_decoders) == [(2, (2, 2))]
