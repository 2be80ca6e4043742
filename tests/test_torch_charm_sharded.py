"""The image-parallel CHARM decode (``parallel/charm_sharded.py``) on
virtual CPU shards, as tests/test_charm_sharded.py checks the JAX
package's: byte-equal to the single-device ``Codec.decompress_batch`` with
both coders, a batch that does not divide the mesh padded and cut back,
empty and mixed batches refused; and shards on a second device, which run
on the model's copy there. 8 latents in 4 slices, 64x64 images."""

import numpy as np
import pytest
import torch

from compression_tpu_torch.models import ms2020
from compression_tpu_torch.parallel import ShardedCharmCodec, make_mesh
from compression_tpu_torch.parallel.data_parallel import Mesh

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def codec():
    model = ms2020.MS2020Model(ms2020.Config(num_filters=8, num_latents=8,
                                             num_hyperlatents=4, num_slices=4), seed=0)
    return model, ms2020.make_codec(model, "cpu")


def _images(n, seed):
    return (np.random.RandomState(seed).rand(n, 64, 64, 3) * 255).astype(np.uint8)


@pytest.mark.parametrize("coder", ["host", "device"])
@pytest.mark.parametrize("shards", [1, 4, 8])
def test_sharded_decode_matches_single_device(codec, coder, shards):
    model, dense = codec
    blobs = dense.compress_batch(_images(8, 7), coder=coder)
    assert dense._is_device_coded(blobs[0]) == (coder == "device")
    out = ShardedCharmCodec(model, make_mesh(shards, device="cpu")).decompress_batch(blobs)
    np.testing.assert_array_equal(out, dense.decompress_batch(blobs))


@pytest.mark.parametrize("coder", ["host", "device"])
def test_sharded_decode_pads_ragged_batches(codec, coder):
    """5 and 7 images over 4 shards: padded with the last blob, the padding
    dropped; each image equals its one-image decode."""
    model, dense = codec
    blobs = dense.compress_batch(_images(7, 9), coder=coder)
    sharded = ShardedCharmCodec(model, make_mesh(4, device="cpu"))
    for n in (5, 7):
        out = sharded.decompress_batch(blobs[:n])
        assert out.shape[0] == n
        for i in range(n):
            np.testing.assert_array_equal(out[i], dense.decompress(blobs[i]))
    np.testing.assert_array_equal(sharded.decompress(blobs[2]), dense.decompress(blobs[2]))


def test_sharded_decode_rejects_empty_and_mixed(codec):
    model, dense = codec
    sharded = ShardedCharmCodec(model, make_mesh(4, device="cpu"))
    with pytest.raises(ValueError, match="at least one blob"):
        sharded.decompress_batch([])
    images = _images(2, 12)
    host = dense.compress_batch(images)
    dev = dense.compress_batch(images, coder="device")
    with pytest.raises(ValueError, match="cannot mix"):
        sharded.decompress_batch([host[0], dev[1]])
    with pytest.raises(ValueError, match="cannot mix"):
        sharded.decompress_batch([dev[0], host[1]])


def test_sharded_decode_on_a_second_device(codec):
    """Shards alternating between ``cpu`` and ``cpu:0`` (two devices to the
    mesh): the second device's shards run on the model's copy there, and
    the decode is still byte-equal."""
    model, dense = codec
    blobs = dense.compress_batch(_images(4, 13), coder="device")
    other = torch.device("cpu", 0)
    sharded = ShardedCharmCodec(model, Mesh(("cpu", other, "cpu", other)))
    assert sharded._replicas.devices() == [torch.device("cpu"), other]
    np.testing.assert_array_equal(sharded.decompress_batch(blobs),
                                  dense.decompress_batch(blobs))
