"""bmshj2018's and bls2017's halo-sharded transforms and SpatialCodecs on
virtual CPU shards: the sharded transforms against the JAX package's dense
ones through the weight bridge (float32, rtol = atol = 1e-5, as
tests/test_parallel_extras.py holds its own), round trips at 1, 2 and 4
shards, the standard host blob (byte-equal to the dense codec's where the
padding is the same), and blobs across the packages: a JAX SpatialCodec
blob decodes in the port and the port's in JAX, on pinned tables, with
the rows and the bytes equal. Tiny widths (4-8 filters)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compression_tpu.models import bls2017 as jax_bls2017
from compression_tpu.models import bmshj2018 as jax_bmshj2018
from compression_tpu.parallel import data_parallel as jax_dp
from compression_tpu.util import PackedTensors as JaxPackedTensors
from compression_tpu_torch.models import bls2017, bmshj2018
from compression_tpu_torch.models.codec_cache import cached
from compression_tpu_torch.parallel import make_mesh
from compression_tpu_torch.parallel.spatial import gather_rows

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_bls2017 import _jax_params as bls_jax_params  # noqa: E402
from test_torch_train import SMALL, _jax_params  # noqa: E402

torch.set_num_threads(1)


def _rand(seed, *shape):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _image(h, w, seed=9):
    """A smooth image with noise: symbols that are not all zero."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([xx / w * 255, yy / h * 255, (np.sin(xx / 5) * 0.5 + 0.5) * 255], -1)
    noise = np.random.RandomState(seed).randn(h, w, 3) * 8
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def _fields(blob):
    return [k for k, *_ in JaxPackedTensors(blob).describe() if k != "MD"]


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def bmshj():
    model = bmshj2018.BMSHJ2018Model(bmshj2018.Config(**SMALL), seed=1)
    return jax_bmshj2018.BMSHJ2018Model(jax_bmshj2018.Config(**SMALL)), _jax_params(model), model


def test_bmshj2018_sharded_transforms_match_jax(bmshj):
    """y and z of the encode front, sigma from z_hat and x_hat from y_hat,
    each sharded over 4 shards, against the JAX model's dense methods."""
    jax_model, params, model = bmshj
    J = jax_bmshj2018.BMSHJ2018Model
    mesh = make_mesh(4, device="cpu")
    x = _rand(3, 1, 256, 64, 3)
    z_hat = np.random.RandomState(6).randn(1, 8, 4, 4).astype(np.float32)
    y_hat = np.random.RandomState(7).randn(1, 16, 4, 8).astype(np.float32)
    want_y, want_z = jax_model.apply(params, jnp.asarray(x), method=J.encode_latents)
    want_sigma = jax_model.apply(params, jnp.asarray(z_hat), method=J.sigma_from_zhat)
    want_x = jax_model.apply(params, jnp.asarray(y_hat), method=J.synthesize)
    with torch.no_grad():
        y, z = bmshj2018.sharded_encode_latents(model, torch.from_numpy(x), mesh)
        sigma = bmshj2018.sharded_sigma(model, torch.from_numpy(z_hat), mesh)
        x_hat = bmshj2018.sharded_synthesize(model, torch.from_numpy(y_hat), mesh)
    assert len(y) == len(z) == len(x_hat) == 4
    for got, want in ((y, want_y), (z, want_z), (sigma, want_sigma), (x_hat, want_x)):
        _close(gather_rows(got), want)


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_bmshj2018_spatial_codec_round_trips(bmshj, shards):
    """A 256x64 image (no padding at any shard count): the standard 4-field
    host blob under the model's name, byte-equal to the dense codec's (the
    sharded convolutions give the same symbols and rows here), decoded
    within one level of the dense decode; decoding twice gives the same
    image."""
    _, _, model = bmshj
    img = _image(256, 64)
    sc = bmshj2018.SpatialCodec(model, make_mesh(shards, device="cpu"))
    blob = sc.compress(img)
    assert _fields(blob) == _fields(bmshj2018.compress(model, img, device="cpu"))
    assert len(_fields(blob)) == 4 and JaxPackedTensors(blob).model == "bmshj2018-hyperprior"
    assert blob == bmshj2018.compress(model, img, device="cpu")
    out = sc.decompress(blob)
    assert out.shape == img.shape and out.dtype == np.uint8
    np.testing.assert_array_equal(sc.decompress(blob), out)
    dense = bmshj2018.decompress(model, blob, device="cpu")
    assert np.abs(out.astype(np.int16) - dense.astype(np.int16)).max() <= 1


def test_bmshj2018_spatial_codec_pads_to_the_shards(bmshj):
    """An image whose height does not divide 64 n: edge-padded to it and
    cut back; the blob records the original size."""
    _, _, model = bmshj
    img = _image(100, 70, seed=3)
    sc = bmshj2018.SpatialCodec(model, make_mesh(2, device="cpu"))
    blob = sc.compress(img)
    assert sc.decompress(blob).shape == img.shape
    _, _, xshape, zshape = JaxPackedTensors(blob).unpack([object, object, np.int32, np.int32])
    assert list(xshape) == [100, 70] and list(zshape) == [2, 2]


def test_bmshj2018_spatial_blobs_cross_decode_with_jax(bmshj):
    """On the JAX package's tables (pinned into the port's codec), the JAX
    SpatialCodec over 2 of its virtual devices and the port's over 2 CPU
    shards give the same rows and the same bytes; each decodes the other's
    blob, to images within one level of each other (float32 synthesis in
    two packages)."""
    jax_model, params, model = bmshj
    jax_sc = jax_bmshj2018.SpatialCodec(jax_model, params, jax_dp.make_mesh(2))
    tables = {"side": jax_sc.codec.side_em.tables, "main": jax_sc.codec.em.tables}
    pinned = cached(model, lambda: bmshj2018.Codec(model, "cpu", tables=tables), "cpu")
    sc = bmshj2018.SpatialCodec(model, make_mesh(2, device="cpu"))
    assert sc.codec is pinned
    img = _image(128, 64, seed=4)
    ours, theirs = sc.compress(img), jax_sc.compress(img)
    z_hat = jax_sc.codec.side_em.decompress(
        [JaxPackedTensors(theirs).unpack([object, object, np.int32, np.int32])[1][0]],
        (2, 1))
    with torch.no_grad():
        _, rows = sc._mu_rows(sc._shards(np.array(z_hat)))
    np.testing.assert_array_equal(gather_rows(rows).numpy(),
                                  np.asarray(jax_sc._rows(params, jnp.asarray(z_hat))))
    assert ours == theirs
    by_port, by_jax = sc.decompress(theirs), jax_sc.decompress(ours)
    assert by_port.shape == by_jax.shape == img.shape
    assert np.abs(by_port.astype(np.int16) - by_jax.astype(np.int16)).max() <= 1


def test_bls2017_sharded_transforms_match_jax():
    """bls2017's 9x9/4 analysis and its stride-4 synthesis over 4 shards
    against the JAX model's dense analyze / synthesize."""
    model = bls2017.BLS2017Model(bls2017.Config(num_filters=8), seed=1)
    jax_model = jax_bls2017.BLS2017Model(jax_bls2017.Config(num_filters=8))
    params = bls_jax_params(model)
    mesh = make_mesh(4, device="cpu")
    x = _rand(3, 1, 128, 64, 3)
    y_hat = np.random.RandomState(6).randn(1, 8, 4, 8).astype(np.float32)
    with torch.no_grad():
        y = bls2017.sharded_analyze(model, torch.from_numpy(x), mesh)
        x_hat = bls2017.sharded_synthesize(model, torch.from_numpy(y_hat), mesh)
    J = jax_bls2017.BLS2017Model
    _close(gather_rows(y), jax_model.apply(params, jnp.asarray(x), method=J.analyze))
    _close(gather_rows(x_hat), jax_model.apply(params, jnp.asarray(y_hat), method=J.synthesize))


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_bls2017_spatial_codec_round_trips(shards):
    """The 3-field blob, equal to the dense codec's at 1 shard, decoded
    within one level of the dense decode of the same blob."""
    model = bls2017.BLS2017Model(bls2017.Config(num_filters=8), seed=2)
    img = _image(128, 48, seed=5)
    sc = bls2017.SpatialCodec(model, make_mesh(shards, device="cpu"))
    blob = sc.compress(img)
    assert len(_fields(blob)) == 3 and JaxPackedTensors(blob).model == "bls2017"
    dense_blob = bls2017.compress(model, img, device="cpu")
    if shards == 1:
        assert blob == dense_blob
    out = sc.decompress(blob)
    assert out.shape == img.shape
    dense = bls2017.decompress(model, blob, device="cpu")
    assert np.abs(out.astype(np.int16) - dense.astype(np.int16)).max() <= 1
