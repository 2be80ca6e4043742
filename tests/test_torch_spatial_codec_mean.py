"""mbt2018-mean's and HiFiC's halo-sharded transforms and SpatialCodecs on
virtual CPU shards: the sharded transforms against the JAX package's dense
ones through the weight bridge (float32, rtol = atol = 1e-5, as
tests/test_parallel_extras.py holds its own), and round trips at 1, 2 and
4 shards in the standard 4-field host blob, byte-equal to the dense
codec's. Tiny widths (8 latents, 4 hyperlatents, one residual block)."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compression_tpu.models import hific as jax_hific
from compression_tpu.models import mbt2018 as jax_mbt2018
from compression_tpu.util import PackedTensors as JaxPackedTensors
from compression_tpu_torch.models import hific, mbt2018
from compression_tpu_torch.parallel import make_mesh
from compression_tpu_torch.parallel.spatial import gather_rows

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_hific_archs import SMALL as HIFIC_SMALL  # noqa: E402
from test_torch_hific_archs import jax_g_params  # noqa: E402
from test_torch_mbt2018 import SMALL, _jax_params  # noqa: E402
from test_torch_spatial_codec import _close, _fields, _image, _rand  # noqa: E402

torch.set_num_threads(1)


def test_mbt2018_sharded_transforms_match_jax():
    """y and z (signed hyper-analysis), (mu, sigma) from z_hat and x_hat,
    each over 4 shards, against the JAX model's dense methods."""
    model = mbt2018.MBT2018Model(mbt2018.Config(**SMALL), seed=1)
    jax_model = jax_mbt2018.MBT2018Model(jax_mbt2018.Config(**SMALL))
    params, J = _jax_params(model), jax_mbt2018.MBT2018Model
    mesh = make_mesh(4, device="cpu")
    x = _rand(3, 1, 256, 64, 3)
    z_hat = np.random.RandomState(6).randn(1, 8, 4, 4).astype(np.float32)
    y_hat = np.random.RandomState(7).randn(1, 16, 4, 8).astype(np.float32)
    want_y, want_z = jax_model.apply(params, jnp.asarray(x), method=J.encode_latents)
    want_mu, want_sigma = jax_model.apply(params, jnp.asarray(z_hat), method=J.params_from_zhat)
    want_x = jax_model.apply(params, jnp.asarray(y_hat), method=J.synthesize)
    with torch.no_grad():
        y, z = mbt2018.sharded_encode_latents(model, torch.from_numpy(x), mesh)
        mu, sigma = mbt2018.sharded_params(model, torch.from_numpy(z_hat), mesh)
        x_hat = mbt2018.sharded_synthesize(model, torch.from_numpy(y_hat), mesh)
    for got, want in ((y, want_y), (z, want_z), (mu, want_mu), (sigma, want_sigma),
                      (x_hat, want_x)):
        _close(gather_rows(got), want)


def test_hific_sharded_transforms_match_jax():
    """The ChannelNorm encoder, the hyper pair and the residual generator
    over 4 shards against the JAX model's dense methods."""
    model = hific.HificModel(hific.HificConfig(**HIFIC_SMALL), seed=1)
    jax_model = jax_hific.HificModel(jax_hific.HificConfig(**HIFIC_SMALL))
    params, J = jax_g_params(model), jax_hific.HificModel
    mesh = make_mesh(4, device="cpu")
    x = _rand(3, 1, 256, 64, 3)
    z_hat = np.random.RandomState(6).randn(1, 8, 4, 4).astype(np.float32)
    y_hat = np.random.RandomState(7).randn(1, 16, 4, 8).astype(np.float32)
    want_y, want_z = jax_model.apply(params, jnp.asarray(x), method=J.encode_latents)
    want_mu, want_sigma = jax_model.apply(params, jnp.asarray(z_hat), method=J.params_from_zhat)
    want_x = jax_model.apply(params, jnp.asarray(y_hat), method=J.generate)
    with torch.no_grad():
        y, z = hific.sharded_encode_latents(model, torch.from_numpy(x), mesh)
        mu, sigma = hific.sharded_params(model, torch.from_numpy(z_hat), mesh)
        x_hat = hific.sharded_generate(model, torch.from_numpy(y_hat), mesh)
    for got, want in ((y, want_y), (z, want_z), (mu, want_mu), (sigma, want_sigma),
                      (x_hat, want_x)):
        _close(gather_rows(got), want)


@pytest.mark.parametrize("family", ["mbt2018", "hific"])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_spatial_codec_round_trips(family, shards):
    """A 256x64 image: the 4-field host blob under the model's name,
    byte-equal to the dense codec's, decoded within one level of the dense
    decode, the same image on a second decode."""
    if family == "mbt2018":
        mod, model = mbt2018, mbt2018.MBT2018Model(mbt2018.Config(**SMALL), seed=2)
    else:
        mod, model = hific, hific.HificModel(hific.HificConfig(**HIFIC_SMALL), seed=2)
    img = _image(256, 64, seed=6)
    sc = mod.SpatialCodec(model, make_mesh(shards, device="cpu"))
    blob = sc.compress(img)
    assert len(_fields(blob)) == 4
    assert JaxPackedTensors(blob).model == model.config.model_name
    assert blob == mod.compress(model, img, device="cpu")
    out = sc.decompress(blob)
    assert out.shape == img.shape
    np.testing.assert_array_equal(sc.decompress(blob), out)
    dense = mod.decompress(model, blob, device="cpu")
    assert np.abs(out.astype(np.int16) - dense.astype(np.int16)).max() <= 1
