"""ms2020's (CHARM's) halo-sharded transforms and SpatialCodec on virtual
CPU shards: the encode front, the two supports, a slice's (mu, sigma) and
its latent residual prediction against the JAX package's dense methods
through the weight bridge (float32, rtol = atol = 1e-5, as
tests/test_parallel_extras.py holds its own), and round trips at 1, 2 and
4 shards in the standard ``num_slices + 3``-field host blob, byte-equal to
the dense codec's. 8 latents in 4 slices."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compression_tpu.models import ms2020 as jax_ms2020
from compression_tpu.util import PackedTensors as JaxPackedTensors
from compression_tpu_torch.models import ms2020
from compression_tpu_torch.parallel import make_mesh
from compression_tpu_torch.parallel.spatial import gather_rows, shard_rows

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_ms2020 import _jax_params  # noqa: E402
from test_torch_spatial_codec import _close, _fields, _image, _rand  # noqa: E402

torch.set_num_threads(1)

TINY = dict(num_filters=8, num_latents=8, num_hyperlatents=4, num_slices=4)


def test_ms2020_sharded_transforms_match_jax():
    """Over 4 shards: y and z, the supports from z_hat, slice 2's (mu,
    sigma) (its context two decoded slices) and its LRP, and x_hat."""
    model = ms2020.MS2020Model(ms2020.Config(**TINY), seed=1)
    jax_model = jax_ms2020.MS2020Model(jax_ms2020.Config(**TINY))
    params, J = _jax_params(model), jax_ms2020.MS2020Model
    mesh = make_mesh(4, device="cpu")
    rng = np.random.RandomState(6)
    x = _rand(3, 1, 256, 64, 3)
    z_hat = rng.randn(1, 4, 1, 4).astype(np.float32)
    y_hat = rng.randn(1, 16, 4, 8).astype(np.float32)
    dec = [rng.randn(1, 16, 4, 2).astype(np.float32) for _ in range(3)]
    want_y, want_z = jax_model.apply(params, jnp.asarray(x), method=J.encode_latents)
    want_sups = jax_model.apply(params, jnp.asarray(z_hat), method=J.supports_from_zhat)
    want_ms = jax_model.apply(params, 2, *want_sups, [jnp.asarray(d) for d in dec[:2]],
                              method=J.slice_params)
    want_lrp = jax_model.apply(params, 2, want_sups[0], [jnp.asarray(d) for d in dec],
                               method=J.slice_lrp)
    want_x = jax_model.apply(params, jnp.asarray(y_hat), method=J.synthesize)
    with torch.no_grad():
        y, z = ms2020.sharded_encode_latents(model, torch.from_numpy(x), mesh)
        sups = ms2020.sharded_supports(model, torch.from_numpy(z_hat), mesh)
        shards = [shard_rows(torch.from_numpy(d), mesh) for d in dec]
        mu_sigma = ms2020.sharded_slice_params(model, 2, *sups, shards[:2], mesh)
        lrp = ms2020.sharded_slice_lrp(model, 2, sups[0], shards, mesh)
        x_hat = ms2020.sharded_synthesize(model, torch.from_numpy(y_hat), mesh)
    pairs = [(y, want_y), (z, want_z), *zip(sups, want_sups), *zip(mu_sigma, want_ms),
             (lrp, want_lrp), (x_hat, want_x)]
    for got, want in pairs:
        _close(gather_rows(got), want)


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_ms2020_spatial_codec_round_trips(shards):
    """A 256x64 image through the slice chain with every transform
    sharded: the host blob of 4 slices + 3 fields, byte-equal to the dense
    codec's, decoded within one level of the dense decode, the same image
    on a second decode."""
    model = ms2020.MS2020Model(ms2020.Config(**TINY), seed=2)
    img = _image(256, 64, seed=7)
    sc = ms2020.SpatialCodec(model, make_mesh(shards, device="cpu"))
    blob = sc.compress(img)
    assert len(_fields(blob)) == TINY["num_slices"] + 3
    assert JaxPackedTensors(blob).model == "ms2020-cc10"
    assert blob == ms2020.compress(model, img, device="cpu")
    out = sc.decompress(blob)
    assert out.shape == img.shape
    np.testing.assert_array_equal(sc.decompress(blob), out)
    dense = ms2020.decompress(model, blob, device="cpu")
    assert np.abs(out.astype(np.int16) - dense.astype(np.int16)).max() <= 1
