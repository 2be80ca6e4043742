"""The port's HiFiC model, codec and training driver against the JAX
package's: the forward with and without the interior ring, the coded-rate
probe, the CDF tables, host- and device-coded blobs byte-identical and
decoded in the other package both ways, encode at batch 3 with decode at
batch 1, the rejections, G checkpoints written by either package, and
``train`` on the CPU with the rate probe over PNGs, its smoothing and the
integral controller; its argument errors as the JAX package's. Small sizes
(8 latents, 4 hyperlatents, one residual block); the JAX params are the
port's seeded model through the weight bridge."""

import csv
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from compression_tpu.models import common as jax_common
from compression_tpu.models import device_coding as jax_dc
from compression_tpu.models import hific as jax_hific
from compression_tpu.models.hific import model as jax_hific_model
from compression_tpu.util import PackedTensors as JaxPackedTensors
from compression_tpu_torch import convert
from compression_tpu_torch.models import common, device_coding, hific
from compression_tpu_torch.util import image
from test_torch_hific_archs import SMALL, jax_g_params

torch.set_num_threads(1)


def _cfg(**overrides):
    return hific.HificConfig(**{**SMALL, **overrides})


def _jax_model():
    return jax_hific.HificModel(jax_hific.HificConfig(**SMALL))


def _images(n, h, w, seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([xx / w * 255, yy / h * 255,
                     (np.sin(xx / 5) * np.cos(yy / 7) * 0.5 + 0.5) * 255], -1)
    return np.stack([np.clip(base + rng.randn(h, w, 3) * 8, 0, 255).astype(np.uint8)
                     for _ in range(n)])


def _fields(blob):
    return [k for k, *_ in JaxPackedTensors(blob).describe() if k != "MD"]


def _to_port(tree):
    return convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(tree)))


@pytest.fixture(scope="module")
def model():
    return hific.HificModel(_cfg(), seed=1)


# -- the model ---------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(64, 64), (128, 128)])
def test_forward_matches_jax(model, hw):
    """training=False: x_hat, y_hat, bpp and hinge_bpp within 1e-5. At
    64x64 y is 4x4 and has no interior (hinge_bpp = bpp); at 128x128 the
    ring of 3 leaves a 2x2 interior."""
    x = np.random.RandomState(hw[0]).rand(2, *hw, 3).astype(np.float32)
    want = _jax_model().apply(jax_g_params(model), jnp.asarray(x), jax.random.PRNGKey(0),
                              training=False)
    with torch.no_grad():
        got = model(torch.from_numpy(x), None, training=False)
    for name, g, w in zip(("x_hat", "y_hat", "bpp", "hinge_bpp"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    assert (got[3] == got[2]) == (hw == (64, 64))


def test_coded_bpp_matches_jax(model):
    """The probe's statistic: the rounded symbols' bits, each at most 12,
    within 1e-5; below the density estimate."""
    x = np.random.RandomState(3).rand(2, 128, 64, 3).astype(np.float32)
    want = _jax_model().apply(jax_g_params(model), jnp.asarray(x),
                              method=jax_hific.HificModel.coded_bpp)
    with torch.no_grad():
        got = model.coded_bpp(torch.from_numpy(x))
        density = model(torch.from_numpy(x), None, training=False)[2]
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert 0.0 < got.item() <= density.item()


# -- the codec ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def codecs(model):
    """The JAX codec, and the port's on its own tables and on the JAX
    package's (pinned), for the same seeded weights."""
    jax_codec = jax_hific_model.Codec(_jax_model(), jax_g_params(model))
    own = hific.Codec(model, device="cpu")
    pinned = hific.Codec(model, device="cpu", tables={
        "side": jax_codec.side_em.tables, "main": jax_codec.em.tables})
    return jax_codec, own, pinned


def test_cdf_tables_equal_jax(codecs):
    jax_codec, own, _ = codecs
    for name in ("side_em", "em"):
        want, got = getattr(jax_codec, name).tables, getattr(own, name).tables
        for field in ("cdf", "cdf_length", "cdf_offset"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field),
                                          f"{name}.{field}")
        np.testing.assert_allclose(got.offset, want.offset, rtol=0, atol=1e-5)


def _cross_decode(jax_codec, codec, ours, theirs):
    by_jax = jax_codec.decompress_batch(ours)
    by_port = codec.decompress_batch(theirs)
    assert by_jax.shape == by_port.shape
    # Same symbols in, float32 generators in two libraries: one level apart
    # at most.
    diff = np.abs(by_jax.astype(np.int16) - by_port.astype(np.int16))
    assert diff.max() <= 1 and np.mean(diff == 0) > 0.99
    return by_jax, by_port


def test_host_and_device_blobs_byte_identical_and_cross_decode(codecs):
    """Host-coded (4 fields) and device-coded (5 fields, the JAX package's
    dispatch_encode_rans / finish_encode_rans) blobs under the name
    ``hific-test``, equal to the JAX package's; each package decodes the
    other's, and the device-coded decode equals the host-coded one."""
    jax_codec, _, codec = codecs
    images = _images(2, 64, 128, seed=4)
    ours, theirs = codec.compress_batch(images), jax_codec.compress_batch(images)
    assert ours == theirs
    assert [len(_fields(b)) for b in ours] == [4, 4]
    assert JaxPackedTensors(ours[0]).model == "hific-test"
    host_jax, host_port = _cross_decode(jax_codec, codec, ours, theirs)
    ours_dev = codec.compress_batch(images, coder="device")
    theirs_dev = jax_dc.finish_encode_rans(
        jax_codec, jax_dc.dispatch_encode_rans(jax_codec, images))
    assert ours_dev == theirs_dev
    for blob in ours_dev:
        assert len(_fields(blob)) == 5
        assert int(JaxPackedTensors(blob).unpack_one(4, np.int32)[0]) == 16  # N = 256
    by_jax, by_port = _cross_decode(jax_codec, codec, ours_dev, theirs_dev)
    np.testing.assert_array_equal(by_port, host_port)
    np.testing.assert_array_equal(by_jax, host_jax)
    np.testing.assert_array_equal(device_coding.decompress_batch_rans(codec, theirs_dev),
                                  by_port)


@pytest.mark.parametrize("coder", ["host", "device"])
def test_encode_at_batch_3_decode_at_batch_1(codecs, coder):
    """mu and the rows come from one function on both sides, one image at a
    time, so a blob decodes the same alone or in a batch; re-compression is
    byte-identical; the decode is the generator of the rounded latents."""
    _, codec, _ = codecs
    images = _images(3, 70, 100, seed=5)  # padded to 128x128
    blobs = codec.compress_batch(images, coder=coder)
    out = codec.decompress_batch(blobs)
    assert out.shape == images.shape and out.dtype == np.uint8
    for b in range(3):
        np.testing.assert_array_equal(codec.decompress(blobs[b]), out[b])
    assert codec.compress_batch(images, coder=coder) == blobs
    piped = list(codec.compress_iter([images[:1], images[1:]], coder=coder))
    assert piped[0] + piped[1] == blobs
    np.testing.assert_array_equal(np.concatenate(list(codec.decompress_iter(piped))), out)
    m = codec.model
    x = np.pad(images, ((0, 0), (0, 58), (0, 28), (0, 0)), mode="edge")
    with torch.no_grad():
        y, z = m.encode_latents(torch.from_numpy(x).float() / 255.0)
        off = codec.side_em.symbol_offset()
        mu, _ = m.params_from_zhat(torch.round(z - off) + off)
        x_hat = m.generate(torch.round(y - mu) + mu)
    want = torch.clamp(torch.round(x_hat * 255.0), 0, 255).to(torch.uint8).numpy()
    np.testing.assert_array_equal(out, want[:, :70, :100])


def test_rejects_mixed_formats_and_devices(codecs):
    _, codec, _ = codecs
    small = _images(1, 64, 64, seed=7)
    host, dev = codec.compress_batch(small)[0], codec.compress_batch(small, coder="device")[0]
    for blobs in ([host, dev], [dev, host]):
        with pytest.raises(ValueError, match="cannot mix"):
            codec.decompress_batch(blobs)
    with pytest.raises(ValueError, match="unknown coder"):
        codec.compress_batch(small, coder="gpu")
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            hific.Codec(codec.model)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            hific.train(_cfg(), common.TrainConfig(patch_size=64))


# -- checkpoints and training ---------------------------------------------------------


def test_jax_g_checkpoint_loads_in_port(tmp_path, model):
    path = str(tmp_path / "jax.msgpack")
    jax_common.save_checkpoint(path, jax_g_params(model), 4)
    loaded = hific.load_model(path, _cfg())
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


def _write_probe_images(tmp_path, n=2):
    rng = np.random.RandomState(0)
    for i in range(n):
        image.write_png(str(tmp_path / f"p{i}.png"),
                        rng.randint(0, 255, (128, 128, 3)).astype(np.uint8))
    return str(tmp_path / "*.png")


def test_train_with_the_rate_probe_and_integral_controller(tmp_path, model):
    """3 steps on the CPU, the probe over PNGs the port wrote, probe_ema and
    hinge_integral: every loss finite, lambda rising (the probe's rate is
    far above the target) inside its clipped bounds, a metrics row a step,
    and the G checkpoint loads in the JAX package."""
    cfg = _cfg(rate_probe_glob=_write_probe_images(tmp_path), rate_probe_every=1,
               probe_ema=0.5, hinge_integral=0.5, target_rate=0.01)
    tcfg = common.TrainConfig(steps=3, batch_size=1, patch_size=64, log_every=1, seed=0,
                              checkpoint_dir=str(tmp_path), checkpoint_name="t.msgpack")
    seen = []
    trained, disc = hific.train(cfg, tcfg, hooks=lambda s, m: seen.append(m), device="cpu")
    with open(tmp_path / "t.msgpack.metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert [int(r["step"]) for r in rows] == [1, 2, 3] and len(seen) == 3
    for m in seen:
        assert all(np.isfinite(v) for v in m.values()), m
        assert m["eval_bpp"] > cfg.target_rate and m["hinge_on"] == 1.0
    lams = [m["lam"] for m in seen]
    mid = float(np.sqrt(cfg.lambda_a * cfg.lambda_b))
    assert mid < lams[0] and lams == sorted(lams)
    assert all(cfg.lambda_b <= v <= cfg.lambda_a for v in lams)
    params, step = jax_common.load_checkpoint(str(tmp_path / "t.msgpack"),
                                              jax_g_params(model))
    assert step == 3
    for k, v in _to_port(params).items():
        assert torch.equal(trained.state_dict()[k], v), k
    assert isinstance(disc, hific.Discriminator)


def test_train_warm_start_and_warm_up(tmp_path, model):
    """params= starts G from the given state dict (one Adam step moves each
    weight by at most ~lr); inside the warm-up D does not move."""
    cfg = _cfg(gan_warmup_steps=5)
    tcfg = common.TrainConfig(steps=1, batch_size=1, patch_size=64, log_every=1, seed=0)
    seen = []
    trained, disc = hific.train(cfg, tcfg, params=model.state_dict(),
                                hooks=lambda s, m: seen.append(m), device="cpu")
    assert seen[0]["gan_on"] == 0.0
    for k, v in model.state_dict().items():
        assert (trained.state_dict()[k] - v).abs().max() <= 2 * cfg.lr + 1e-7, k
    fresh = hific.Discriminator(cfg.num_latents, seed=1)
    for k, p in fresh.named_parameters():
        assert torch.equal(dict(disc.named_parameters())[k].detach(), p.detach()), k


@pytest.mark.parametrize("kind", ["patch", "controller", "no probe images", "shapes"])
def test_train_argument_errors_match_jax(tmp_path, kind):
    cfg, tcfg = _cfg(), common.TrainConfig(steps=1, batch_size=1, patch_size=64)
    if kind == "patch":
        tcfg = dataclasses.replace(tcfg, patch_size=96)
    elif kind == "controller":
        cfg = dataclasses.replace(cfg, hinge_integral=0.5)
    elif kind == "no probe images":
        cfg = dataclasses.replace(cfg, rate_probe_glob=str(tmp_path / "none*.png"))
    else:
        _write_probe_images(tmp_path, 1)
        image.write_png(str(tmp_path / "p9.png"), np.zeros((64, 128, 3), np.uint8))
        cfg = dataclasses.replace(cfg, rate_probe_glob=str(tmp_path / "*.png"))
    with pytest.raises(ValueError) as port_err:
        hific.train(cfg, tcfg, device="cpu")
    if kind in ("patch", "controller"):  # raised before any model is built
        jax_cfg = jax_hific.HificConfig(**dataclasses.asdict(cfg))
        with pytest.raises(ValueError) as jax_err:
            jax_hific.train(jax_cfg, jax_common.TrainConfig(
                steps=1, batch_size=1, patch_size=tcfg.patch_size))
        assert str(port_err.value) == str(jax_err.value)
    else:
        want = "matched no files" if kind == "no probe images" else "share one shape"
        assert want in str(port_err.value)
