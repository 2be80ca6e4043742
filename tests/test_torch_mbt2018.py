"""The port's mbt2018-mean against the JAX package's: configuration, the
forward (mixed quantization), the loss and every parameter's gradient, the
CDF tables, the symbols, means and rows both sides derive, host- and
device-coded blobs byte-identical and decoded in the other package both
ways, encode at batch 3 with decode at batch 1, the iterators, the
rejections (mixed formats and sizes, a corrupt stream, an overflowed
stream), checkpoints with Adam's moments written by either package, and a
few training steps on the CPU. Sizes are small (8/8/4 filters); inputs are
seeded NumPy arrays, and the JAX params are the port's seeded model
through the weight bridge."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from compression_tpu.distributions.deep_factorized import DeepFactorized as JaxDeepFactorized
from compression_tpu.models import common as jax_common
from compression_tpu.models import device_coding as jax_dc
from compression_tpu.models import mbt2018 as jax_mbt2018
from compression_tpu.util import PackedTensors as JaxPackedTensors
from compression_tpu_torch import convert
from compression_tpu_torch.codec import rans
from compression_tpu_torch.models import common, device_coding, mbt2018

torch.set_num_threads(1)

SMALL = dict(num_filters=8, num_latents=8, num_hyperlatents=4)
_FIELDS = ("matrices", "biases", "factors")


def _jax_params(model):
    """The port model's weights as the JAX package's param tree."""
    tree = convert.params_to_numpy(model.state_dict())
    prior = tree["hyperprior"].pop("deep_factorized")
    tree = jax.tree_util.tree_map(jnp.asarray, tree)
    tree["hyperprior"]["deep_factorized"] = JaxDeepFactorized(*(
        tuple(jnp.asarray(prior[f][str(i)]) for i in range(len(prior[f])))
        for f in _FIELDS))
    return {"params": tree}


def _to_port(tree):
    return convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(tree)))


def _models(seed=1, **overrides):
    kw = dict(SMALL, **overrides)
    model = mbt2018.MBT2018Model(mbt2018.Config(**kw), seed=seed)
    return jax_mbt2018.MBT2018Model(jax_mbt2018.Config(**kw)), model


def _images(n, h, w, seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([xx / w * 255, yy / h * 255,
                     (np.sin(xx / 5) * np.cos(yy / 7) * 0.5 + 0.5) * 255], -1)
    return np.stack([np.clip(base + rng.randn(h, w, 3) * 8, 0, 255).astype(np.uint8)
                     for _ in range(n)])


def _fields(blob):
    return [k for k, *_ in JaxPackedTensors(blob).describe() if k != "MD"]


class _Quantized:
    """The JAX model with ``training=False`` for its own make_loss_fn."""

    def __init__(self, model):
        self.config = model.config
        self._model = model

    def apply(self, params, x, rng, training=True):
        return self._model.apply(params, x, rng, training=False)


# -- configuration, bridge, forward and gradients --------------------------------


def test_config_fields_match_jax():
    assert dataclasses.asdict(mbt2018.Config()) == dataclasses.asdict(jax_mbt2018.Config())
    cfg = mbt2018.Config()
    assert (cfg.num_filters, cfg.num_latents, cfg.num_hyperlatents) == (192, 320, 192)


def test_param_tree_matches_jax_init_and_round_trips():
    jax_model, model = _models()
    want = jax.eval_shape(lambda: jax_model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), jax.random.PRNGKey(1)))
    got = serialization.to_state_dict(_jax_params(model))
    assert jax.tree_util.tree_map(lambda a: a.shape, got) == jax.tree_util.tree_map(
        lambda a: a.shape, serialization.to_state_dict(want))
    assert got["params"]["hyper_synthesis"]["conv2"]["kernel"].shape == (3, 3, 12, 16)
    back = convert.params_from_numpy(convert.params_to_numpy(model.state_dict()))
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k


def test_forward_matches_jax():
    """x_hat and both rates with training=False, within 1e-5; the model's
    pieces (latents, then mu and sigma from the rounded z) as well."""
    jax_model, model = _models()
    params = _jax_params(model)
    x = np.random.RandomState(0).rand(2, 64, 128, 3).astype(np.float32)
    want = jax_model.apply(params, jnp.asarray(x), jax.random.PRNGKey(0), training=False)
    with torch.no_grad():
        got = model(torch.from_numpy(x), None, training=False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    y, z = jax_model.apply(params, jnp.asarray(x), method=jax_mbt2018.MBT2018Model.encode_latents)
    mu, sigma = jax_model.apply(params, jnp.round(z),
                                method=jax_mbt2018.MBT2018Model.params_from_zhat)
    with torch.no_grad():
        ty, tz = model.encode_latents(torch.from_numpy(x))
        tmu, tsigma = model.params_from_zhat(torch.round(tz))
    for g, w in ((ty, y), (tz, z), (tmu, mu), (tsigma, sigma)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("distortion", ["mse", "msssim"])
def test_loss_and_every_gradient_match_jax(distortion):
    """The loss, its metrics and the gradient of every parameter with
    training=False, against jax.value_and_grad of the JAX package's
    make_loss_fn. Tolerance: loss and metrics 1e-5 relative; each gradient
    1e-3 relative plus 1e-4 of its largest entry."""
    jax_model, model = _models(lmbda=0.02, distortion=distortion)
    x = np.random.RandomState(1).rand(2, 64, 64, 3).astype(np.float32)
    loss_fn = jax_mbt2018.make_loss_fn(_Quantized(jax_model))
    (want, want_m), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        _jax_params(model), jnp.asarray(x), jax.random.PRNGKey(0))
    loss, metrics = mbt2018.make_loss_fn(model, training=False)(torch.from_numpy(x))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    assert sorted(metrics) == sorted(want_m) == sorted(["bpp", distortion])
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(want_m[k]), rtol=1e-5)
    want_g = _to_port(grads)
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(want_g)
    for name, p in named.items():
        w = want_g[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-3,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_training_forward_uses_noise_and_rounded_inputs():
    """training=True: the rates move with the generator's noise, the
    reconstruction does not (the synthesis reads y rounded around mu)."""
    _, model = _models(seed=2)
    x = torch.from_numpy(np.random.RandomState(2).rand(2, 64, 64, 3).astype(np.float32))
    with torch.no_grad():
        a = model(x, torch.Generator().manual_seed(5))
        b = model(x, torch.Generator().manual_seed(6))
        q = model(x, None, training=False)
        with pytest.raises(ValueError, match="generator"):
            model(x)
    assert torch.equal(a[0], b[0]) and torch.equal(a[0], q[0])
    assert not torch.equal(a[1], b[1]) and not torch.equal(a[2], b[2])


# -- the codec ------------------------------------------------------------------


@pytest.fixture(scope="module")
def codecs():
    """The JAX codec, and the port's on its own tables and on the JAX
    package's (pinned), for the same seeded weights."""
    jax_model, model = _models(seed=3)
    jax_codec = jax_mbt2018.Codec(jax_model, _jax_params(model))
    own = mbt2018.Codec(model, device="cpu")
    pinned = mbt2018.Codec(model, device="cpu", tables={
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


def test_symbols_means_and_rows_match_jax(codecs):
    jax_codec, _, codec = codecs
    images = _images(2, 64, 128, seed=4)
    y, z = jax_codec._encode(jnp.asarray(images))
    jz_sym = jax_codec._z_symbols(z)
    jz_hat = jax_codec._z_hat(jz_sym)
    jmu, jsigma = jax_codec._params(jz_hat)
    jsym = jax_codec._center_round(y, jmu)
    with torch.inference_mode():
        ty, tz_sym, tz_hat = codec._front(torch.from_numpy(images))
        tmu, trows = codec._mu_rows(tz_hat)
        tsym = codec._center_round(ty, tmu)
    np.testing.assert_array_equal(tz_sym.numpy(), np.asarray(jz_sym))
    np.testing.assert_array_equal(tz_hat.numpy(), np.asarray(jz_hat))
    np.testing.assert_array_equal(tsym.numpy(), np.asarray(jsym))
    np.testing.assert_array_equal(trows.numpy(), np.asarray(jax_codec.em.rows(jsigma)))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), rtol=1e-5, atol=1e-6)


def _cross_decode(jax_codec, codec, ours, theirs):
    by_jax = jax_codec.decompress_batch(ours)
    by_port = codec.decompress_batch(theirs)
    assert by_jax.shape == by_port.shape
    # Same symbols in, float32 synthesis in two libraries: one level apart
    # at most.
    diff = np.abs(by_jax.astype(np.int16) - by_port.astype(np.int16))
    assert diff.max() <= 1 and np.mean(diff == 0) > 0.99
    return by_jax, by_port


def test_host_blobs_byte_identical_and_cross_decode(codecs):
    jax_codec, _, codec = codecs
    images = _images(2, 64, 128, seed=4)
    ours, theirs = codec.compress_batch(images), jax_codec.compress_batch(images)
    assert ours == theirs
    for blob in ours:
        assert len(_fields(blob)) == 4 and JaxPackedTensors(blob).model == "mbt2018-mean"
    _cross_decode(jax_codec, codec, ours, theirs)


def test_device_blobs_byte_identical_and_cross_decode(codecs):
    """The port's device-coded stages against the JAX package's
    dispatch_encode_rans / finish_encode_rans: the same 5-field blobs; each
    package decodes the other's, and within a package the device-coded
    decode equals the host-coded one."""
    jax_codec, _, codec = codecs
    images = _images(2, 64, 128, seed=4)
    ours = device_coding.finish_encode_rans(
        codec, device_coding.dispatch_encode_rans(codec, images))
    theirs = jax_dc.finish_encode_rans(jax_codec, jax_dc.dispatch_encode_rans(jax_codec, images))
    assert ours == theirs == codec.compress_batch(images, coder="device")
    for blob in ours:
        assert len(_fields(blob)) == 5
        assert int(JaxPackedTensors(blob).unpack_one(4, np.int32)[0]) == 16  # N = 256
    by_jax, by_port = _cross_decode(jax_codec, codec, ours, theirs)
    np.testing.assert_array_equal(
        by_port, codec.decompress_batch(codec.compress_batch(images)))
    np.testing.assert_array_equal(
        by_jax, jax_codec.decompress_batch(jax_codec.compress_batch(images)))
    np.testing.assert_array_equal(device_coding.decompress_batch_rans(codec, theirs), by_port)


@pytest.mark.parametrize("coder", ["host", "device"])
def test_encode_at_batch_3_decode_at_batch_1(codecs, coder):
    """The rows come from one function on both sides, one image at a time,
    so a blob decodes the same alone or in a batch; re-compression is
    byte-identical; the iterators give the one-shot results."""
    _, codec, _ = codecs
    images = _images(3, 70, 100, seed=5)  # padded to 128x128
    blobs = codec.compress_batch(images, coder=coder)
    out = codec.decompress_batch(blobs)
    assert out.shape == images.shape and out.dtype == np.uint8
    for b in range(3):
        np.testing.assert_array_equal(codec.decompress(blobs[b]), out[b])
    assert codec.compress_batch(images, coder=coder) == blobs
    assert [codec.compress(im, coder=coder) for im in images] == blobs
    piped = list(codec.compress_iter([images[:1], images[1:]], coder=coder))
    assert piped[0] + piped[1] == blobs
    np.testing.assert_array_equal(
        np.concatenate(list(codec.decompress_iter(piped))), out)
    stage = "enc/fetch_stream" if coder == "device" else "enc/code_y"
    assert stage in codec.timer.report()


def test_decode_is_the_synthesis_of_the_rounded_latents(codecs):
    _, codec, _ = codecs
    images = _images(2, 64, 64, seed=6)
    out = codec.decompress_batch(codec.compress_batch(images, coder="device"))
    model = codec.model
    with torch.no_grad():
        y, z = model.encode_latents(torch.from_numpy(images).float() / 255.0)
        off = codec.side_em.symbol_offset()
        mu, _ = model.params_from_zhat(torch.round(z - off) + off)
        x_hat = model.synthesize(torch.round(y - mu) + mu)
    want = torch.clamp(torch.round(x_hat * 255.0), 0, 255).to(torch.uint8).numpy()
    np.testing.assert_array_equal(out, want)


def test_rejects_mixed_formats_and_sizes(codecs):
    _, codec, _ = codecs
    small, big = _images(1, 64, 64, seed=7), _images(1, 64, 128, seed=7)
    host_s, host_b = codec.compress_batch(small)[0], codec.compress_batch(big)[0]
    dev_s = codec.compress_batch(small, coder="device")[0]
    dev_b = codec.compress_batch(big, coder="device")[0]
    with pytest.raises(ValueError, match="cannot mix"):
        codec.decompress_batch([host_s, dev_s])
    with pytest.raises(ValueError, match="cannot mix"):
        codec.decompress_batch([dev_s, host_s])
    with pytest.raises(ValueError, match="same-size"):
        codec.decompress_batch([host_s, host_b])
    with pytest.raises(ValueError, match="same-size"):
        codec.decompress_batch([dev_s, dev_b])
    with pytest.raises(ValueError, match="same-size"):
        device_coding.decompress_batch_rans(codec, [dev_s, dev_b])
    with pytest.raises(ValueError, match="cannot mix"):
        device_coding.decompress_batch_rans(codec, [dev_s, host_s])
    with pytest.raises(ValueError, match="unknown coder"):
        codec.compress_batch(small, coder="gpu")


def test_corrupt_device_stream_raises(codecs):
    _, codec, _ = codecs
    blob = codec.compress(_images(1, 64, 64, seed=8)[0], coder="device")
    packed = JaxPackedTensors(blob)
    fields = packed.unpack([object, object, np.int32, np.int32, np.int32])
    words = bytearray(bytes(fields[0][0]))
    words[len(words) // 2] ^= 0xFF
    bad = JaxPackedTensors()
    bad.model = packed.model
    bad.pack([bytes(words), bytes(fields[1][0])] + [np.asarray(f) for f in fields[2:]])
    with pytest.raises(ValueError, match="rANS"):
        codec.decompress(bad.string)


def test_overflow_raises_as_in_jax():
    """An overflowed stream raises (the JAX package's behaviour for the
    mean-scale codecs; bmshj2018's codec falls back to the host coder)."""
    _, model = _models(seed=4)
    codec = mbt2018.Codec(model, device="cpu")
    images = _images(2, 64, 64, seed=9)
    N = 4 * 4 * SMALL["num_latents"]
    _enc, dec, K, _cap = device_coding.rans_for(codec, N)
    codec._rans_cache[(N, K)] = (rans.make_rans_encoder(codec.em.tables, K, 8), dec, K, 8)
    with pytest.raises(ValueError, match="capacity"):
        codec.compress_batch(images, coder="device")
    assert len(_fields(codec.compress_batch(images)[0])) == 4


def test_cuda_is_the_default_and_missing_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the test is for hosts without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mbt2018.Codec(_models()[1])


# -- checkpoints and training ------------------------------------------------------


def _adam_state(opt_state):
    for leaf in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState)):
        if isinstance(leaf, optax.ScaleByAdamState):
            return leaf
    raise AssertionError("no Adam state")


@pytest.mark.parametrize("scales", [None, (("params/hyperprior", 10.0),)])
def test_port_checkpoint_loads_in_jax_with_moments(tmp_path, scales):
    cfg = common.TrainConfig(steps=10, lr_scales=scales)
    _, model = _models(seed=5)
    optimizer = common.make_optimizer(model, cfg)
    rng = np.random.RandomState(5)
    for _ in range(2):
        for p in model.parameters():
            p.grad = torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
        optimizer.step()
    path = str(tmp_path / "ck.msgpack")
    common.save_checkpoint(path, model, 7, optimizer, cfg)
    template = _jax_params(_models(seed=0)[1])
    tx = optax.adam(cfg.learning_rate)
    if scales:
        tx = optax.chain(tx, jax_common._scale_by_path(scales))
    params, step, opt_state = jax_common.load_checkpoint(path, template, tx.init(template))
    assert step == 7
    for n, t in _to_port(params).items():
        assert torch.equal(t, model.state_dict()[n]), n
    adam = _adam_state(opt_state)
    assert int(adam.count) == 2
    names = dict(model.named_parameters())
    for field, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        for n, t in _to_port(getattr(adam, field)).items():
            assert torch.equal(t, optimizer.state[names[n]][key]), (field, n)


def test_jax_checkpoint_resumes_in_port_with_moments(tmp_path):
    _, model = _models(seed=6)
    params = _jax_params(model)
    tx = optax.adam(1e-3)
    state = tx.init(params)
    rng = np.random.RandomState(1)
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32)), params)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    path = str(tmp_path / "jax.msgpack")
    jax_common.save_checkpoint(path, params, 2, state)
    _, fresh = _models(seed=9)
    optimizer = common.make_optimizer(fresh, common.TrainConfig(learning_rate=1e-3))
    assert common.restore_checkpoint(path, fresh, optimizer) == (2, True)
    adam = _adam_state(state)
    names = dict(fresh.named_parameters())
    for n, t in _to_port(params).items():
        assert torch.equal(names[n].detach(), t), n
    for field, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        for n, t in _to_port(getattr(adam, field)).items():
            assert torch.equal(optimizer.state[names[n]][key], t), (field, n)


def test_train_model_on_cpu(tmp_path):
    tcfg = common.TrainConfig(batch_size=2, patch_size=64, steps=3, log_every=1,
                              checkpoint_dir=str(tmp_path), checkpoint_name="m.msgpack",
                              seed=1)
    seen = []
    model = mbt2018.MBT2018Model(mbt2018.Config(**SMALL), seed=1)
    common.train_model(model, mbt2018.make_loss_fn(model), tcfg,
                       hooks=lambda s, m: seen.append((s, sorted(m))), device="cpu")
    assert seen == [(s, ["bpp", "loss", "mse"]) for s in (1, 2, 3)]
    assert all(torch.isfinite(p).all() for p in model.parameters())
    params, step, adam = common.load_checkpoint(str(tmp_path / "m.msgpack"))
    assert step == 3 and adam["count"] == 3
    loaded = mbt2018.load_model(tmp_path / "m.msgpack", mbt2018.Config(**SMALL))
    for n, t in model.state_dict().items():
        assert torch.equal(params[n], t) and torch.equal(loaded.state_dict()[n], t)
    again = mbt2018.train(mbt2018.Config(**SMALL), dataclasses.replace(
        tcfg, checkpoint_dir=str(tmp_path / "again")), device="cpu")
    for n, t in model.state_dict().items():
        assert torch.equal(again.state_dict()[n], t), n  # seeded: reproducible
