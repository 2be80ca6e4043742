"""The port's ms2020 (CHARM) against the JAX package's: configuration, the
param tree, the forward (mixed quantization) and its pieces slice by slice,
the loss and every parameter's gradient at mse and msssim, the CDF tables,
each slice's symbols, means and rows, host- and device-coded blobs
byte-identical and decoded in the other package both ways, encode at batch
3 with decode at batch 1, batch encode equal to per-image encode, the
iterators and the pipelined decode (the shared pipeline's decode equal to
the one-batch decode for each format and for batches of both), the rejections (mixed formats and
sizes, a corrupt stream, an overflowed stream), checkpoints with Adam's
moments written by either package, and a few training steps on the CPU.
Sizes are small (8 filters, 8 latents in 4 slices, 4 hyperlatents; the
hyper and slice transforms keep their fixed widths); inputs are seeded
NumPy arrays, and the JAX params are the port's seeded model through the
weight bridge."""

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
from compression_tpu.models import ms2020 as jax_ms2020
from compression_tpu.util import PackedTensors as JaxPackedTensors
from compression_tpu_torch import convert
from compression_tpu_torch.codec import rans
from compression_tpu_torch.models import common, device_coding, ms2020
from compression_tpu_torch.parallel.charm_pipeline import decompress_batch_pipelined

torch.set_num_threads(1)

SMALL = dict(num_filters=8, num_latents=8, num_hyperlatents=4, num_slices=4)
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
    model = ms2020.MS2020Model(ms2020.Config(**kw), seed=seed)
    return jax_ms2020.MS2020Model(jax_ms2020.Config(**kw)), model


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
    assert dataclasses.asdict(ms2020.Config()) == dataclasses.asdict(jax_ms2020.Config())
    cfg = ms2020.Config()
    assert (cfg.num_filters, cfg.num_latents, cfg.num_hyperlatents) == (192, 320, 192)
    assert (cfg.num_slices, cfg.slice_size, cfg.max_support_slices) == (10, 32, 5)


def test_param_tree_matches_jax_and_round_trips():
    """The bridge maps the 35 holders of the full-width tree by their
    structure; at the small size the tree has the JAX init's names and
    shapes, and the LRP transforms start at zero."""
    jax_model, model = _models()
    want = jax.eval_shape(lambda: jax_model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), jax.random.PRNGKey(1)))
    got = serialization.to_state_dict(_jax_params(model))
    assert jax.tree_util.tree_map(lambda a: a.shape, got) == jax.tree_util.tree_map(
        lambda a: a.shape, serialization.to_state_dict(want))
    assert got["params"]["mean_t3"]["conv0"]["kernel"].shape == (5, 5, 8 + 3 * 2, 224)
    assert got["params"]["lrp_t3"]["conv0"]["kernel"].shape == (5, 5, 8 + 4 * 2, 224)
    back = convert.params_from_numpy(convert.params_to_numpy(model.state_dict()))
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k
    for i in range(4):
        assert not getattr(model, f"lrp_t{i}").conv2.weight.any()
    full = convert.params_to_numpy(ms2020.MS2020Model(ms2020.Config()).state_dict())
    assert len(full) == 36 and "deep_factorized" in full["hyperprior"]
    assert full["lrp_t9"]["conv0"]["kernel"].shape == (5, 5, 512, 224)
    assert full["mean_t9"]["conv0"]["kernel"].shape == (5, 5, 480, 224)


def test_forward_and_each_slice_match_jax():
    """x_hat and both rates with training=False, within 1e-5; the latents,
    the supports from the rounded z, and every slice's (mu, sigma) and LRP
    along the decoder's chain."""
    jax_model, model = _models()
    params = _jax_params(model)
    x = np.random.RandomState(0).rand(2, 64, 128, 3).astype(np.float32)
    want = jax_model.apply(params, jnp.asarray(x), jax.random.PRNGKey(0), training=False)
    with torch.no_grad():
        got = model(torch.from_numpy(x), None, training=False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    M = jax_ms2020.MS2020Model
    y, z = jax_model.apply(params, jnp.asarray(x), method=M.encode_latents)
    sup = jax_model.apply(params, jnp.round(z), method=M.supports_from_zhat)
    with torch.no_grad():
        ty, tz = model.encode_latents(torch.from_numpy(x))
        tsup = model.supports_from_zhat(torch.round(tz))
    for g, w in ((ty, y), (tz, z)) + tuple(zip(tsup, sup)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    decoded, tdecoded = [], []
    for i in range(4):
        mu, sigma = jax_model.apply(params, i, *sup, decoded, method=M.slice_params)
        y_hat = jnp.round(y[..., 2 * i : 2 * i + 2] - mu) + mu
        lrp = jax_model.apply(params, i, sup[0], decoded + [y_hat], method=M.slice_lrp)
        decoded.append(y_hat + lrp)
        with torch.no_grad():
            tmu, tsigma = model.slice_params(i, *tsup, tdecoded)
            ty_hat = torch.from_numpy(np.array(y_hat))
            tlrp = model.slice_lrp(i, tsup[0], tdecoded + [ty_hat])
        tdecoded.append(torch.from_numpy(np.array(decoded[-1])))
        for g, w in ((tmu, mu), (tsigma, sigma), (tlrp, lrp)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("distortion", ["mse", "msssim"])
def test_loss_and_every_gradient_match_jax(distortion):
    """The loss, its metrics and the gradient of every parameter with
    training=False, against jax.value_and_grad of the JAX package's
    make_loss_fn. Tolerance: loss and metrics 1e-5 relative; each gradient
    1e-3 relative plus 1e-4 of its largest entry."""
    jax_model, model = _models(lmbda=0.02, distortion=distortion)
    x = np.random.RandomState(1).rand(2, 64, 64, 3).astype(np.float32)
    loss_fn = jax_ms2020.make_loss_fn(_Quantized(jax_model))
    (want, want_m), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        _jax_params(model), jnp.asarray(x), jax.random.PRNGKey(0))
    loss, metrics = ms2020.make_loss_fn(model, training=False)(torch.from_numpy(x))
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
    # The autoregressive conditioning is live: a later slice's mean
    # transform and every LRP's last layer get gradient.
    assert model.mean_t1.conv0.weight.grad.abs().max() > 0
    assert all(getattr(model, f"lrp_t{i}").conv2.weight.grad.abs().max() > 0 for i in range(4))


def test_training_forward_uses_noise_and_rounded_inputs():
    """training=True: the rates move with the generator's noise, the
    reconstruction does not (the chain reads y rounded around each mu)."""
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
    jax_codec = jax_ms2020.Codec(jax_model, _jax_params(model))
    own = ms2020.Codec(model, device="cpu")
    pinned = ms2020.Codec(model, device="cpu", tables={
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


def test_each_slices_symbols_means_and_rows_match_jax(codecs):
    """The JAX codec's own per-slice functions along its chain against the
    port's: z symbols, and each slice's symbols and rows equal, its mean
    within 1e-5."""
    jax_codec, _, codec = codecs
    images = _images(2, 64, 128, seed=4)
    y, z = jax_codec._encode(jnp.asarray(images))
    jz_sym = jax_codec._z_symbols(z)
    ms, ss = jax_codec._supports(jax_codec._z_hat(jz_sym))
    with torch.inference_mode():
        syms, z_sym, rows, hw = codec._encode_slices(images)
        ty, _, tz_hat = codec._front(torch.from_numpy(images))
        sups = codec._supports(tz_hat)
        tdecoded = [[] for _ in range(2)]
    np.testing.assert_array_equal(z_sym.numpy(), np.asarray(jz_sym))
    assert hw == (64, 128) and len(syms) == len(rows) == 4
    decoded = []
    for i in range(4):
        mu, sigma = jax_codec._slice_params(i, ms, ss, decoded)
        sym = jax_codec._center_round(jax_codec._take_slice(y, i), mu)
        decoded.append(jax_codec._finish_slice(i, ms, decoded, jax_codec._apply_loc(sym, mu)))
        with torch.inference_mode():
            tmu, trows = codec._slice_rows(i, sups, tdecoded)
            codec._finish_slices(i, sups, tdecoded, codec._apply_loc(syms[i], tmu))
        np.testing.assert_array_equal(syms[i].numpy(), np.asarray(sym), f"slice {i}")
        np.testing.assert_array_equal(rows[i].numpy(), np.asarray(jax_codec.em.rows(sigma)))
        np.testing.assert_array_equal(trows.numpy(), rows[i].numpy())
        np.testing.assert_allclose(tmu.numpy(), np.asarray(mu), rtol=1e-5, atol=1e-5)


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
        assert len(_fields(blob)) == 4 + 3 and JaxPackedTensors(blob).model == "ms2020-cc10"
    _cross_decode(jax_codec, codec, ours, theirs)


def test_device_blobs_byte_identical_and_cross_decode(codecs):
    """Device-coded blobs (one rANS stream a slice, [K] last) equal to the
    JAX package's; each package decodes the other's, and within a package
    the device-coded decode equals the host-coded one."""
    jax_codec, _, codec = codecs
    images = _images(2, 64, 128, seed=4)
    ours = codec.compress_batch(images, coder="device")
    theirs = jax_codec.compress_batch(images, coder="device")
    assert ours == theirs
    for blob in ours:
        assert len(_fields(blob)) == 4 + 4
        assert int(JaxPackedTensors(blob).unpack_one(7, np.int32)[0]) == 4  # N = 64
    by_jax, by_port = _cross_decode(jax_codec, codec, ours, theirs)
    np.testing.assert_array_equal(
        by_port, codec.decompress_batch(codec.compress_batch(images)))
    np.testing.assert_array_equal(
        by_jax, jax_codec.decompress_batch(jax_codec.compress_batch(images)))


@pytest.mark.parametrize("coder", ["host", "device"])
def test_encode_at_batch_3_decode_at_batch_1(codecs, coder):
    """The slice chain runs one image at a time on both sides, so a blob
    decodes the same alone or in a batch; batch encode is byte-identical to
    per-image encode; the iterators and the pipelined decode give the
    one-shot results in input order."""
    _, codec, _ = codecs
    images = _images(3, 70, 100, seed=5)  # padded to 128x128
    blobs = codec.compress_batch(images, coder=coder)
    assert [codec.compress(im, coder=coder) for im in images] == blobs
    out = codec.decompress_batch(blobs)
    assert out.shape == images.shape and out.dtype == np.uint8
    for b in range(3):
        np.testing.assert_array_equal(codec.decompress(blobs[b]), out[b])
    assert codec.compress_batch(images, coder=coder) == blobs
    piped = list(codec.compress_iter([images[:1], images[1:]], coder=coder))
    assert piped[0] + piped[1] == blobs
    np.testing.assert_array_equal(
        np.concatenate(list(codec.decompress_iter(piped))), out)
    stage = "enc/fetch_stream" if coder == "device" else "enc/code_y"
    assert stage in codec.timer.report() and "dec/code_z" in codec.timer.report()


def test_pipelined_decode_keeps_input_order(codecs):
    """decompress_batch_pipelined over blobs of two sizes and both formats,
    interleaved, in batches of 2: each output equals the blob's serial
    decode, in input order."""
    _, codec, _ = codecs
    small, big = _images(3, 64, 64, seed=6), _images(2, 64, 128, seed=7)
    blobs = [codec.compress(small[0]), codec.compress(big[0], coder="device"),
             codec.compress(small[1]), codec.compress(small[2], coder="device"),
             codec.compress(big[1]), codec.compress(small[1], coder="device")]
    out = decompress_batch_pipelined(codec, blobs, depth=2, batch_size=2)
    assert len(out) == len(blobs)
    for blob, image in zip(blobs, out):
        np.testing.assert_array_equal(image, codec.decompress(blob))
    np.testing.assert_array_equal(out[2], out[5])  # same image, either coder


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("coders", [("device",) * 3, ("host",) * 3,
                                    ("device", "host", "device", "host")],
                         ids=["device", "host", "mixed"])
def test_decompress_iter_gives_what_decompress_batch_gives(codecs, coders, depth):
    """The decode runs on the codecs' shared pipeline (no override of
    ``decompress_iter``): each batch, of either coder's blobs and in an
    iterable whose batches alternate between the formats, comes back byte
    for byte as the one-batch decode gives it, in order."""
    from compression_tpu_torch.models.codec_base import HyperpriorCodec

    assert ms2020.Codec.decompress_iter is HyperpriorCodec.decompress_iter
    _, codec, _ = codecs
    batches = [_images(2, 64, 64, seed=20 + i) for i in range(len(coders))]
    blobs = [codec.compress_batch(b, coder=c) for b, c in zip(batches, coders)]
    assert [codec._is_device_coded(b[0]) for b in blobs] == [c == "device" for c in coders]
    want = [codec.decompress_batch(b) for b in blobs]
    got = list(codec.decompress_iter(iter(blobs), depth=depth))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, 64, 64, 3) and g.dtype == np.uint8
        assert g.tobytes() == w.tobytes()


def test_decode_is_the_synthesis_of_the_chain(codecs):
    """The reconstruction is the synthesis of the slices the model's own
    functions give for the rounded latents (supports from z rounded on its
    offset grid, each slice rounded around its mean plus its LRP)."""
    _, codec, _ = codecs
    images = _images(2, 64, 64, seed=8)
    out = codec.decompress_batch(codec.compress_batch(images, coder="device"))
    model = codec.model
    want = []
    with torch.no_grad():
        for b in range(2):
            y, z = model.encode_latents(torch.from_numpy(images[b : b + 1]).float() / 255.0)
            off = codec.side_em.symbol_offset()
            mu_sup, sigma_sup = model.supports_from_zhat(torch.round(z - off) + off)
            decoded = []
            for i in range(4):
                mu, _ = model.slice_params(i, mu_sup, sigma_sup, decoded)
                y_hat = torch.round(y[..., 2 * i : 2 * i + 2] - mu) + mu
                decoded.append(y_hat + model.slice_lrp(i, mu_sup, decoded + [y_hat]))
            x_hat = model.synthesize(torch.cat(decoded, -1))
            want.append(torch.clamp(torch.round(x_hat * 255.0), 0, 255).to(torch.uint8))
    np.testing.assert_array_equal(out, torch.cat(want).numpy())


def test_rejects_mixed_formats_and_sizes(codecs):
    _, codec, _ = codecs
    small, big = _images(1, 64, 64, seed=7), _images(1, 64, 128, seed=7)
    host_s, host_b = codec.compress_batch(small)[0], codec.compress_batch(big)[0]
    dev_s = codec.compress_batch(small, coder="device")[0]
    dev_b = codec.compress_batch(big, coder="device")[0]
    assert codec._is_device_coded(dev_s) and not codec._is_device_coded(host_s)
    # The shared 5-field check cannot tell ms2020's formats apart.
    assert not device_coding.is_device_coded(dev_s)
    with pytest.raises(ValueError, match="cannot mix"):
        codec.decompress_batch([host_s, dev_s])
    with pytest.raises(ValueError, match="cannot mix"):
        codec.decompress_batch([dev_s, host_s])
    with pytest.raises(ValueError, match="same-size"):
        codec.decompress_batch([host_s, host_b])
    with pytest.raises(ValueError, match="same-size"):
        codec.decompress_batch([dev_s, dev_b])
    with pytest.raises(ValueError, match="unknown coder"):
        codec.compress_batch(small, coder="gpu")


def test_corrupt_device_stream_raises(codecs):
    _, codec, _ = codecs
    blob = codec.compress(_images(1, 64, 64, seed=8)[0], coder="device")
    packed = JaxPackedTensors(blob)
    fields = packed.unpack([object] * 5 + [np.int32] * 3)
    words = bytearray(bytes(fields[2][0]))  # slice 2
    words[len(words) // 2] ^= 0xFF
    bad = JaxPackedTensors()
    bad.model = packed.model
    bad.pack([bytes(f[0]) for f in fields[:2]] + [bytes(words)]
             + [bytes(f[0]) for f in fields[3:5]] + [np.asarray(f) for f in fields[5:]])
    with pytest.raises(ValueError, match="rANS"):
        codec.decompress(bad.string)


def test_overflow_raises_as_in_jax():
    """An overflowed slice stream raises (the JAX package's ms2020 raises,
    it does not fall back); the host coder still codes the batch."""
    _, model = _models(seed=4)
    codec = ms2020.Codec(model, device="cpu")
    images = _images(2, 64, 64, seed=9)
    N = 4 * 4 * 2
    _enc, dec, K, _cap = device_coding.rans_for(codec, N)
    # A cap below the 2K-word state flush: every stream overflows.
    codec._rans_cache[(N, K)] = (rans.make_rans_encoder(codec.em.tables, K, 4), dec, K, 4)
    with pytest.raises(ValueError, match="capacity"):
        codec.compress_batch(images, coder="device")
    assert len(_fields(codec.compress_batch(images)[0])) == 7


def test_cuda_is_the_default_and_missing_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the test is for hosts without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ms2020.Codec(_models()[1])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ms2020.train(ms2020.Config(**SMALL), common.TrainConfig(steps=1))


# -- checkpoints and training ------------------------------------------------------


def _adam_state(opt_state):
    for leaf in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState)):
        if isinstance(leaf, optax.ScaleByAdamState):
            return leaf
    raise AssertionError("no Adam state")


def test_port_checkpoint_loads_in_jax_with_moments(tmp_path):
    cfg = common.TrainConfig(steps=10, lr_schedule="cosine")
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
    tx = optax.adam(optax.cosine_decay_schedule(cfg.learning_rate, cfg.steps, 0.1))
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


def test_train_on_cpu(tmp_path):
    tcfg = common.TrainConfig(batch_size=2, patch_size=64, steps=2, log_every=1,
                              checkpoint_dir=str(tmp_path), checkpoint_name="m.msgpack",
                              seed=1)
    model = ms2020.train(ms2020.Config(**SMALL), tcfg, device="cpu")
    assert all(torch.isfinite(p).all() for p in model.parameters())
    rows = (tmp_path / "m.msgpack.metrics.csv").read_text().splitlines()
    assert rows[0] == "step,bpp,loss,mse,img_per_s" and len(rows) == 3
    params, step, adam = common.load_checkpoint(str(tmp_path / "m.msgpack"))
    assert step == 2 and adam["count"] == 2
    loaded = ms2020.load_model(tmp_path / "m.msgpack", ms2020.Config(**SMALL))
    for n, t in model.state_dict().items():
        assert torch.equal(params[n], t) and torch.equal(loaded.state_dict()[n], t)
