"""The port's bls2017 (both archs: bls2017 and bmshj2018-factorized) against
the JAX package's: configuration, the forward, the loss and every
parameter's gradient, the prior's CDF tables, ``compress(y)``, blobs that
cross between the packages both ways, checkpoints with Adam's moments
written by either package, and a few training steps on the CPU. Sizes are
small (8 filters); inputs are seeded NumPy arrays, and the JAX params are
the port's seeded model through the weight bridge."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from compression_tpu.distributions.deep_factorized import DeepFactorized as JaxDeepFactorized
from compression_tpu.models import bls2017 as jax_bls2017
from compression_tpu.models import common as jax_common
from compression_tpu.util import PackedTensors as JaxPackedTensors
from compression_tpu_torch import convert
from compression_tpu_torch.models import bls2017, common

torch.set_num_threads(1)

ARCHS = {"bls2017": dict(num_filters=8),
         "bmshj2018": dict(num_filters=8, num_latents=12, arch="bmshj2018",
                           model_name="bmshj2018-factorized")}
_FIELDS = ("matrices", "biases", "factors")


def _jax_params(model):
    """The port model's weights as the JAX package's param tree."""
    tree = convert.params_to_numpy(model.state_dict())
    prior = tree["prior"].pop("deep_factorized")
    tree = jax.tree_util.tree_map(jnp.asarray, tree)
    tree["prior"]["deep_factorized"] = JaxDeepFactorized(*(
        tuple(jnp.asarray(prior[f][str(i)]) for i in range(len(prior[f])))
        for f in _FIELDS))
    return {"params": tree}


def _to_port(tree):
    """A JAX param-shaped tree (params, grads, moments) as a state dict."""
    return convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(tree)))


def _models(arch, seed=1, **overrides):
    kw = dict(ARCHS[arch], **overrides)
    model = bls2017.BLS2017Model(bls2017.Config(**kw), seed=seed)
    return jax_bls2017.BLS2017Model(jax_bls2017.Config(**kw)), model


def _images(n, h, w, seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([xx / w * 255, yy / h * 255,
                     (np.sin(xx / 5) * np.cos(yy / 7) * 0.5 + 0.5) * 255], -1)
    return np.stack([np.clip(base + rng.randn(h, w, 3) * 8, 0, 255).astype(np.uint8)
                     for _ in range(n)])


class _Quantized:
    """The JAX model with ``training=False`` (deterministic rounding) in
    place of the noise, for the JAX package's own make_loss_fn."""

    def __init__(self, model):
        self.config = model.config
        self._model = model

    def apply(self, params, x, rng, training=True):
        return self._model.apply(params, x, rng, training=False)


# -- configuration and the weight bridge ----------------------------------------


def test_config_fields_match_jax():
    assert dataclasses.asdict(bls2017.Config()) == dataclasses.asdict(jax_bls2017.Config())
    for kw in ARCHS.values():
        assert bls2017.Config(**kw).latent_channels == jax_bls2017.Config(**kw).latent_channels


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_state_dict_round_trips_through_the_flax_tree(arch):
    """The bridge maps the ``prior`` holder beside the transforms, both
    ways; the JAX model takes the tree (same names and shapes as its own
    init) and the optimizer's key paths name it."""
    jax_model, model = _models(arch)
    tree = convert.params_to_numpy(model.state_dict())
    assert sorted(tree) == ["analysis", "prior", "synthesis"]
    back = convert.params_from_numpy({"params": {"params": tree}})
    assert sorted(back) == sorted(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k
    want = jax.eval_shape(lambda: jax_model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), jax.random.PRNGKey(1)))
    got = jax.tree_util.tree_map(lambda a: a.shape, serialization.to_state_dict(
        _jax_params(model)))
    assert got == jax.tree_util.tree_map(lambda a: a.shape,
                                         serialization.to_state_dict(want))
    assert convert.flax_key_path("prior.biases.2") == "params/prior/deep_factorized/1/2"
    with pytest.raises(KeyError, match="unexpected"):
        convert.params_from_numpy({"posterior": {}})


def test_model_is_built_from_a_seed():
    a = bls2017.BLS2017Model(bls2017.Config(num_filters=8), seed=7).state_dict()
    b = bls2017.BLS2017Model(bls2017.Config(num_filters=8), seed=7).state_dict()
    c = bls2017.BLS2017Model(bls2017.Config(num_filters=8), seed=8).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["analysis.conv0.weight"], c["analysis.conv0.weight"])
    assert tuple(a["synthesis.conv2.weight"].shape) == (3, 8, 9, 9)
    with pytest.raises(ValueError, match="arch"):
        bls2017.BLS2017Model(bls2017.Config(arch="bls2018"))


# -- forward, loss and gradients ------------------------------------------------


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_matches_jax(arch):
    """x_hat and the bits per image with training=False, within 1e-5."""
    jax_model, model = _models(arch)
    x = np.random.RandomState(0).rand(2, 64, 48, 3).astype(np.float32)
    want_x, want_bits = jax_model.apply(_jax_params(model), jnp.asarray(x),
                                        jax.random.PRNGKey(0), training=False)
    with torch.no_grad():
        got_x, got_bits = model(torch.from_numpy(x), None, training=False)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_bits.numpy(), np.asarray(want_bits), rtol=1e-5)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_and_every_gradient_match_jax(arch):
    """The loss, its metrics and the gradient of every parameter with
    training=False, against jax.value_and_grad of the JAX package's
    make_loss_fn. Tolerance: loss and metrics 1e-5 relative; each gradient
    1e-3 relative plus 1e-4 of its largest entry (float32 convolutions and
    sums in another order)."""
    jax_model, model = _models(arch, lmbda=0.02)
    x = np.random.RandomState(1).rand(2, 64, 64, 3).astype(np.float32)
    loss_fn = jax_bls2017.make_loss_fn(_Quantized(jax_model))
    (want, want_m), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        _jax_params(model), jnp.asarray(x), jax.random.PRNGKey(0))
    loss, metrics = bls2017.make_loss_fn(model, training=False)(torch.from_numpy(x))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    assert sorted(metrics) == sorted(want_m) == ["bpp", "mse"]
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(want_m[k]), rtol=1e-5)
    want_g = _to_port(grads)
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(want_g)
    for name, p in named.items():
        w = want_g[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-3,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_training_noise_comes_from_the_generator():
    _, model = _models("bls2017")
    x = torch.from_numpy(np.random.RandomState(2).rand(2, 32, 32, 3).astype(np.float32))
    with torch.no_grad():
        a = model(x, torch.Generator().manual_seed(5))
        b = model(x, torch.Generator().manual_seed(5))
        c = model(x, torch.Generator().manual_seed(6))
        with pytest.raises(ValueError, match="generator"):
            model(x)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not torch.equal(a[1], c[1])


# -- the codec ------------------------------------------------------------------


@pytest.fixture(scope="module", params=sorted(ARCHS))
def codecs(request):
    """The JAX codec and the port's, for the same seeded weights; the port's
    built from its own tables, so the tables can be compared."""
    jax_model, model = _models(request.param, seed=3)
    jax_codec = jax_bls2017.Codec(jax_model, _jax_params(model))
    return request.param, jax_codec, model, bls2017.Codec(model, device="cpu")


def test_cdf_tables_equal_jax(codecs):
    _, jax_codec, _, codec = codecs
    want, got = jax_codec.em.tables, codec.em.tables
    for field in ("cdf", "cdf_length", "cdf_offset"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), field)
    assert got.precision == want.precision
    # Float32 root-finds in two libraries (XLA's transcendentals are not
    # correctly rounded): the offsets may differ by a few ulps (seen: 1.9e-6
    # at |offset| 0.49, 16 ulps).
    np.testing.assert_allclose(got.offset, want.offset, rtol=0, atol=1e-5)


def test_compress_of_latents_matches_jax(codecs):
    """``ContinuousBatchedEntropyModel.compress(y)`` (symbols taken on y's
    device) against the JAX model's, on pinned tables; one string per
    leading-batch element."""
    _, jax_codec, model, _ = codecs
    codec = bls2017.Codec(model, device="cpu", tables=jax_codec.em.tables)
    y = np.random.RandomState(4).randn(3, 4, 5, model.config.latent_channels)
    y = (y * 3).astype(np.float32)
    ours = codec.em.compress(torch.from_numpy(y))
    assert ours == jax_codec.em.compress(jnp.asarray(y)) and len(ours) == 3
    back = codec.em.decompress(ours, (4, 5))
    np.testing.assert_array_equal(back, np.asarray(jax_codec.em.decompress(ours, (4, 5))))


def test_blobs_byte_identical_and_cross_decode_on_pinned_tables(codecs):
    arch, jax_codec, model, _ = codecs
    codec = bls2017.Codec(model, device="cpu", tables=jax_codec.em.tables)
    images = _images(2, 70, 100, seed=5)  # padded to 80x112
    for image in images:
        # First: both packages derive the same symbols.
        x = np.pad(image, ((0, 10), (0, 12), (0, 0)), mode="edge")[None]
        jy = jax_codec._analyze(jnp.asarray(x, jnp.float32) / 255.0)
        with torch.inference_mode():
            ty = model.analysis(torch.from_numpy(x).float() / 255.0)
        offset = codec.em.symbol_offset()
        np.testing.assert_array_equal(
            torch.round(ty - offset).numpy(),
            np.round(np.asarray(jy) - offset.numpy()))
        ours, theirs = codec.compress(image), jax_codec.compress(image)
        assert ours == theirs
        packed = JaxPackedTensors(ours)
        assert packed.model == ("bls2017" if arch == "bls2017" else "bmshj2018-factorized")
        assert len([k for k, *_ in packed.describe() if k != "MD"]) == 3
        by_jax, by_port = jax_codec.decompress(ours), codec.decompress(theirs)
        assert by_jax.shape == by_port.shape == image.shape
        # Same symbols, float32 synthesis in two libraries: one level apart
        # at most.
        diff = np.abs(by_jax.astype(np.int16) - by_port.astype(np.int16))
        assert diff.max() <= 1 and np.mean(diff == 0) > 0.99


def test_round_trip_on_cpu(codecs):
    """The decode is the synthesis of the encoder's symbols plus the
    offset; re-compression is byte-identical; the stages are timed."""
    _, _, model, codec = codecs
    image = _images(1, 50, 37, seed=6)[0]  # padded to 64x48
    blob = codec.compress(image)
    out = codec.decompress(blob)
    assert out.shape == image.shape and out.dtype == np.uint8
    x = np.pad(image, ((0, 14), (0, 11), (0, 0)), mode="edge")[None]
    with torch.no_grad():
        y = model.analysis(torch.from_numpy(x).float() / 255.0)
        off = codec.em.symbol_offset()
        x_hat = model.synthesize(torch.round(y - off) + off)
        want = torch.clamp(torch.round(x_hat * 255.0), 0, 255).to(torch.uint8)
    np.testing.assert_array_equal(out, want.numpy()[0, :50, :37])
    assert codec.compress(image) == blob
    assert "enc/code" in codec.timer.report() and "dec/synth" in codec.timer.report()


def test_cuda_is_the_default_and_missing_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the test is for hosts without it")
    _, model = _models("bls2017")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bls2017.Codec(model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bls2017.train(bls2017.Config(num_filters=8), common.TrainConfig(steps=1))


# -- checkpoints and training ------------------------------------------------------


def _trained(arch, cfg, seed=5, updates=2):
    _, model = _models(arch, seed=seed)
    optimizer = common.make_optimizer(model, cfg)
    rng = np.random.RandomState(seed)
    for _ in range(updates):
        for p in model.parameters():
            p.grad = torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
        optimizer.step()
    return model, optimizer


def _adam_state(opt_state):
    for leaf in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState)):
        if isinstance(leaf, optax.ScaleByAdamState):
            return leaf
    raise AssertionError("no Adam state")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_port_checkpoint_loads_in_jax_with_moments(tmp_path, arch):
    cfg = common.TrainConfig(steps=10)
    model, optimizer = _trained(arch, cfg)
    path = str(tmp_path / "ck.msgpack")
    common.save_checkpoint(path, model, 7, optimizer, cfg)
    template = _jax_params(_models(arch, seed=0)[1])
    params, step, opt_state = jax_common.load_checkpoint(
        path, template, optax.adam(cfg.learning_rate).init(template))
    assert step == 7
    for n, t in _to_port(params).items():
        assert torch.equal(t, model.state_dict()[n]), n
    adam = _adam_state(opt_state)
    assert int(adam.count) == 2
    names = dict(model.named_parameters())
    for field, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        for n, t in _to_port(getattr(adam, field)).items():
            assert torch.equal(t, optimizer.state[names[n]][key]), (field, n)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_jax_checkpoint_resumes_in_port_with_moments(tmp_path, arch):
    _, model = _models(arch, seed=6)
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
    _, fresh = _models(arch, seed=9)
    optimizer = common.make_optimizer(fresh, common.TrainConfig(learning_rate=1e-3))
    assert common.restore_checkpoint(path, fresh, optimizer) == (2, True)
    adam = _adam_state(state)
    names = dict(fresh.named_parameters())
    for n, t in _to_port(params).items():
        assert torch.equal(names[n].detach(), t), n
    for field, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        for n, t in _to_port(getattr(adam, field)).items():
            assert torch.equal(optimizer.state[names[n]][key], t), (field, n)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_model_on_cpu(tmp_path, arch):
    """A few steps through common.train_model write the metrics CSV and a
    checkpoint that loads back into the trained model."""
    kw = ARCHS[arch]
    tcfg = common.TrainConfig(batch_size=2, patch_size=32, steps=3, log_every=1,
                              checkpoint_dir=str(tmp_path), checkpoint_name="b.msgpack",
                              seed=1)
    model = bls2017.train(bls2017.Config(**kw), tcfg, device="cpu")
    assert all(torch.isfinite(p).all() for p in model.parameters())
    rows = (tmp_path / "b.msgpack.metrics.csv").read_text().splitlines()
    assert rows[0] == "step,bpp,loss,mse,img_per_s" and len(rows) == 4
    params, step, adam = common.load_checkpoint(str(tmp_path / "b.msgpack"))
    assert step == 3 and adam["count"] == 3
    for n, t in model.state_dict().items():
        assert torch.equal(params[n], t)
    loaded = bls2017.load_model(tmp_path / "b.msgpack", bls2017.Config(**kw))
    for n, t in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[n], t)
