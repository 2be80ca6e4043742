"""The port's b2018 (both activations) against the JAX package's:
configuration, the param tree and the gains' init, the forward at a scalar
quality and at one quality per example, the loss and every parameter's
gradient, the (quality, channel) prior's CDF tables, blobs byte-identical
at every quality and decoded in the other package both ways, the quality
checks, checkpoints with Adam's moments (the rate-point ``lr_scales``
layout) written by either package, and a few training steps on the CPU.
Sizes are small (8 filters, 4 qualities); inputs are seeded NumPy arrays,
and the JAX params are the port's seeded model through the weight
bridge."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from compression_tpu.distributions.deep_factorized import DeepFactorized as JaxDeepFactorized
from compression_tpu.entropy_models.continuous_base import CdfTables
from compression_tpu.models import b2018 as jax_b2018
from compression_tpu.models import common as jax_common
from compression_tpu.util import PackedTensors as JaxPackedTensors
from compression_tpu_torch import convert
from compression_tpu_torch.models import b2018, common

torch.set_num_threads(1)

ACTIVATIONS = ("gdn", "leaky_relu")
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
    return convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(tree)))


def _models(activation="gdn", seed=1, **overrides):
    kw = dict(num_filters=8, activation=activation,
              model_name=f"b2018-{activation}-8", **overrides)
    model = b2018.B2018Model(b2018.Config(**kw), seed=seed)
    return jax_b2018.B2018Model(jax_b2018.Config(**kw)), model


def _images(n, h, w, seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([xx / w * 255, yy / h * 255,
                     (np.sin(xx / 5) * np.cos(yy / 7) * 0.5 + 0.5) * 255], -1)
    return np.stack([np.clip(base + rng.randn(h, w, 3) * 8, 0, 255).astype(np.uint8)
                     for _ in range(n)])


class _Quantized:
    """The JAX model with ``training=False`` for its own make_loss_fn."""

    def __init__(self, model):
        self.config = model.config
        self._model = model

    def apply(self, params, x, rng, q, training=True):
        return self._model.apply(params, x, rng, q, training=False)


def _key_with_offset_zero(num_qualities):
    """A key for the JAX loss whose quality rotation is 0, the port's
    rotation without a generator."""
    for k in range(200):
        rng_q, _ = jax.random.split(jax.random.PRNGKey(k))
        if int(jax.random.randint(rng_q, (), 0, num_qualities)) == 0:
            return jax.random.PRNGKey(k)
    raise AssertionError("no key")


# -- configuration and the weight bridge ----------------------------------------


def test_config_fields_match_jax():
    assert dataclasses.asdict(b2018.Config()) == dataclasses.asdict(jax_b2018.Config())
    assert b2018.Config().num_qualities == jax_b2018.Config().num_qualities == 4


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_param_tree_and_gains_match_jax_init(activation):
    """The bridge maps the top-level gain arrays and the (Q, C) prior beside
    the transforms, both ways; shapes and names are the JAX init's, and the
    gains start at its values."""
    jax_model, model = _models(activation)
    want = jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                          jax.random.PRNGKey(1), 0, training=True)
    got = serialization.to_state_dict(_jax_params(model))
    want = serialization.to_state_dict(want)
    assert jax.tree_util.tree_map(lambda a: a.shape, got) == jax.tree_util.tree_map(
        lambda a: a.shape, want)
    for name in ("gain", "inv_gain"):
        np.testing.assert_allclose(np.asarray(got["params"][name]),
                                   np.asarray(want["params"][name]), rtol=1e-6)
    tree = convert.params_to_numpy(model.state_dict())
    want_holders = ["analysis", "gain", "inv_gain", "prior", "synthesis"]
    assert sorted(tree) == want_holders
    assert tree["prior"]["deep_factorized"]["matrices"]["0"].shape == (4, 8, 3, 1)
    back = convert.params_from_numpy({"params": {"params": tree}})
    assert sorted(back) == sorted(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k
    assert convert.flax_key_path("gain") == "params/gain"
    assert convert.flax_key_path("prior.factors.1") == "params/prior/deep_factorized/2/1"


# -- forward, loss and gradients ------------------------------------------------


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("q", [0, 3, (2, 1)])
def test_forward_matches_jax(activation, q):
    """x_hat and the bits per image with training=False, within 1e-5, at a
    scalar quality and at one quality per example."""
    jax_model, model = _models(activation)
    x = np.random.RandomState(0).rand(2, 64, 48, 3).astype(np.float32)
    want_x, want_bits = jax_model.apply(_jax_params(model), jnp.asarray(x),
                                        jax.random.PRNGKey(0), jnp.asarray(q),
                                        training=False)
    with torch.no_grad():
        got_x, got_bits = model(torch.from_numpy(x), None, torch.tensor(q), training=False)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_bits.numpy(), np.asarray(want_bits), rtol=1e-5)


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_each_examples_quality_is_the_scalar_quality_math(activation):
    """A vector of qualities gives each example what a scalar quality gives
    it alone: its gains and its (C,) prior row."""
    _, model = _models(activation, seed=2)
    x = torch.from_numpy(np.random.RandomState(3).rand(3, 32, 48, 3).astype(np.float32))
    with torch.no_grad():
        x_hat, bits = model(x, None, torch.tensor([3, 0, 2]), training=False)
        for b, q in enumerate((3, 0, 2)):
            one_x, one_bits = model(x[b : b + 1], None, q, training=False)
            torch.testing.assert_close(x_hat[b : b + 1], one_x, rtol=1e-6, atol=1e-6)
            torch.testing.assert_close(bits[b : b + 1], one_bits, rtol=1e-6, atol=0)


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_loss_and_every_gradient_match_jax(activation):
    """The loss, its metrics and the gradient of every parameter with
    training=False and the qualities (0, 1, 2, 3) over a batch of 4,
    against jax.value_and_grad of the JAX package's make_loss_fn.
    Tolerance: loss and metrics 1e-5 relative; each gradient 1e-3 relative
    plus 1e-4 of its largest entry."""
    jax_model, model = _models(activation)
    x = np.random.RandomState(1).rand(4, 32, 32, 3).astype(np.float32)
    loss_fn = jax_b2018.make_loss_fn(_Quantized(jax_model))
    (want, want_m), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        _jax_params(model), jnp.asarray(x), _key_with_offset_zero(4))
    loss, metrics = b2018.make_loss_fn(model, training=False)(torch.from_numpy(x))
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
    # Every quality's gains received gradient (one example each).
    assert bool((model.gain.grad != 0).any(dim=1).all())


def test_training_rotates_the_qualities_with_the_generator():
    """With a generator the rotation is drawn from it (so it differs between
    seeds); each batch of Q examples covers every quality; the rates move
    with the noise."""
    _, model = _models(seed=3)
    seen = []
    original = model.forward

    def spy(x, generator=None, q=0, training=True):
        seen.append(q.tolist())
        return original(x, generator, q, training)

    model.forward = spy
    x = torch.from_numpy(np.random.RandomState(4).rand(4, 32, 32, 3).astype(np.float32))
    loss_fn = b2018.make_loss_fn(model)
    with torch.no_grad():
        losses = [loss_fn(x, torch.Generator().manual_seed(s))[0].item() for s in range(6)]
        with pytest.raises(ValueError, match="generator"):
            b2018.make_loss_fn(model)(x)
    assert all(sorted(q) == [0, 1, 2, 3] for q in seen)
    assert len({q[0] for q in seen}) > 1 and len(set(losses)) > 1


# -- the codec ------------------------------------------------------------------


def _full_tables(jax_codec):
    """The JAX codec's per-quality table views, stacked back into the full
    Q·C-row tables."""
    parts = [em.tables for em in jax_codec.ems]
    return CdfTables(*(np.concatenate([np.asarray(getattr(t, f)) for t in parts])
                       for f in ("cdf", "cdf_length", "cdf_offset", "offset")),
                     precision=parts[0].precision)


@pytest.fixture(scope="module", params=ACTIVATIONS)
def codecs(request):
    """The JAX codec, and the port's on its own tables and on the JAX
    package's (pinned), for the same seeded weights."""
    jax_model, model = _models(request.param, seed=3)
    jax_codec = jax_b2018.Codec(jax_model, _jax_params(model))
    own = b2018.Codec(model, device="cpu")
    pinned = b2018.Codec(model, device="cpu", tables=_full_tables(jax_codec))
    return jax_codec, own, pinned


def test_cdf_tables_equal_jax(codecs):
    """The Q·C rows, quality-major, and each quality's slice of them."""
    jax_codec, own, _ = codecs
    want, got = _full_tables(jax_codec), own.tables
    assert got.num_cdfs == 4 * 8
    for field in ("cdf", "cdf_length", "cdf_offset"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), field)
    np.testing.assert_allclose(got.offset, want.offset, rtol=0, atol=1e-5)
    for q, em in enumerate(own.ems):
        np.testing.assert_array_equal(em.tables.cdf, got.cdf[q * 8 : (q + 1) * 8])
        assert em.prior_batch_shape == (8,)


def test_blobs_byte_identical_and_cross_decode_at_each_quality(codecs):
    jax_codec, _, codec = codecs
    image = _images(1, 70, 100, seed=5)[0]  # padded to 80x112
    name = codec.cfg.model_name
    for quality in range(1, 5):
        ours = codec.compress(image, quality=quality, model_name=f"{name}-{quality}")
        theirs = jax_codec.compress(image, quality=quality, model_name=f"{name}-{quality}")
        assert ours == theirs
        packed = JaxPackedTensors(ours)
        assert packed.model == f"{name}-{quality}"
        assert len([k for k, *_ in packed.describe() if k != "MD"]) == 3
        assert packed.unpack_one(2, np.int32).tolist() == [5, 7, quality - 1]
        by_jax, by_port = jax_codec.decompress(ours), codec.decompress(theirs)
        assert by_jax.shape == by_port.shape == image.shape
        diff = np.abs(by_jax.astype(np.int16) - by_port.astype(np.int16))
        assert diff.max() <= 1 and np.mean(diff == 0) > 0.99


def test_round_trip_at_each_quality_on_cpu(codecs):
    """The decode is the synthesis of the encoder's symbols plus the
    quality's offsets, through its inverse gains; re-compression is
    byte-identical; the highest quality spends more bits than the lowest;
    the stages are timed."""
    _, codec, _ = codecs
    model = codec.model
    image = _images(1, 50, 37, seed=6)[0]  # padded to 64x48
    x = np.pad(image, ((0, 14), (0, 11), (0, 0)), mode="edge")[None]
    sizes = []
    for quality in (1, 4):
        q = quality - 1
        blob = codec.compress(image, quality=quality)
        assert JaxPackedTensors(blob).model == codec.cfg.model_name
        out = codec.decompress(blob)
        assert out.shape == image.shape and out.dtype == np.uint8
        with torch.no_grad():
            y = model.analyze(torch.from_numpy(x).float() / 255.0, q)
            off = codec.ems[q].symbol_offset()
            x_hat = model.synthesize(torch.round(y - off) + off, q)
        want = torch.clamp(torch.round(x_hat * 255.0), 0, 255).to(torch.uint8)
        np.testing.assert_array_equal(out, want.numpy()[0, :50, :37])
        assert codec.compress(image, quality=quality) == blob
        sizes.append(len(blob))
    assert sizes[1] > sizes[0]
    assert "enc/code" in codec.timer.report() and "dec/synth" in codec.timer.report()


def test_quality_out_of_range_raises(codecs):
    _, codec, _ = codecs
    image = _images(1, 32, 32, seed=7)[0]
    for quality in (0, 5):
        with pytest.raises(ValueError, match="quality 1..4"):
            codec.compress(image, quality=quality)
    blob = codec.compress(image, quality=2)
    packed = JaxPackedTensors(blob)
    fields = packed.unpack([object, np.int32, np.int32])
    bad = JaxPackedTensors()
    bad.model = packed.model
    bad.pack([bytes(fields[0][0]), fields[1], np.array([2, 2, 4], np.int32)])
    with pytest.raises(ValueError, match="quality"):
        codec.decompress(bad.string)


def test_cuda_is_the_default_and_missing_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the test is for hosts without it")
    _, model = _models()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        b2018.Codec(model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        b2018.train(b2018.Config(num_filters=8), common.TrainConfig(steps=1))


# -- checkpoints and training ------------------------------------------------------

_RATE_SCALES = (("params/prior", 10.0), ("params/gain", 10.0), ("params/inv_gain", 10.0))


def _adam_state(opt_state):
    for leaf in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState)):
        if isinstance(leaf, optax.ScaleByAdamState):
            return leaf
    raise AssertionError("no Adam state")


@pytest.mark.parametrize("scales", [None, _RATE_SCALES])
def test_port_checkpoint_loads_in_jax_with_moments(tmp_path, scales):
    """Written by the port, read by the JAX package's load_checkpoint with
    the optimizer its train() builds (the lr_scales chain when given)."""
    cfg = common.TrainConfig(steps=10, lr_scales=scales)
    _, model = _models(seed=5)
    optimizer = common.make_optimizer(model, cfg)
    if scales:
        assert sorted(g["scale"] for g in optimizer.param_groups) == [1.0, 10.0]
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
    _, model = _models("leaky_relu", seed=6)
    params = _jax_params(model)
    tx = optax.chain(optax.adam(1e-3), jax_common._scale_by_path(_RATE_SCALES))
    state = tx.init(params)
    rng = np.random.RandomState(1)
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32)), params)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    path = str(tmp_path / "jax.msgpack")
    jax_common.save_checkpoint(path, params, 2, state)
    _, fresh = _models("leaky_relu", seed=9)
    optimizer = common.make_optimizer(
        fresh, common.TrainConfig(learning_rate=1e-3, lr_scales=_RATE_SCALES))
    assert common.restore_checkpoint(path, fresh, optimizer) == (2, True)
    adam = _adam_state(state)
    names = dict(fresh.named_parameters())
    for n, t in _to_port(params).items():
        assert torch.equal(names[n].detach(), t), n
    for field, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        for n, t in _to_port(getattr(adam, field)).items():
            assert torch.equal(optimizer.state[names[n]][key], t), (field, n)


def test_train_on_cpu(tmp_path):
    """b2018.train with the default rate-point lr_scales: the metrics CSV,
    a checkpoint in the lr_scales layout that loads back into the trained
    model, and a seeded, reproducible run."""
    cfg = b2018.Config(num_filters=8, activation="leaky_relu")
    tcfg = common.TrainConfig(batch_size=2, patch_size=32, steps=3, log_every=1,
                              checkpoint_dir=str(tmp_path), checkpoint_name="b.msgpack",
                              seed=1)
    model = b2018.train(cfg, tcfg, device="cpu")
    assert all(torch.isfinite(p).all() for p in model.parameters())
    rows = (tmp_path / "b.msgpack.metrics.csv").read_text().splitlines()
    assert rows[0] == "step,bpp,loss,mse,img_per_s" and len(rows) == 4
    tree = convert.load_flax_msgpack(tmp_path / "b.msgpack")
    assert sorted(tree["opt_state"]) == ["0", "1"] and tree["opt_state"]["1"] == {}
    params, step, adam = common.load_checkpoint(str(tmp_path / "b.msgpack"))
    assert step == 3 and adam["count"] == 3
    loaded = b2018.load_model(tmp_path / "b.msgpack", cfg)
    for n, t in model.state_dict().items():
        assert torch.equal(params[n], t) and torch.equal(loaded.state_dict()[n], t)
    again = b2018.train(cfg, dataclasses.replace(tcfg, checkpoint_dir=str(tmp_path / "again")),
                        device="cpu")
    for n, t in model.state_dict().items():
        assert torch.equal(again.state_dict()[n], t), n
