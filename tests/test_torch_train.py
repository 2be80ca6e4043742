"""The port's training path against the JAX package's: the model's
initialisation, bmshj2018's loss and every parameter's gradient against
``jax.value_and_grad(make_loss_fn)``, Adam and the lr schedules against
optax, the crop dataset, the metrics CSV, checkpoints read and written
across the packages, and the train loop on the CPU. Sizes are tiny (8/8/4
filters, 64x64, batch 2); inputs are seeded NumPy arrays."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from compression_tpu.distributions.deep_factorized import DeepFactorized as JaxDeepFactorized
from compression_tpu.models import bmshj2018 as jax_bmshj2018
from compression_tpu.models import common as jax_common
from compression_tpu.util import image as jax_image
from compression_tpu_torch import convert
from compression_tpu_torch.entry import entry
from compression_tpu_torch.layers.signal_conv import SignalConv2D
from compression_tpu_torch.models import bmshj2018, common

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
    """A JAX param-shaped tree (params, grads, moments) as a state dict."""
    return convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(tree)))


def _batch(seed, n=2, hw=64):
    return np.random.RandomState(seed).rand(n, hw, hw, 3).astype(np.float32)


# -- configuration and initialisation -----------------------------------------


def test_config_fields_match_jax():
    assert dataclasses.asdict(bmshj2018.Config()) == dataclasses.asdict(
        jax_bmshj2018.Config())
    assert dataclasses.asdict(common.TrainConfig()) == dataclasses.asdict(
        jax_common.TrainConfig())


def test_signal_conv_init_is_fan_avg_truncated_normal():
    """Kernels are drawn as variance_scaling(1.0, "fan_avg",
    "truncated_normal"): cut at 2 standard deviations of the underlying
    normal, with the variance 1 / fan_avg after the cut (to 1% on 921,600
    draws); the same generator state gives the same kernel."""
    cin, cout, k = 192, 192, 5
    fan_avg = (cin + cout) * k * k / 2
    std = np.sqrt(1.0 / fan_avg) / 0.87962566103423978
    conv = SignalConv2D(cin, cout, k, generator=torch.Generator().manual_seed(3))
    w = conv.weight.detach().double().numpy()
    assert np.abs(w).max() <= 2 * std * (1 + 1e-6)
    assert np.abs(w).max() > 1.99 * std
    assert abs(w.std() - np.sqrt(1.0 / fan_avg)) < 0.01 * np.sqrt(1.0 / fan_avg)
    assert abs(w.mean()) < 0.01 * w.std()
    again = SignalConv2D(cin, cout, k, generator=torch.Generator().manual_seed(3))
    assert torch.equal(again.weight, conv.weight)


def test_model_is_built_from_a_seed():
    a = bmshj2018.BMSHJ2018Model(bmshj2018.Config(**SMALL), seed=7).state_dict()
    b = bmshj2018.BMSHJ2018Model(bmshj2018.Config(**SMALL), seed=7).state_dict()
    c = bmshj2018.BMSHJ2018Model(bmshj2018.Config(**SMALL), seed=8).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["analysis.conv0.weight"], c["analysis.conv0.weight"])
    assert not torch.equal(a["hyperprior.biases.0"], c["hyperprior.biases.0"])
    assert float(a["hyperprior.biases.0"].abs().max()) <= 0.5
    assert torch.equal(a["analysis.conv0.bias"], torch.zeros(8))


# -- the loss and its gradients ------------------------------------------------


class _Quantized:
    """The JAX model with ``training=False`` (deterministic rounding) in
    place of the noise, for the JAX package's own make_loss_fn."""

    def __init__(self, model):
        self.config = model.config
        self._model = model

    def apply(self, params, x, rng, training=True):
        return self._model.apply(params, x, rng, training=False)


@pytest.mark.parametrize("distortion", ["mse", "msssim"])
def test_loss_and_every_gradient_match_jax(distortion):
    """bmshj2018's loss, its metrics and the gradient of every parameter
    with training=False, against jax.value_and_grad of the JAX package's
    make_loss_fn, through the weight bridge. At init the synthesis puts out
    exact zeros, where MS-SSIM's clip to [0, 1] ties (jnp.clip passes half
    the gradient there, and so does the port's clip). Tolerance: loss and
    metrics 1e-5 relative; each gradient 1e-3 relative plus 1e-4 of its
    largest entry (float32 convolutions and sums in another order; seen:
    5e-6 of the largest entry)."""
    cfg = dict(SMALL, lmbda=0.02, distortion=distortion)
    model = bmshj2018.BMSHJ2018Model(bmshj2018.Config(**cfg), seed=1)
    x = _batch(0)
    jax_model = jax_bmshj2018.BMSHJ2018Model(jax_bmshj2018.Config(**cfg))
    loss_fn = jax_bmshj2018.make_loss_fn(_Quantized(jax_model))
    (want, want_m), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        _jax_params(model), jnp.asarray(x), jax.random.PRNGKey(0))
    loss, metrics = bmshj2018.make_loss_fn(model, training=False)(torch.from_numpy(x))
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


def test_rate_gradients_reach_the_hyper_synthesis_at_init():
    """lower_bound's identity-if-towards gradient on sigma keeps the rate's
    gradients alive at init, when sigma sits below SCALES_MIN."""
    model = bmshj2018.BMSHJ2018Model(bmshj2018.Config(**SMALL), seed=2)
    x = torch.from_numpy(_batch(1))
    _, y_bits, z_bits = model(x, torch.Generator().manual_seed(0))
    (y_bits.mean() + z_bits.mean()).backward()
    for conv in (model.hyper_synthesis.conv0, model.hyper_synthesis.conv2):
        assert float(conv.weight.grad.abs().sum()) > 0


def test_training_noise_comes_from_the_generator():
    model = bmshj2018.BMSHJ2018Model(bmshj2018.Config(**SMALL), seed=3)
    x = torch.from_numpy(_batch(2))
    with torch.no_grad():
        a = model(x, torch.Generator().manual_seed(5))
        b = model(x, torch.Generator().manual_seed(5))
        c = model(x, torch.Generator().manual_seed(6))
        with pytest.raises(ValueError, match="generator"):
            model(x)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not torch.equal(a[1], c[1])


def test_entry_gives_the_full_width_loss_step():
    fn, (model, x, generator) = entry(device="cpu")
    assert (model.config.num_filters, model.config.num_latents,
            model.config.num_hyperlatents) == (192, 192, 128)
    assert tuple(x.shape) == (1, 256, 256, 3)
    with torch.no_grad():
        loss, metrics = fn(model, x, generator)
    assert np.isfinite(loss.item()) and sorted(metrics) == ["bpp", "mse"]


# -- optimizer and schedules -----------------------------------------------------


@pytest.mark.parametrize("schedule", ["constant", "step", "cosine"])
def test_lr_schedules_match_optax(schedule):
    cfg = common.TrainConfig(steps=100, learning_rate=3e-4, lr_schedule=schedule,
                             lr_final_scale=0.2, lr_drop_frac=0.85)
    want = {"constant": lambda c: 3e-4,
            "step": optax.piecewise_constant_schedule(3e-4, {85: 0.2}),
            "cosine": optax.cosine_decay_schedule(3e-4, 100, alpha=0.2)}[schedule]
    got = common.lr_schedule(cfg)
    for count in (0, 1, 50, 84, 85, 86, 99, 100, 150):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6)
    with pytest.raises(ValueError, match="lr_schedule"):
        common.lr_schedule(common.TrainConfig(lr_schedule="linear"))


@pytest.mark.parametrize("schedule,scales", [("constant", None),
                                             ("cosine", (("params/hyperprior", 10.0),
                                                         ("params/synthesis/conv3", 0.5)))])
def test_adam_steps_match_optax(schedule, scales):
    """Three updates from the same gradients: torch.optim.Adam with the
    port's lr groups against optax.adam (chained with the JAX package's
    per-path scaling), which the JAX train loop uses. Tolerance: 1e-6
    relative plus 1e-8, i.e. 1e-6 of the lr (the same formula, float32
    rounding in another order)."""
    cfg = common.TrainConfig(steps=3, learning_rate=1e-2, lr_schedule=schedule,
                             lr_scales=scales)
    model = bmshj2018.BMSHJ2018Model(bmshj2018.Config(**SMALL), seed=4)
    params = _jax_params(model)
    lr = (optax.cosine_decay_schedule(1e-2, 3, alpha=0.1) if schedule == "cosine"
          else 1e-2)
    tx = optax.adam(lr)
    if scales:
        tx = optax.chain(tx, jax_common._scale_by_path(scales))
    state = tx.init(params)
    optimizer = common.make_optimizer(model, cfg)
    sched = common.lr_schedule(cfg)
    rng = np.random.RandomState(0)
    for _ in range(3):
        grads = {n: torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
                 for n, p in model.named_parameters()}
        for n, p in model.named_parameters():
            p.grad = grads[n].clone()
        common._set_lr(optimizer, sched(common._updates_done(optimizer)))
        optimizer.step()
        jax_grads = _jax_params_like(params, grads)
        updates, state = tx.update(jax_grads, state, params)
        params = optax.apply_updates(params, updates)
    want = _to_port(params)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=1e-6,
                                   atol=1e-8, err_msg=n)


def _jax_params_like(params, state):
    """A port state dict (e.g. gradients) in the layout of ``params``."""
    holder = bmshj2018.BMSHJ2018Model(bmshj2018.Config(**SMALL))
    holder.load_state_dict(state)
    return _jax_params(holder)


# -- data -----------------------------------------------------------------------


def test_crop_dataset_synthetic_is_bit_identical():
    cfg = dict(batch_size=3, patch_size=64, seed=5)
    ours = common.crop_dataset(common.TrainConfig(**cfg))
    theirs = jax_common.crop_dataset(jax_common.TrainConfig(**cfg))
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("augment", [True, False])
def test_crop_dataset_from_pngs_is_bit_identical(tmp_path, augment):
    rng = np.random.RandomState(6)
    for i, hw in enumerate([(70, 90), (64, 64), (100, 80), (40, 200)]):
        jax_image.write_png(tmp_path / f"im{i}.png",
                            rng.randint(0, 256, (*hw, 3)).astype(np.uint8))
    cfg = dict(train_glob=str(tmp_path / "*.png"), batch_size=4, patch_size=64,
               seed=2, augment=augment)
    ours = common.crop_dataset(common.TrainConfig(**cfg))
    theirs = jax_common.crop_dataset(jax_common.TrainConfig(**cfg))
    for _ in range(4):
        a, b = next(ours), next(theirs)
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        next(common.crop_dataset(common.TrainConfig(train_glob=str(tmp_path / "*.jpg"))))


def test_write_metrics_row_is_byte_identical(tmp_path):
    rows = [(1, {"loss": 1.25, "bpp": 0.5, "mse": 30.0}, 10.0),
            (2, {"loss": 1.2, "bpp": 0.49, "mse": 29.0}, 12.5),
            (3, {"loss": 1.1, "bpp": 0.48}, 13.0)]  # new metric set: rotation
    for writer, d in ((common.write_metrics_row, tmp_path / "ours"),
                      (jax_common.write_metrics_row, tmp_path / "theirs")):
        for step, m, rate in rows:
            writer(str(d), "ck.msgpack", step, m, rate)
    for name in ("ck.msgpack.metrics.csv", "ck.msgpack.metrics.csv.prev"):
        assert (tmp_path / "ours" / name).read_bytes() == (tmp_path / "theirs" / name).read_bytes()


# -- checkpoints across the packages ---------------------------------------------


def _trained_state(cfg, seed=5, updates=2):
    """A small model and its Adam after ``updates`` steps on random grads."""
    model = bmshj2018.BMSHJ2018Model(bmshj2018.Config(**SMALL), seed=seed)
    optimizer = common.make_optimizer(model, cfg)
    rng = np.random.RandomState(seed)
    for _ in range(updates):
        for p in model.parameters():
            p.grad = torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
        optimizer.step()
    return model, optimizer


def _jax_tx(cfg):
    lr = {"constant": cfg.learning_rate,
          "cosine": optax.cosine_decay_schedule(cfg.learning_rate, cfg.steps,
                                                alpha=cfg.lr_final_scale)}[cfg.lr_schedule]
    tx = optax.adam(lr)
    if cfg.lr_scales:
        tx = optax.chain(tx, jax_common._scale_by_path(cfg.lr_scales))
    return tx


def _adam_state(opt_state):
    """optax's ScaleByAdamState inside a (possibly chained) state."""
    for leaf in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState)):
        if isinstance(leaf, optax.ScaleByAdamState):
            return leaf
    raise AssertionError("no Adam state")


@pytest.mark.parametrize("schedule,scales", [("constant", None), ("cosine", None),
                                             ("constant", (("params/hyperprior", 10.0),))])
def test_port_checkpoint_resumes_in_jax(tmp_path, schedule, scales):
    """A port checkpoint with Adam's state loads with the JAX package's
    load_checkpoint and the template of its optimizer for the same config;
    params, step, count and moments come back equal."""
    cfg = common.TrainConfig(steps=10, lr_schedule=schedule, lr_scales=scales)
    model, optimizer = _trained_state(cfg)
    path = str(tmp_path / "ck.msgpack")
    common.save_checkpoint(path, model, 7, optimizer, cfg)
    template = _jax_params(bmshj2018.BMSHJ2018Model(bmshj2018.Config(**SMALL), seed=0))
    params, step, opt_state = jax_common.load_checkpoint(
        path, template, _jax_tx(cfg).init(template))
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
    """A JAX checkpoint (optax.adam after two updates) restores into a fresh
    port model and optimizer: params, count and moments bit for bit; the
    next update equals optax's third."""
    model = bmshj2018.BMSHJ2018Model(bmshj2018.Config(**SMALL), seed=6)
    params = _jax_params(model)
    tx = optax.adam(1e-3)
    state = tx.init(params)
    rng = np.random.RandomState(1)
    grads = [_jax_params_like(params, {
        n: torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
        for n, p in model.named_parameters()}) for _ in range(3)]
    for g in grads[:2]:
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
    path = str(tmp_path / "jax.msgpack")
    jax_common.save_checkpoint(path, params, 2, state)

    fresh = bmshj2018.BMSHJ2018Model(bmshj2018.Config(**SMALL), seed=9)
    optimizer = common.make_optimizer(fresh, common.TrainConfig(learning_rate=1e-3))
    step, with_moments = common.restore_checkpoint(path, fresh, optimizer)
    assert step == 2 and with_moments
    adam = _adam_state(state)
    names = dict(fresh.named_parameters())
    for n, t in _to_port(params).items():
        assert torch.equal(names[n].detach(), t), n
    for field, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        for n, t in _to_port(getattr(adam, field)).items():
            assert torch.equal(optimizer.state[names[n]][key], t), (field, n)
    assert common._updates_done(optimizer) == 2

    updates, state = tx.update(grads[2], state, params)
    params = optax.apply_updates(params, updates)
    for n, g in _to_port(grads[2]).items():
        names[n].grad = g
    common._set_lr(optimizer, 1e-3)
    optimizer.step()
    for n, t in _to_port(params).items():
        np.testing.assert_allclose(names[n].detach().numpy(), t.numpy(), rtol=1e-6,
                                   atol=1e-9, err_msg=n)


def test_params_only_checkpoint_resumes_with_a_fresh_optimizer(tmp_path):
    model = bmshj2018.BMSHJ2018Model(bmshj2018.Config(**SMALL), seed=3)
    path = str(tmp_path / "params.msgpack")
    jax_common.save_checkpoint(path, _jax_params(model), 40)
    fresh = bmshj2018.BMSHJ2018Model(bmshj2018.Config(**SMALL), seed=4)
    optimizer = common.make_optimizer(fresh, common.TrainConfig())
    assert common.restore_checkpoint(path, fresh, optimizer) == (40, False)
    assert not optimizer.state
    for n, t in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[n], t)


def test_checkpoint_write_is_atomic(tmp_path, monkeypatch):
    """The file is written whole under a temporary name and renamed: if the
    rename fails, the target keeps its old content (or does not exist)."""
    model, optimizer = _trained_state(common.TrainConfig())
    path = tmp_path / "ck.msgpack"
    common.save_checkpoint(str(path), model, 1, optimizer)
    before = path.read_bytes()

    def fail(src, dst):
        raise OSError("disk full")

    monkeypatch.setattr(os, "replace", fail)
    with pytest.raises(OSError):
        common.save_checkpoint(str(path), model, 2, optimizer)
    with pytest.raises(OSError):
        common.save_checkpoint(str(tmp_path / "new.msgpack"), model, 2, optimizer)
    assert path.read_bytes() == before
    assert not (tmp_path / "new.msgpack").exists()


# -- the train loop ---------------------------------------------------------------


def test_train_model_on_cpu_with_resume(tmp_path, capsys):
    """Three steps on the CPU write the metrics CSV and a checkpoint; a
    second run resumes from it (params and moments as saved) and numbers
    its one step 4."""
    tcfg = common.TrainConfig(batch_size=2, patch_size=64, steps=3, log_every=1,
                              checkpoint_every=2, checkpoint_dir=str(tmp_path),
                              checkpoint_name="b.msgpack", seed=1)
    seen = []
    model = bmshj2018.train(bmshj2018.Config(**SMALL), tcfg, device="cpu")
    assert all(torch.isfinite(p).all() for p in model.parameters())
    rows = (tmp_path / "b.msgpack.metrics.csv").read_text().splitlines()
    assert rows[0] == "step,bpp,loss,mse,img_per_s" and len(rows) == 4
    params, step, adam = common.load_checkpoint(str(tmp_path / "b.msgpack"))
    assert step == 3 and adam["count"] == 3
    for n, t in model.state_dict().items():
        assert torch.equal(params[n], t)

    resumed = bmshj2018.BMSHJ2018Model(bmshj2018.Config(**SMALL), seed=99)
    common.train_model(resumed, bmshj2018.make_loss_fn(resumed),
                       dataclasses.replace(tcfg, steps=4),
                       hooks=lambda s, m: seen.append((s, sorted(m))), device="cpu")
    assert "resumed from" in capsys.readouterr().out
    assert seen == [(4, ["bpp", "loss", "mse"])]
    assert common.load_checkpoint(str(tmp_path / "b.msgpack"))[1] == 4


def test_train_model_refuses_what_is_not_ported():
    """Data parallelism over devices the batch does not divide over: the
    JAX package's ValueError, before any work."""
    model = bmshj2018.BMSHJ2018Model(bmshj2018.Config(**SMALL))
    with pytest.raises(ValueError, match=r"batch_size \(8\) must be divisible by "
                                         r"num_devices \(3\) for data parallelism"):
        common.train_model(model, bmshj2018.make_loss_fn(model),
                           common.TrainConfig(num_devices=3), device="cpu")


def test_cuda_is_the_default_for_training():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the test is for hosts without it")
    model = bmshj2018.BMSHJ2018Model(bmshj2018.Config(**SMALL))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        common.train_model(model, bmshj2018.make_loss_fn(model), common.TrainConfig(steps=1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()
