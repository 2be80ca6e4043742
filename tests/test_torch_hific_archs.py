"""The port's HiFiC networks against the JAX package's: the configurations,
ChannelNorm and its gradients, the Encoder and Generator, the
discriminator's logits at an even and at an odd size (TF "SAME" padding),
its spectral-norm state with and without ``update_stats``, the D loss and
every D gradient, and the weight bridge for HiFiC's nested trees and the
discriminator's ``batch_stats``. Small sizes (8 latents, 4 hyperlatents,
one residual block; the 60-960 widths are fixed); the JAX params are the
port's seeded models through the weight bridge."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from compression_tpu.distributions.deep_factorized import DeepFactorized as JaxDeepFactorized
from compression_tpu.layers import SignalConv2D as JaxSignalConv2D
from compression_tpu.models import hific as jax_hific
from compression_tpu.models.hific import archs as jax_archs
from compression_tpu_torch import convert
from compression_tpu_torch.layers import SignalConv2D
from compression_tpu_torch.models import hific
from compression_tpu_torch.models.hific import archs

torch.set_num_threads(1)

SMALL = dict(name="hific-test", target_rate=0.3, num_latents=8, num_hyperlatents=4,
             num_residual_blocks=1)
_FIELDS = ("matrices", "biases", "factors")


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def jax_g_params(model):
    """The port's G model as the JAX package's param tree."""
    tree = convert.params_to_numpy(model.state_dict())
    prior = tree["hyperprior"].pop("deep_factorized")
    tree = _jnp(tree)
    tree["hyperprior"]["deep_factorized"] = JaxDeepFactorized(*(
        tuple(jnp.asarray(prior[f][str(i)]) for i in range(len(prior[f])))
        for f in _FIELDS))
    return {"params": tree}


def jax_d_vars(disc):
    """The port's discriminator as flax variables (params, batch_stats)."""
    return _jnp(convert.variables_to_numpy(disc.state_dict()))


def _port_d_state(variables):
    return convert.variables_from_numpy(
        jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(variables)))


@pytest.fixture(scope="module")
def models():
    model = hific.HificModel(hific.HificConfig(**SMALL), seed=1)
    disc = archs.Discriminator(SMALL["num_latents"], seed=2)
    return model, disc


def _rand(seed, *shape, scale=1.0, loc=0.0):
    return (np.random.RandomState(seed).randn(*shape) * scale + loc).astype(np.float32)


# -- configurations ------------------------------------------------------------------


def test_configs_match_jax():
    assert [(f.name, f.default) for f in dataclasses.fields(hific.HificConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(jax_hific.HificConfig)]
    assert sorted(hific.CONFIGS) == sorted(jax_hific.CONFIGS) == [
        "hific-hi", "hific-lo", "hific-mi"]
    for name, cfg in hific.CONFIGS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_hific.get_config(name))
        assert hific.get_config(name) is cfg
        assert (cfg.model_name, cfg.downscale) == (name, 64)
    assert (hific.get_config("hific-mi").num_latents,
            hific.get_config("hific-mi").num_hyperlatents) == (220, 320)
    with pytest.raises(KeyError, match="unknown HiFiC config"):
        hific.get_config("hific-xx")


# -- ChannelNorm, Encoder, Generator ---------------------------------------------------


def test_channel_norm_and_its_gradients_match_jax():
    """Inputs with mean 3 and std 5 (torch's unbiased variance would be off
    by C/(C-1)); the output, and the gradients for x, gamma and beta of a
    weighted sum. Tolerance: values 1e-5; gradients 1e-4 of the largest
    entry."""
    x = _rand(0, 2, 5, 3, 16, scale=5.0, loc=3.0)
    gamma, beta, w = _rand(1, 16), _rand(2, 16), _rand(3, 2, 5, 3, 16)
    norm = jax_archs.ChannelNorm()
    params = {"params": {"gamma": jnp.asarray(gamma), "beta": jnp.asarray(beta)}}

    def jax_fn(p, x):
        out = norm.apply(p, x)
        return jnp.sum(out * w), out

    (_, want), (gp, gx) = jax.value_and_grad(jax_fn, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    port = archs.ChannelNorm(16)
    port.load_state_dict({"gamma": torch.from_numpy(gamma), "beta": torch.from_numpy(beta)})
    xt = torch.from_numpy(x).requires_grad_()
    out = port(xt)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for got, want_g in ((xt.grad, gx), (port.gamma.grad, gp["params"]["gamma"]),
                        (port.beta.grad, gp["params"]["beta"])):
        want_g = np.asarray(want_g)
        np.testing.assert_allclose(got.numpy(), want_g, rtol=1e-4,
                                   atol=1e-4 * np.abs(want_g).max())


def test_up_convolution_matches_jax():
    """The generator's up-convolution (3x3, corr=False, strides_up=2,
    same_zeros) at an even and an odd input size."""
    gen = torch.Generator().manual_seed(3)
    port = SignalConv2D(6, 5, 3, corr=False, strides_up=2, padding="same_zeros",
                        use_bias=True, generator=gen)
    layer = JaxSignalConv2D(5, (3, 3), corr=False, strides_up=2, padding="same_zeros",
                            use_bias=True)
    params = {"params": _jnp(convert.params_to_numpy(
        {f"l.{k}": v for k, v in port.state_dict().items()})["l"])}
    for shape in ((2, 4, 6, 6), (1, 5, 3, 6)):
        x = _rand(4, *shape)
        want = layer.apply(params, jnp.asarray(x))
        with torch.no_grad():
            got = port(torch.from_numpy(x))
        assert got.shape == want.shape == (shape[0], 2 * shape[1], 2 * shape[2], 5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_encoder_and_generator_match_jax(models):
    """y of a 64x64 and a 128x64 input, and the generator's image from a
    seeded y, within 1e-5."""
    model, _ = models
    params = jax_g_params(model)["params"]
    for seed, hw in ((5, (64, 64)), (6, (128, 64))):
        x = np.random.RandomState(seed).rand(2, *hw, 3).astype(np.float32)
        want = jax_archs.Encoder(8).apply({"params": params["encoder"]}, jnp.asarray(x))
        with torch.no_grad():
            got = model.encoder(torch.from_numpy(x))
        assert got.shape == want.shape == (2, hw[0] // 16, hw[1] // 16, 8)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    y = _rand(7, 2, 4, 3, 8, scale=3.0)
    want = jax_archs.Generator(1).apply({"params": params["generator"]}, jnp.asarray(y))
    with torch.no_grad():
        got = model.generator(torch.from_numpy(y))
    assert got.shape == want.shape == (2, 64, 48, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# -- the discriminator -------------------------------------------------------------------


@pytest.mark.parametrize("n,k,s,want", [(33, 4, 2, (1, 2)), (32, 4, 2, (1, 1)),
                                        (9, 4, 1, (1, 2)), (8, 1, 1, (0, 0)),
                                        (25, 4, 2, (1, 2))])
def test_same_pads_are_tf_same(n, k, s, want):
    assert archs.same_pads(n, k, s) == want
    assert tuple(jax.lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0]) == want


def _inputs(hw, seed):
    h, w = hw
    x = np.random.RandomState(seed).rand(2, h, w, 3).astype(np.float32)
    y = _rand(seed + 1, 2, -(-h // 16), -(-w // 16), 8, scale=2.0)
    return x, y


@pytest.mark.parametrize("hw", [(64, 64), (66, 50)])
def test_discriminator_logits_and_spectral_state_match_jax(hw):
    """Logits with update_stats=False (no state moves on either side), then
    a real pass and a fake pass with update_stats=True: logits, and u and
    sigma after each, equal flax's. At 66x50 (a 5x4 latent) conv1 sees a
    33x25 input, so a stride-2 conv pads (1, 2)."""
    disc = archs.Discriminator(8, seed=2)  # a fresh state: this test moves it
    x, y = _inputs(hw, seed=8)
    x_fake = np.random.RandomState(9).rand(*x.shape).astype(np.float32)
    jdisc = jax_archs.Discriminator()
    variables = jax_d_vars(disc)
    before = {k: v.clone() for k, v in disc.state_dict().items()}
    want = jdisc.apply(variables, jnp.asarray(x), jnp.asarray(y), update_stats=False)
    with torch.no_grad():
        got = disc(torch.from_numpy(x), torch.from_numpy(y), update_stats=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert got.shape == want.shape == (2, -(-hw[0] // 8), -(-hw[1] // 8), 1)
    for k, v in disc.state_dict().items():
        assert torch.equal(v, before[k]), k
    for image in (x, x_fake):
        want, out = jdisc.apply(variables, jnp.asarray(image), jnp.asarray(y),
                                update_stats=True, mutable=["batch_stats"])
        variables = {"params": variables["params"], **out}
        with torch.no_grad():
            got = disc(torch.from_numpy(image), torch.from_numpy(y), update_stats=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        want_state = _port_d_state(variables)
        for k, v in disc.state_dict().items():
            if k.endswith((".u", ".sigma")):
                np.testing.assert_allclose(v.numpy(), want_state[k].numpy(),
                                           rtol=1e-5, atol=1e-6, err_msg=k)
                assert not torch.equal(v, before[k]), k


@pytest.mark.parametrize("hw", [(64, 64), (66, 50)])
def test_d_loss_and_every_d_gradient_match_jax(hw):
    """The JAX package's d_loss_fn under value_and_grad (real, then fake,
    each with update_stats=True) against the port's: the loss (1e-5
    relative), every D gradient (1e-4 of its largest entry) and the
    spectral-norm state it leaves."""
    disc = archs.Discriminator(8, seed=2)
    x, y = _inputs(hw, seed=10)
    x_hat = np.random.RandomState(11).rand(*x.shape).astype(np.float32)
    cfg = jax_hific.HificConfig(**SMALL)
    _, jax_d_loss = jax_hific.make_loss_fns(None, jax_archs.Discriminator(), None, None, cfg)
    variables = jax_d_vars(disc)
    state = {k: v for k, v in variables.items() if k != "params"}
    (want, new_state), grads = jax.value_and_grad(jax_d_loss, has_aux=True)(
        variables["params"], state, jnp.asarray(x), jnp.asarray(x_hat), jnp.asarray(y))
    _, d_loss = hific.make_loss_fns(None, disc, None, hific.HificConfig(**SMALL))
    loss = d_loss(torch.from_numpy(x), torch.from_numpy(x_hat), torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    want_g = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(grads)))
    named = dict(disc.named_parameters())
    assert sorted(named) == sorted(want_g)
    for name, p in named.items():
        w = want_g[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)
    want_state = _port_d_state({"params": variables["params"], **new_state})
    for k, v in disc.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want_state[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


# -- the weight bridge ----------------------------------------------------------------------


def test_param_trees_match_jax_and_round_trip(models):
    """G's tree nests holders (generator.res0.norm0) and D's has top-level
    layers and flax nn.Conv kernels; both have the names and shapes of the
    JAX package's init (jax.eval_shape: no values computed), and both map
    back to the state dicts they came from."""
    model, disc = models
    x = jnp.zeros((1, 64, 64, 3))
    want = jax.eval_shape(lambda: jax_hific.HificModel(jax_hific.HificConfig(**SMALL)).init(
        jax.random.PRNGKey(0), x, jax.random.PRNGKey(1), training=True))
    got = serialization.to_state_dict(jax_g_params(model))
    shapes = lambda t: jax.tree_util.tree_map(lambda a: tuple(a.shape), t)  # noqa: E731
    assert shapes(got) == shapes(serialization.to_state_dict(want))
    tree = got["params"]
    assert tree["generator"]["res0"]["norm0"]["gamma"].shape == (960,)
    assert tree["generator"]["up3"]["kernel"].shape == (3, 3, 120, 60)
    want_d = jax.eval_shape(lambda: jax_archs.Discriminator().init(
        jax.random.PRNGKey(0), x, jnp.zeros((1, 4, 4, 8)), update_stats=False))
    got_d = jax_d_vars(disc)
    assert shapes(got_d) == shapes(serialization.to_state_dict(want_d))
    assert sorted(got_d["batch_stats"]["SpectralNorm_4"]) == [
        "conv_out/kernel/sigma", "conv_out/kernel/u"]
    assert got_d["params"]["conv0"]["kernel"].shape == (4, 4, 15, 64)
    for module, back in (
            (model, convert.params_from_numpy(convert.params_to_numpy(model.state_dict()))),
            (disc, convert.variables_from_numpy(convert.variables_to_numpy(disc.state_dict())))):
        assert sorted(back) == sorted(module.state_dict())
        for k, v in module.state_dict().items():
            assert torch.equal(back[k], v.reshape(back[k].shape)), k
    assert convert.flax_key_path("generator.res0.conv1.weight") == \
        "params/generator/res0/conv1/kernel"
    with pytest.raises(KeyError, match="batch_stats"):
        convert.variables_from_numpy({"params": {}, "batch_stats": {
            "SpectralNorm_0": {"conv0/bias/u": np.zeros(2)}}})
