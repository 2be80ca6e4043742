"""The port's joint G/D step against the JAX package's ``make_train_steps``
step, with the JAX package's own noise fed to the port: the G loss, every
metric, every G gradient and every D gradient (as Adam's first moments,
0.1 g after one step), both Adam states, G's and D's params after the step,
and the discriminator's spectral-norm state; under the bang-bang hinge, the
probe's rate, ``lam_override`` and inside the GAN warm-up (the
log-proportional law: tests/test_torch_hific_softness.py), where D's params and Adam state (its count too) stay as they
were. 2 crops of 128x128 (an 8x8 y, so the interior ring counts), 8
latents, 4 hyperlatents, one residual block; the JAX params are the port's
seeded models through the weight bridge.

Tolerances: metrics 1e-5 relative. D's gradients within 1e-3 relative plus
5e-4 of each tensor's largest entry: its inputs here, x_hat and y_hat, are
each package's own float32 G outputs (on the same inputs, D's gradients
agree within 1e-4: tests/test_torch_hific_archs.py). G's within 1e-3 relative plus 2e-3 of
the largest entry: through the 960-wide generator and its ChannelNorms
each package's float32 gradient is 2e-4 to 1.1e-3 of the largest entry off
the float64 gradient of the same step (measured on this test's inputs:
the port's up to 1.1e-3, the JAX package's up to 5.9e-4), so 1e-4 cannot
hold between the two float32 results. The second moments (0.001 g^2) at
twice the first moments' tolerance."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from compression_tpu.models import hific as jax_hific
from compression_tpu.models.hific import archs as jax_archs
from compression_tpu.models.hific import lpips as jax_lpips
from compression_tpu_torch import convert
from compression_tpu_torch.entropy_models import continuous_batched, continuous_indexed
from compression_tpu_torch.models import hific
from compression_tpu_torch.models.hific import archs, lpips
from test_torch_hific_archs import SMALL, jax_d_vars, jax_g_params

torch.set_num_threads(1)

WARMUP = 1
CASES = {  # name: (step_idx, probe_bpp, lam_override), under the bang-bang law
    "bang-bang": (WARMUP, -1.0, -1.0),
    "probe": (WARMUP, 0.05, -1.0),
    "lam_override": (WARMUP, 10.0, 0.375),
    "warm-up": (0, -1.0, -1.0),
}
_JAX_STEPS = {}


def _to_port(tree):
    return convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(tree)))


def _adam_state(opt_state):
    for leaf in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState)):
        if isinstance(leaf, optax.ScaleByAdamState):
            return leaf
    raise AssertionError("no Adam state")


def _jax_step(overrides, lpips_params):
    """The JAX package's jitted joint step for a config (one compile each)."""
    key = tuple(sorted(overrides.items()))
    if key not in _JAX_STEPS:
        cfg = jax_hific.HificConfig(**SMALL, gan_warmup_steps=WARMUP, **overrides)
        _JAX_STEPS[key] = jax_hific.make_train_steps(
            jax_hific.HificModel(cfg), jax_archs.Discriminator(), jax_lpips.LPIPS(),
            lpips_params, cfg)
    return _JAX_STEPS[key]


def _jax_noise(rng, x, cfg):
    """The three U(-1/2, 1/2) draws of the JAX model's training forward, in
    the order the port draws them: z's, y's, the interior's."""
    rng_y, rng_z, rng_in = jax.random.split(rng, 3)
    n, h, w, _ = x.shape
    y = (n, h // 16, w // 16, cfg.num_latents)
    z = (n, h // 64, w // 64, cfg.num_hyperlatents)
    ring = cfg.hinge_boundary_ring
    interior = (n, y[1] - 2 * ring, y[2] - 2 * ring, cfg.num_latents)
    return [np.asarray(jax.random.uniform(key, shape, jnp.float32, -0.5, 0.5))
            for key, shape in ((rng_z, z), (rng_y, y), (rng_in, interior))]


@pytest.fixture(scope="module")
def inputs():
    """The batch, LPIPS (random features) in both packages, and seeded G and
    D (each test steps copies of them)."""
    x = np.random.RandomState(0).rand(2, 128, 128, 3).astype(np.float32)
    lp = lpips.LPIPS(seed=7).requires_grad_(False)
    lp_params = {"params": jax.tree_util.tree_map(
        jnp.asarray, convert.params_to_numpy(lp.state_dict()))}
    model = hific.HificModel(hific.HificConfig(**SMALL), seed=1)
    disc = archs.Discriminator(SMALL["num_latents"], seed=2)
    return x, lp, lp_params, model, disc


G_TOL, D_TOL = 2e-3, 5e-4  # of each gradient's largest entry (see above)


def _close(got, want, tol, err_msg=""):
    """Within 1e-3 relative plus ``tol`` of the largest entry."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-3,
                               atol=tol * np.abs(want).max(), err_msg=err_msg)


def _check_update(name, before, got, want, mu, lr):
    """One Adam step moves each entry by at most ~lr: where the gradient is
    at least 1e-2 of its largest entry the step is determined (lr times its
    sign) and the packages agree within 1e-3 lr; elsewhere a gradient at
    the tolerance's level may take either sign, within 2 lr."""
    d = np.abs((got - before) - (want - before))
    assert d.max() <= 2.0 * lr * (1 + 1e-3), name
    well = np.abs(mu) > 1e-2 * np.abs(mu).max()
    assert d[well].max(initial=0.0) <= 1e-3 * lr, name


@pytest.mark.parametrize("case", sorted(CASES))
def test_joint_step_matches_jax(inputs, monkeypatch, case):
    run_case(inputs, monkeypatch, {}, *CASES[case])


def run_case(inputs, monkeypatch, overrides, step_idx, probe, lam):
    """One joint step of each package from the same weights and noise, and
    every comparison above (``overrides``: config fields)."""
    x, lp, lp_params, model, disc = inputs
    cfg = hific.HificConfig(**SMALL, gan_warmup_steps=WARMUP, **overrides)
    model, disc = copy.deepcopy(model), copy.deepcopy(disc)
    model.config = cfg
    g_before = {k: v.clone() for k, v in model.state_dict().items()}
    d_before = {k: v.clone() for k, v in disc.state_dict().items()}

    step, g_tx, d_tx = _jax_step(overrides, lp_params)
    g_params, d_vars = jax_g_params(model), jax_d_vars(disc)
    rng = jax.random.PRNGKey(5)
    g_new, d_new, g_opt, d_opt, want = step(
        g_params, d_vars, g_tx.init(g_params), d_tx.init(d_vars["params"]),
        jnp.asarray(x), rng, jnp.int32(step_idx), probe_bpp=jnp.float32(probe),
        lam_override=jnp.float32(lam))

    noise = _jax_noise(rng, x, cfg)

    def pinned(t, generator):
        draw = torch.from_numpy(noise.pop(0))
        assert draw.shape == t.shape
        return draw

    for module in (continuous_batched, continuous_indexed):
        monkeypatch.setattr(module, "uniform_noise", pinned)
    port_step, port_g_opt, port_d_opt = hific.make_train_steps(model, disc, lp, cfg)
    got = port_step(torch.from_numpy(x), torch.Generator(), step_idx, probe_bpp=probe,
                    lam_override=lam)
    assert noise == []

    gate = float(step_idx >= WARMUP)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        np.testing.assert_allclose(v.item(), float(want[k]), rtol=1e-5, err_msg=k)
    assert got["gan_on"].item() == gate
    if cfg.hinge_softness > 0.0:
        assert cfg.lambda_b < got["lam"].item() < cfg.lambda_a
    elif lam >= 0.0:
        assert got["lam"].item() == lam
    elif probe >= 0.0:
        assert got["hinge_stat"].item() == pytest.approx(probe)
        assert got["hinge_on"].item() == float(probe > cfg.target_rate)

    # G: every gradient as Adam's first moment, the second moment, the count,
    # and the params after the step.
    adam = _adam_state(g_opt)
    mu, nu, after = _to_port(adam.mu), _to_port(adam.nu), _to_port(g_new)
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(mu) and int(adam.count) == 1
    for name, p in named.items():
        state = port_g_opt.state[p]
        assert int(state["step"]) == 1
        _close(state["exp_avg"], mu[name], G_TOL, err_msg=name)
        _close(state["exp_avg_sq"], nu[name], 2 * G_TOL, err_msg=name)
        _check_update(name, g_before[name].numpy(), p.detach().numpy(), after[name].numpy(),
                      mu[name].numpy(), cfg.lr)

    # D: the spectral-norm state always advances; params and Adam only past
    # the warm-up.
    d_after = convert.variables_from_numpy(jax.tree_util.tree_map(
        np.asarray, serialization.to_state_dict(d_new)))
    adam = _adam_state(d_opt)
    assert int(adam.count) == int(gate)
    for name, v in disc.state_dict().items():
        if name.endswith((".u", ".sigma")):
            np.testing.assert_allclose(v.numpy(), d_after[name].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=name)
            assert not torch.equal(v, d_before[name]), name
    if not gate:
        assert port_d_opt.state == {}
        for name, p in disc.named_parameters():
            assert torch.equal(p.detach(), d_before[name]), name
            np.testing.assert_array_equal(d_after[name].numpy(), d_before[name].numpy())
        return
    mu, nu = _to_port(adam.mu), _to_port(adam.nu)
    for name, p in disc.named_parameters():
        state = port_d_opt.state[p]
        assert int(state["step"]) == 1
        _close(state["exp_avg"], mu[name], D_TOL, err_msg=name)
        _close(state["exp_avg_sq"], nu[name], 2 * D_TOL, err_msg=name)
        _check_update(name, d_before[name].numpy(), p.detach().numpy(),
                      d_after[name].numpy(), mu[name].numpy(), cfg.disc_lr)


def test_step_takes_uint8_and_rejects_data_parallel(inputs):
    """A uint8 batch is divided by 255 on its device; the data-parallel
    step (num_devices > 1, on the cards unless a mesh is given) rejects a
    batch that does not divide over its shards
    (tests/test_torch_hific_dp.py tests the step itself)."""
    _, lp, _, model0, disc0 = inputs
    cfg = hific.HificConfig(**SMALL)
    x8 = (np.random.RandomState(3).rand(1, 64, 64, 3) * 255).astype(np.uint8)
    metrics = []
    for batch in (torch.from_numpy(x8), torch.from_numpy(x8.astype(np.float32) / 255.0)):
        model, disc = copy.deepcopy(model0), copy.deepcopy(disc0)
        step, _, _ = hific.make_train_steps(model, disc, lp, cfg)
        metrics.append(step(batch, torch.Generator().manual_seed(0)))
    for k in metrics[0]:
        assert torch.equal(metrics[0][k], metrics[1][k]), k
    from compression_tpu_torch.parallel import make_mesh
    from compression_tpu_torch.parallel.data_parallel import shard_generators

    mesh = make_mesh(2, device="cpu")
    step, _, _ = hific.make_train_steps(model, disc, lp, cfg, num_devices=2, mesh=mesh)
    with pytest.raises(ValueError, match="does not divide over 2 devices"):
        step(torch.from_numpy(x8), shard_generators(0, mesh))
