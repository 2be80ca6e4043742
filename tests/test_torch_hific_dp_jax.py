"""HiFiC's data-parallel joint step against the JAX package's
``make_train_steps(num_devices=2)`` on 2 of the virtual CPU devices, with
each JAX device's noise (``fold_in(rng, axis_index)``) fed to the port's
shard: the mean metrics, G's and D's mean gradients (as Adam's first
moments, 0.1 g after one step) and the spectral-norm state after the step.
Two crops of 64x64 (a flat one, a noisy one); the config of
tests/test_torch_hific_archs.py with a hinge ring of 1; the JAX params are the port's seeded
models through the weight bridge.

Cases: the bang-bang hinge with the target between the shards' own rates
(each shard alone would pick another lambda; the mean picks lambda_a), and
the log-proportional law (``hinge_softness > 0``) with the target at the
mean rate, where lambda lies strictly between its arms and G's gradient
flows through the shards' mean ``hinge_bpp`` into every shard.

Tolerances as tests/test_torch_hific_step.py: metrics 1e-5 relative;
gradients 1e-3 relative plus 2e-3 (G) or 5e-4 (D) of each tensor's
largest entry."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
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
from compression_tpu_torch.parallel import make_mesh
from compression_tpu_torch.parallel.data_parallel import shard_generators
from test_torch_hific_archs import SMALL, jax_d_vars, jax_g_params
from test_torch_hific_step import D_TOL, G_TOL, _adam_state, _close, _jax_noise, _to_port

torch.set_num_threads(1)

N = 2
# A ring of 1 leaves a 2x2 interior of the 4x4 y, so the hinge reads the
# interior rate, as at training sizes.
SMALL = {**{k: v for k, v in SMALL.items() if k != "target_rate"}, "hinge_boundary_ring": 1}


@pytest.fixture(scope="module")
def inputs():
    """The batch, LPIPS in both packages, seeded G and D, and the shards'
    own hinge rates under the JAX package's noise."""
    rng = np.random.RandomState(0)
    x = np.concatenate([np.full((1, 64, 64, 3), 0.5, np.float32),
                        rng.rand(1, 64, 64, 3).astype(np.float32)])
    lp = lpips.LPIPS(seed=7).requires_grad_(False)
    lp_params = {"params": jax.tree_util.tree_map(
        jnp.asarray, convert.params_to_numpy(lp.state_dict()))}
    cfg = hific.HificConfig(**SMALL, target_rate=1.0)  # no effect on the rates
    model, disc = hific.HificModel(cfg, seed=1), archs.Discriminator(cfg.num_latents, seed=2)
    rng = jax.random.PRNGKey(5)
    noise = [_jax_noise(jax.random.fold_in(rng, d), x[d:d + 1], cfg) for d in range(N)]
    g_loss_fn, _ = hific.make_loss_fns(model, disc, lp, cfg)
    hinges = []
    with torch.no_grad():
        for d in range(N):
            draws = [torch.from_numpy(a) for a in noise[d]]
            with pytest.MonkeyPatch.context() as mp:
                for module in (continuous_batched, continuous_indexed):
                    mp.setattr(module, "uniform_noise", lambda t, g: draws.pop(0))
                hinges.append(g_loss_fn(torch.from_numpy(x[d:d + 1]), None)[1]["hinge_bpp"])
    return x, lp, lp_params, model, disc, rng, [h.item() for h in hinges]


def _overrides(case, hinges):
    lo, hi = sorted(hinges)
    mean = (lo + hi) / 2
    if case == "global bang-bang":
        return dict(target_rate=(lo + mean) / 2)
    return dict(target_rate=mean, hinge_softness=1.0)


@pytest.mark.parametrize("case", ["global bang-bang", "softness"])
def test_dp_joint_step_matches_jax(inputs, monkeypatch, case):
    x, lp, lp_params, model, disc, rng, hinges = inputs
    cfg = hific.HificConfig(**SMALL, **_overrides(case, hinges))
    model, disc = copy.deepcopy(model), copy.deepcopy(disc)
    model.config = cfg
    d_before = {k: v.clone() for k, v in disc.state_dict().items()}

    jcfg = jax_hific.HificConfig(**SMALL, **_overrides(case, hinges))
    step, g_tx, d_tx = jax_hific.make_train_steps(
        jax_hific.HificModel(jcfg), jax_archs.Discriminator(), jax_lpips.LPIPS(), lp_params,
        jcfg, num_devices=N)
    g_params, d_vars = jax_g_params(model), jax_d_vars(disc)
    _, d_new, g_opt, d_opt, want = step(
        g_params, d_vars, g_tx.init(g_params), d_tx.init(d_vars["params"]), jnp.asarray(x),
        rng)

    noise = [a for d in range(N)
             for a in _jax_noise(jax.random.fold_in(rng, d), x[d:d + 1], cfg)]

    def pinned(t, generator):
        draw = torch.from_numpy(noise.pop(0))
        assert draw.shape == t.shape
        return draw

    for module in (continuous_batched, continuous_indexed):
        monkeypatch.setattr(module, "uniform_noise", pinned)
    mesh = make_mesh(N, device="cpu")
    port_step, port_g_opt, port_d_opt = hific.make_train_steps(model, disc, lp, cfg,
                                                               mesh=mesh)
    got = port_step(torch.from_numpy(x), shard_generators(0, mesh))
    assert noise == []

    assert sorted(got) == sorted(want)
    for k, v in got.items():
        np.testing.assert_allclose(v.item(), float(want[k]), rtol=1e-5, err_msg=k)
    if cfg.hinge_softness > 0.0:
        assert cfg.lambda_b < got["lam"].item() < cfg.lambda_a
    else:
        assert got["lam"].item() == cfg.lambda_a and got["hinge_on"].item() == 1.0

    for opt, port_opt, module, tol in ((g_opt, port_g_opt, model, G_TOL),
                                       (d_opt, port_d_opt, disc, D_TOL)):
        mu = _to_port(_adam_state(opt).mu)
        named = dict(module.named_parameters())
        assert sorted(named) == sorted(mu)
        for name, p in named.items():
            _close(port_opt.state[p]["exp_avg"], mu[name], tol, err_msg=name)

    d_after = convert.variables_from_numpy(jax.tree_util.tree_map(
        np.asarray, serialization.to_state_dict(d_new)))
    for name, v in disc.state_dict().items():
        if name.endswith((".u", ".sigma")):
            np.testing.assert_allclose(v.numpy(), d_after[name].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=name)
            assert not torch.equal(v, d_before[name]), name

