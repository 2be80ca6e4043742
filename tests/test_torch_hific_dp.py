"""HiFiC's data-parallel joint G/D step (``make_train_steps`` on a mesh)
against the same math on one device, as the JAX package's
tests/test_hific.py checks its own: the mean of the per-shard G losses
with each shard's generator, G's and D's gradients averaged over the
shards; the rate hinge decided on the shards' mean rate; the
discriminator's spectral-norm state advanced once a step; the GAN warm-up.
2 shards of one 64x64 crop, 8 latents, 4 hyperlatents, one residual block.

The reference runs the port's one-device loss functions
(``make_loss_fns``) shard by shard; DP and reference differ only in the
order of float32 sums, so gradients agree within 1e-5 relative plus 1e-6
of each tensor's largest entry."""

import copy

import numpy as np
import pytest
import torch

from compression_tpu_torch.models import hific
from compression_tpu_torch.models.hific import archs, lpips
from compression_tpu_torch.parallel import make_mesh
from compression_tpu_torch.parallel.data_parallel import shard_generators

torch.set_num_threads(1)

SMALL = dict(name="hific-test", num_latents=8, num_hyperlatents=4, num_residual_blocks=1)
N = 2
SEED = 5


@pytest.fixture(scope="module")
def parts():
    """A batch of 2 different crops (a flat one, a noisy one), LPIPS on
    random features, seeded G and D (each test steps copies)."""
    rng = np.random.RandomState(0)
    x = np.concatenate([np.full((1, 64, 64, 3), 0.5, np.float32),
                        rng.rand(1, 64, 64, 3).astype(np.float32)])
    lp = lpips.LPIPS(seed=7).requires_grad_(False)
    return torch.from_numpy(x), lp


def _models(cfg):
    return hific.HificModel(cfg, seed=1), archs.Discriminator(cfg.num_latents, seed=2)


def _close(got, want, err_msg=""):
    want = want.detach().numpy()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max(), err_msg=err_msg)


def _reference(model, disc, lp, cfg, x, lam_override=-1.0, gate=True):
    """One device, shard by shard: the mean G loss and G's gradients, then
    D's per-shard losses from the step's starting spectral-norm state and
    their mean gradients. Returns (g_loss, g_grads, d_grads, hinges)."""
    g_loss_fn, d_loss_fn = hific.make_loss_fns(model, disc, lp, cfg)
    gens = shard_generators(SEED, make_mesh(N, device="cpu"))
    losses, auxes = zip(*(g_loss_fn(x[d:d + 1], gens[d], lam_override=lam_override)
                          for d in range(N)))
    g_loss = torch.stack(losses).mean()
    g_grads = torch.autograd.grad(g_loss, list(model.parameters()))
    start = {k: v.clone() for k, v in disc.state_dict().items()}
    d_grads = None
    for d in range(N):
        disc.load_state_dict(start)
        loss = d_loss_fn(x[d:d + 1], auxes[d]["x_hat"].detach(), auxes[d]["y_hat"].detach())
        if gate:
            grads = torch.autograd.grad(loss, list(disc.parameters()))
            d_grads = list(grads) if d_grads is None else [a + g for a, g in zip(d_grads, grads)]
    if gate:
        d_grads = [g / N for g in d_grads]
    return g_loss, g_grads, d_grads, [a["hinge_bpp"] for a in auxes]


def _dp_step(model, disc, lp, cfg, x, step_idx=None):
    step, g_opt, d_opt = hific.make_train_steps(model, disc, lp, cfg,
                                                mesh=make_mesh(N, device="cpu"))
    metrics = step(x, shard_generators(SEED, make_mesh(N, device="cpu")), step_idx)
    return metrics, g_opt, d_opt


def test_dp_gan_step_matches_single_device(parts):
    """target_rate=0 pins the hinge to lambda_a on every shard and globally
    (as in tests/test_hific.py): the DP step's G loss is the mean of the
    shards' one-device losses, its G and D gradients (left on ``.grad``
    by the step) the means of theirs, and its updates Adam's on them."""
    x, lp = parts
    cfg = hific.HificConfig(**SMALL, target_rate=0.0)
    model, disc = _models(cfg)
    ref_model, ref_disc = copy.deepcopy(model), copy.deepcopy(disc)
    metrics, g_opt, d_opt = _dp_step(model, disc, lp, cfg, x)
    g_loss, g_grads, d_grads, _ = _reference(ref_model, ref_disc, lp, cfg, x)
    np.testing.assert_allclose(metrics["g_loss"].item(), g_loss.item(), rtol=1e-6)
    assert metrics["lam"].item() == cfg.lambda_a and metrics["gan_on"].item() == 1.0
    for (name, p), g in zip(model.named_parameters(), g_grads):
        _close(p.grad, g, name)
    for (name, p), g in zip(disc.named_parameters(), d_grads):
        _close(p.grad, g, name)
    ref_g = torch.optim.Adam(ref_model.parameters(), lr=cfg.lr, eps=1e-8)
    for p, g in zip(ref_model.parameters(), g_grads):
        p.grad = g
    ref_g.step()
    for p, q in zip(model.parameters(), ref_model.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), rtol=0,
                                   atol=2.5 * cfg.lr)
    assert all(st["step"] == 1 for st in d_opt.state.values()) and d_opt.state
    assert all(torch.isfinite(v).all() for v in metrics.values())


def test_rate_hinge_is_a_global_batch_decision(parts):
    """A target between the two shards' own rates: alone, the flat crop's
    shard would take lambda_b and the noisy one lambda_a; the DP step
    compares the shards' mean, which is above the target, so both shards'
    G losses take lambda_a, and G's gradients are those of the reference
    with lambda_a on both shards, not those of the per-shard hinges."""
    x, lp = parts
    probe = hific.HificConfig(**SMALL, target_rate=0.3)
    m0, d0 = _models(probe)
    _, _, _, hinges = _reference(copy.deepcopy(m0), copy.deepcopy(d0), lp, probe, x,
                                 gate=False)
    lo, hi = sorted(h.item() for h in hinges)
    mean = (lo + hi) / 2
    cfg = hific.HificConfig(**SMALL, target_rate=(lo + mean) / 2)
    model, disc = copy.deepcopy(m0), copy.deepcopy(d0)
    metrics, _, _ = _dp_step(model, disc, lp, cfg, x)
    np.testing.assert_allclose(metrics["hinge_bpp"].item(), mean, rtol=1e-5)
    assert metrics["lam"].item() == cfg.lambda_a
    assert metrics["hinge_on"].item() == 1.0
    _, global_grads, _, _ = _reference(copy.deepcopy(m0), copy.deepcopy(d0), lp, cfg, x,
                                       lam_override=cfg.lambda_a)
    _, local_grads, _, _ = _reference(copy.deepcopy(m0), copy.deepcopy(d0), lp, cfg, x)
    for (name, p), g in zip(model.named_parameters(), global_grads):
        _close(p.grad, g, name)
    rate_grads = [(p.grad, g) for (name, p), g in zip(model.named_parameters(), local_grads)
                  if name.startswith("hyper")]
    assert any(not torch.allclose(a, b, rtol=1e-3) for a, b in rate_grads)


@pytest.mark.parametrize("step_idx", [None, 0])
def test_spectral_norm_state_advances_once(parts, step_idx):
    """After a DP step D's u and sigma equal those one device reaches from
    the same state in one step (its real and fake passes), not those of a
    pass a shard; during the GAN warm-up (step 0 of 1) D's params and its
    Adam state stay as they were and its state still advances once."""
    x, lp = parts
    cfg = hific.HificConfig(**SMALL, target_rate=0.3, gan_warmup_steps=1)
    model, disc = _models(cfg)
    one, twice = copy.deepcopy(disc), copy.deepcopy(disc)
    d_before = {k: v.clone() for k, v in disc.named_parameters()}
    _, _, d_opt = _dp_step(model, disc, lp, cfg, x, step_idx)
    y = torch.zeros(1, 4, 4, cfg.num_latents)
    with torch.no_grad():
        for passes, d in ((2, one), (2 * N, twice)):
            for _ in range(passes):
                d(x[:1], y, update_stats=True)
    buffers = dict(disc.named_buffers())
    assert buffers
    for name, want in one.named_buffers():
        assert torch.allclose(buffers[name], want, rtol=1e-6, atol=1e-7), name
    assert any(not torch.allclose(buffers[n], b, rtol=1e-6, atol=1e-7)
               for n, b in twice.named_buffers() if n.endswith(".u"))
    moved = any(not torch.equal(p, d_before[n]) for n, p in disc.named_parameters())
    assert moved == (step_idx is None)
    assert bool(d_opt.state) == (step_idx is None)


def test_dp_step_takes_uint8_and_rejects_a_batch_that_does_not_divide(parts):
    x, lp = parts
    cfg = hific.HificConfig(**SMALL, target_rate=0.3)
    x8 = torch.from_numpy((x.numpy() * 255).astype(np.uint8))
    metrics = []
    for batch in (x8, x8.to(torch.float32) / 255.0):
        model, disc = _models(cfg)
        metrics.append(_dp_step(model, disc, lp, cfg, batch)[0])
    for k in metrics[0]:
        assert torch.equal(metrics[0][k], metrics[1][k]), k
    model, disc = _models(cfg)
    with pytest.raises(ValueError, match="does not divide"):
        _dp_step(model, disc, lp, cfg, x8[:1])


def test_train_runs_data_parallel_and_checks_the_batch(tmp_path):
    """``hific.train`` with num_devices 2 on the CPU: data-parallel joint
    steps, finite metrics, a G checkpoint; num_devices 3 with a batch of 2
    raises the JAX package's message."""
    from compression_tpu_torch.models import common

    cfg = hific.HificConfig(**SMALL, target_rate=0.3)
    tcfg = common.TrainConfig(batch_size=2, patch_size=64, steps=2, log_every=1,
                              checkpoint_dir=str(tmp_path), num_devices=2)
    seen = []
    model, _ = hific.train(cfg, tcfg, hooks=lambda s, m: seen.append(m), device="cpu")
    assert [len(seen), all(np.isfinite(v) for m in seen for v in m.values())] == [2, True]
    assert common.load_checkpoint(str(tmp_path / tcfg.checkpoint_name))[1] == 2
    with pytest.raises(ValueError, match=r"batch_size \(2\) must be divisible by "
                                         r"num_devices \(3\)"):
        hific.train(cfg, common.TrainConfig(batch_size=2, patch_size=64, steps=1,
                                            num_devices=3), device="cpu")
