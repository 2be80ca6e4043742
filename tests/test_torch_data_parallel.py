"""The port's data-parallel training (``parallel/data_parallel.py``) on a
mesh of virtual CPU shards: the step against the mean of per-shard
gradients built from the one-device pieces (the JAX package's
tests/test_parallel.py), replicas on a second device, the step against the
JAX package's ``make_dp_step`` on 4 of its 8 virtual devices, and
``train_model`` with ``num_devices > 1``: its batch check and its
checkpoints, which resume on one device in both packages. Sizes are tiny
(4-8 filters, 32x32 or 64x64)."""

import copy
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from compression_tpu.models import bmshj2018 as jax_bmshj2018
from compression_tpu.models import common as jax_common
from compression_tpu.parallel import data_parallel as jax_dp
from compression_tpu_torch.models import bls2017, bmshj2018, common
from compression_tpu_torch.parallel import make_dp_step, make_mesh, shard_batch
from compression_tpu_torch.parallel.data_parallel import Mesh, fold_in, shard_generators

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_train import SMALL, _jax_params, _Quantized, _to_port  # noqa: E402

torch.set_num_threads(1)

FAMILIES = {
    "bls2017": (lambda: bls2017.BLS2017Model(bls2017.Config(num_filters=4), seed=0),
                bls2017.make_loss_fn, 32),
    "bmshj2018": (lambda: bmshj2018.BMSHJ2018Model(bmshj2018.Config(**SMALL), seed=0),
                  bmshj2018.make_loss_fn, 64),
}


def _batch(n, hw, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).rand(n, hw, hw, 3).astype(np.float32))


def _mean_of_shard_grads_step(model, make_loss_fn, optimizer, x, generators):
    """The reference: the one-device loss on each shard with that shard's
    generator, the mean of the losses and of the gradients, one update."""
    loss_fn = make_loss_fn(model)
    n = len(generators)
    losses, sums = [], None
    for d, gen in enumerate(generators):
        loss, _ = loss_fn(x[d * (len(x) // n):(d + 1) * (len(x) // n)], gen)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        sums = list(grads) if sums is None else [a + g for a, g in zip(sums, grads)]
        losses.append(loss.detach())
    for p, g in zip(model.parameters(), sums):
        p.grad = g / n
    optimizer.step()
    return torch.stack(losses).mean()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_dp_step_matches_the_mean_of_shard_gradients(family):
    """4 shards with training noise: loss and every updated parameter
    within rtol 1e-5, atol 1e-6 of the reference (tests/test_parallel.py's
    tolerance), with Adam at the port's optax-matching settings."""
    make_model, make_loss_fn, hw = FAMILIES[family]
    mesh = make_mesh(4, device="cpu")
    x = _batch(4, hw)
    model, ref = make_model(), make_model()
    tcfg = common.TrainConfig(learning_rate=1e-3)
    step = make_dp_step(lambda m, b, g: make_loss_fn(m)(b, g),
                        common.make_optimizer(model, tcfg), mesh=mesh)
    metrics = step(model, shard_batch(x, mesh), shard_generators(2, mesh))
    want = _mean_of_shard_grads_step(ref, make_loss_fn, common.make_optimizer(ref, tcfg),
                                     x, shard_generators(2, mesh))
    assert sorted(metrics) == ["bpp", "loss", "mse"]
    np.testing.assert_allclose(metrics["loss"].item(), want.item(), rtol=1e-5)
    for (name, p), q in zip(model.named_parameters(), ref.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_one_shard_step_is_the_train_step():
    """A mesh of one: the same update as ``common.train_step`` (a uint8
    batch divided by 255 on the shard's device), within rtol 1e-6."""
    make_model, make_loss_fn, hw = FAMILIES["bmshj2018"]
    x8 = (np.random.RandomState(3).rand(2, hw, hw, 3) * 255).astype(np.uint8)
    tcfg = common.TrainConfig(learning_rate=1e-3)
    model, ref = make_model(), make_model()
    mesh = make_mesh(1, device="cpu")
    step = make_dp_step(lambda m, b, g: make_loss_fn(m)(b, g),
                        common.make_optimizer(model, tcfg), mesh=mesh)
    got = step(model, torch.from_numpy(x8), shard_generators(4, mesh))
    want, _ = common.train_step(ref, common.make_optimizer(ref, tcfg), make_loss_fn(ref),
                                torch.from_numpy(x8), shard_generators(4, mesh)[0],
                                common.lr_schedule(tcfg))
    np.testing.assert_allclose(got["loss"].item(), want.item(), rtol=1e-6)
    for p, q in zip(model.parameters(), ref.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), rtol=1e-6,
                                   atol=1e-9)


def test_replicas_on_a_second_device_stay_equal():
    """Shards on two distinct devices (``cpu`` and ``cpu:0`` are distinct
    to the mesh): the second device gets copies of the parameters, its
    shards' gradients are added on the model's device, and after the step
    the copies equal the updated model (tests/test_parallel.py's replicated
    update); the update equals the one-device mesh's."""
    make_model, make_loss_fn, hw = FAMILIES["bls2017"]
    x = _batch(4, hw, seed=1)
    other = torch.device("cpu", 0)
    runs = []
    for mesh in (make_mesh(4, device="cpu"), Mesh(("cpu", other, "cpu", other))):
        model = make_model()
        step = make_dp_step(lambda m, b, g: make_loss_fn(m)(b, g),
                            torch.optim.SGD(model.parameters(), lr=1e-2), mesh=mesh)
        step(model, x, shard_generators(5, mesh))
        runs.append((model, step.replicas))
    (shared, _), (model, replicas) = runs
    assert replicas.devices() == [torch.device("cpu"), other]
    copies = replicas.parameters(other)
    assert all(c is not p for c, p in zip(copies, model.parameters()))
    for p, c, q in zip(model.parameters(), copies, shared.parameters()):
        assert torch.isfinite(p).all()
        assert torch.equal(p, c)
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), rtol=1e-6,
                                   atol=1e-9)


def test_shards_draw_their_own_noise():
    mesh = make_mesh(4, device="cpu")
    draws = [torch.rand(3, generator=g) for g in shard_generators(9, mesh)]
    again = [torch.rand(3, generator=g) for g in shard_generators(9, mesh)]
    assert all(torch.equal(a, b) for a, b in zip(draws, again))
    assert len({tuple(d.tolist()) for d in draws}) == 4
    assert fold_in(9, 0) != fold_in(9, 1) != fold_in(10, 1)


def test_dp_step_matches_jax_make_dp_step():
    """The port's 4-shard step against the JAX package's ``make_dp_step``
    on 4 of the 8 virtual devices, both deterministic (training=False: the
    JAX model through tests/test_torch_train.py's _Quantized) and both with
    plain SGD, so the update is -lr times the mean gradient and every
    gradient shows. Tolerance: the loss 1e-5 relative; each parameter's
    gradient (the update over -lr) 1e-3 relative plus 1e-4 of its largest
    entry, the port-vs-JAX gradient tolerance of test_torch_train.py."""
    lr = 0.5
    model = bmshj2018.BMSHJ2018Model(bmshj2018.Config(**SMALL), seed=1)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    x = np.random.RandomState(2).rand(4, 64, 64, 3).astype(np.float32)
    params = _jax_params(model)
    jax_model = jax_bmshj2018.BMSHJ2018Model(jax_bmshj2018.Config(**SMALL))
    tx = optax.sgd(lr)
    jstep = jax_dp.make_dp_step(jax_bmshj2018.make_loss_fn(_Quantized(jax_model)), tx, 4)
    new_params, _, jmetrics = jstep(params, tx.init(params),
                                    jax_dp.shard_batch(jnp.asarray(x), jax_dp.make_mesh(4)),
                                    jax.random.PRNGKey(0))
    mesh = make_mesh(4, device="cpu")
    step = make_dp_step(lambda m, b, g: bmshj2018.make_loss_fn(m, training=False)(b, g),
                        torch.optim.SGD(model.parameters(), lr=lr), mesh=mesh)
    metrics = step(model, torch.from_numpy(x), shard_generators(0, mesh))
    for k in ("loss", "bpp", "mse"):
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), rtol=1e-5,
                                   err_msg=k)
    want = _to_port(new_params)
    for name, p in model.named_parameters():
        got_g = (before[name] - p.detach()).numpy() / lr
        want_g = (before[name] - want[name]).numpy() / lr
        np.testing.assert_allclose(got_g, want_g, rtol=1e-3,
                                   atol=1e-4 * np.abs(want_g).max(), err_msg=name)


def test_mesh_and_batch_checks():
    mesh = Mesh((torch.device("cpu"),) * 4)
    assert mesh.shape == {"data": 4} and mesh.size == 4
    assert make_mesh(3, device="cpu").devices == (torch.device("cpu"),) * 3
    for n in (0, os.cpu_count() + 1):
        with pytest.raises(ValueError, match="this process sees"):
            make_mesh(n, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh(1)
    shards = shard_batch(np.zeros((8, 2, 2, 3), np.float32), mesh)
    assert [tuple(s.shape) for s in shards] == [(2, 2, 2, 3)] * 4
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(np.zeros((6, 2, 2, 3)), mesh)


def test_dp_train_model_checkpoint_resumes_on_one_device_in_both_packages(tmp_path, capsys):
    """``train_model`` at num_devices 2 on the CPU writes the one-device
    checkpoint layout: the port resumes it on one device (numbering its
    step 3) and the JAX package's load_checkpoint reads it with its
    optimizer's template (params, step, Adam's count and moments)."""
    tcfg = common.TrainConfig(batch_size=2, patch_size=64, steps=2, log_every=1,
                              checkpoint_every=2, checkpoint_dir=str(tmp_path),
                              checkpoint_name="dp.msgpack", seed=1, num_devices=2)
    model = bmshj2018.train(bmshj2018.Config(**SMALL), tcfg, device="cpu")
    path = str(tmp_path / "dp.msgpack")
    params, step, adam = common.load_checkpoint(path)
    assert step == 2 and adam["count"] == 2
    for n, t in model.state_dict().items():
        assert torch.equal(params[n], t), n

    template = _jax_params(bmshj2018.BMSHJ2018Model(bmshj2018.Config(**SMALL), seed=0))
    jparams, jstep, jopt = jax_common.load_checkpoint(
        path, template, optax.adam(tcfg.learning_rate).init(template))
    assert jstep == 2 and int(jopt[0].count) == 2
    for n, t in _to_port(jparams).items():
        assert torch.equal(t, model.state_dict()[n]), n
    for n, t in _to_port(jopt[0].mu).items():
        assert torch.equal(t, adam["mu"][n]), n

    capsys.readouterr()
    resumed = bmshj2018.BMSHJ2018Model(bmshj2018.Config(**SMALL), seed=5)
    seen = []
    common.train_model(resumed, bmshj2018.make_loss_fn(resumed),
                       dataclasses.replace(tcfg, steps=3, num_devices=1),
                       hooks=lambda s, m: seen.append(s), device="cpu")
    assert "resumed from" in capsys.readouterr().out and seen == [3]


def test_dp_train_model_trains_like_the_mean_step():
    """Two DP steps of ``train_model`` move the parameters as two steps of
    the reference (the same crops, shard d's noise from ``(seed, d)``)."""
    tcfg = common.TrainConfig(batch_size=4, patch_size=64, steps=2, log_every=10,
                              seed=3, num_devices=4)
    model = bmshj2018.BMSHJ2018Model(bmshj2018.Config(**SMALL), seed=0)
    ref = copy.deepcopy(model)
    common.train_model(model, bmshj2018.make_loss_fn(model), tcfg, device="cpu")
    data = common.crop_dataset(tcfg)
    next(data)
    mesh = make_mesh(4, device="cpu")
    gens = shard_generators(tcfg.seed, mesh)
    optimizer = common.make_optimizer(ref, tcfg)
    for _ in range(2):
        common._set_lr(optimizer, tcfg.learning_rate)
        _mean_of_shard_grads_step(ref, bmshj2018.make_loss_fn, optimizer,
                                  torch.from_numpy(next(data)), gens)
    for p, q in zip(model.parameters(), ref.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), rtol=1e-5,
                                   atol=1e-6)
