"""The port's toy sources against the JAX package's (tests/test_parallel_extras
.py:166-205). The random streams differ, so the samples are pinned with numpy
and the weights through the weight bridge: the NTC model's forward, rate
and gradients, a few Adam steps on a fixed batch (float32, 1e-5 relative of
each tensor's largest entry), its codec strings byte-identical with the
tables pinned, and ECVQ's assignment and update; then the drivers
(train, compress_samples, train_ecvq, rd_point_*, compare_ntc_vq) on the
CPU at a small size."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flax import serialization

from compression_tpu.distributions.deep_factorized import DeepFactorized as JaxDF
from compression_tpu.models import toy_sources as jax_toy
from compression_tpu_torch.convert import params_from_numpy, params_to_numpy
from compression_tpu_torch.models import toy_sources as toy

torch.set_num_threads(1)

CFG = dict(hidden=16, layers=2, lmbda=10.0)


def _pair(seed=0, dtype=np.float32):
    """The port's seeded model, and its params as the JAX model's tree, in
    ``dtype``."""
    model = toy.NTCModel(toy.Config(**CFG), torch.Generator().manual_seed(seed))
    tree = params_to_numpy(model.state_dict())
    if dtype == np.float64:
        model.double()
    prior = tree["prior"].pop("deep_factorized")
    tree = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)
    tree["prior"]["deep_factorized"] = JaxDF(*(
        tuple(jnp.asarray(prior[f][str(i)], dtype) for i in range(len(prior[f])))
        for f in ("matrices", "biases", "factors")))
    return model, jax_toy.NTCModel(jax_toy.Config(**CFG)), {"params": tree}


def _leaf(tree, name):
    """The JAX tree's entry of a port parameter name, in float64 (the
    bridge's own mapping rounds to float32): a Dense kernel transposed."""
    *path, leaf = name.split(".")
    node = serialization.to_state_dict(tree)["params"]
    if path[0] == "prior":
        return node["prior"]["deep_factorized"][path[1]][leaf]
    node = node[path[0]][path[1]]
    return node["bias"] if leaf == "bias" else np.asarray(node["kernel"]).T


def _to_port(tree):
    """A JAX param-shaped tree (params, grads) as a state dict."""
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(tree)))


def _samples(n, seed=0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    x = rng.randn(n)
    return np.stack([x, rng.randn(n) * 0.5 + 0.25 * x ** 2 - 2.0], -1).astype(dtype)


def _assert_close(got, want, rel=1e-5):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale)


def test_bridge_maps_dense_kernels_both_ways():
    model, jax_model, params = _pair()
    flax_tree = jax_model.init(jax.random.PRNGKey(0), jnp.zeros((2, 2)), jax.random.PRNGKey(1))
    shapes = jax.tree_util.tree_map(lambda a: a.shape, serialization.to_state_dict(flax_tree))
    assert jax.tree_util.tree_map(lambda a: a.shape, serialization.to_state_dict(params)) == shapes
    assert params["params"]["analysis"]["dense0"]["kernel"].shape == (2, 16)
    state = _to_port(params)
    for key, value in model.state_dict().items():
        torch.testing.assert_close(state[key], value, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_forward_rate_and_gradients_equal_jax(dtype):
    """float32 forward and rate at 1e-5; the gradients, sums over the batch
    whose float32 rounding differs with the order of the sum, in float64
    at 1e-9."""
    model, jax_model, params = _pair(1, dtype)
    x = _samples(64, 1, dtype)
    rel = 1e-5 if dtype == np.float32 else 1e-9

    def jax_loss(p):
        x_hat, bits = jax_model.apply(p, jnp.asarray(x), None, training=False)
        rate = jnp.mean(bits)
        dist = jnp.mean(jnp.sum((jnp.asarray(x) - x_hat) ** 2, -1))
        return rate + CFG["lmbda"] * dist, (x_hat, bits)

    (want_loss, (want_x_hat, want_bits)), want_g = jax.value_and_grad(jax_loss, has_aux=True)(params)
    x_hat, bits = model(torch.from_numpy(x), None, training=False)
    loss = torch.mean(bits) + CFG["lmbda"] * torch.mean(torch.sum((torch.from_numpy(x) - x_hat) ** 2, -1))
    loss.backward()
    _assert_close(x_hat.detach().numpy(), np.asarray(want_x_hat), rel)
    _assert_close(bits.detach().numpy(), np.asarray(want_bits), rel)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=rel)
    if dtype == np.float64:
        for name, p in model.named_parameters():
            _assert_close(p.grad.numpy(), np.asarray(_leaf(want_g, name)), rel)


def test_adam_steps_on_a_fixed_batch_equal_optax():
    """Three steps in float64, at 1e-7 of each tensor's largest entry:
    Adam's update divides by the gradient's root mean square, so where a
    gradient is near eps an ulp of it moves the step by far more than one
    (in float32 a bias moved by 4e-4 of its size)."""
    model, jax_model, params = _pair(2, np.float64)
    x = _samples(128, 2, np.float64)
    tx = optax.adam(1e-3)
    opt_state = tx.init(params)

    @jax.jit
    def step(p, s):
        def loss(q):
            x_hat, bits = jax_model.apply(q, jnp.asarray(x), None, training=False)
            return jnp.mean(bits) + CFG["lmbda"] * jnp.mean(jnp.sum((jnp.asarray(x) - x_hat) ** 2, -1))

        g = jax.grad(loss)(p)
        updates, s = tx.update(g, s, p)
        return optax.apply_updates(p, updates), s

    optimizer = torch.optim.Adam(model.parameters(), lr=1e-3)
    xt = torch.from_numpy(x)
    for _ in range(3):
        params, opt_state = step(params, opt_state)
        loss = toy._loss(model, xt, None, training=False)[0]
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
    for name, p in model.named_parameters():
        _assert_close(p.detach().numpy(), np.asarray(_leaf(params, name)), 1e-7)


def test_codec_strings_equal_jax_with_tables_pinned():
    from compression_tpu.entropy_models import ContinuousBatchedEntropyModel as JaxBatched
    from compression_tpu_torch.entropy_models import ContinuousBatchedEntropyModel

    model, jax_model, params = _pair(3)
    x = _samples(50, 3)
    jax_prior = jax_model.apply(params, method=jax_toy.NTCModel.get_prior)
    tables = JaxBatched(jax_prior, coding_rank=2, compression=True).tables
    em = ContinuousBatchedEntropyModel(model.prior(), coding_rank=2, tables=tables)
    y = np.asarray(jax_model.apply(params, jnp.asarray(x), method=jax_toy.NTCModel.analyze))
    with torch.no_grad():
        y_port = model.analysis(torch.from_numpy(x))
    _assert_close(y_port.numpy(), y)
    want = JaxBatched(jax_prior, coding_rank=2, tables=tables).compress(jnp.asarray(y)[None])
    assert em.compress(torch.from_numpy(y)[None]) == want
    got = ContinuousBatchedEntropyModel(model.prior(), coding_rank=2, compression=True).tables
    np.testing.assert_array_equal(got.cdf, tables.cdf)


def test_ecvq_assign_and_update_equal_jax():
    rng = np.random.RandomState(4)
    codebook = rng.randn(32, 2).astype(np.float32)
    p = rng.dirichlet(np.ones(32)).astype(np.float32)
    x = _samples(512, 4)
    q = toy.ECVQ(torch.from_numpy(codebook), torch.from_numpy(np.log2(p)), 3.0)
    jq = jax_toy.ECVQ(jnp.asarray(codebook), jnp.asarray(np.log2(p)), 3.0)
    idx = q.assign(torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jq.assign(jnp.asarray(x))))
    r, d = q.rate_distortion(torch.from_numpy(x))
    wr, wd = jq.rate_distortion(jnp.asarray(x))
    np.testing.assert_allclose([float(r), float(d)], [float(wr), float(wd)], rtol=1e-5)
    cb, log2_p = toy.ecvq_update(q, torch.from_numpy(x))
    counts = np.asarray(jax.ops.segment_sum(jnp.ones(512, jnp.float32), jnp.asarray(idx.numpy()), 32))
    sums = np.asarray(jax.ops.segment_sum(jnp.asarray(x), jnp.asarray(idx.numpy()), 32))
    want_cb = np.where(counts[:, None] > 0, sums / np.maximum(counts[:, None], 1.0), codebook)
    want_p = np.maximum(counts / 512, 1e-8)
    _assert_close(cb.numpy(), want_cb)
    np.testing.assert_allclose(log2_p.numpy(), np.log2(want_p / want_p.sum()), rtol=1e-5)


def test_argmin_takes_the_first_of_tied_codewords():
    q = toy.ECVQ(torch.tensor([[1.0, 0.0], [1.0, 0.0], [-1.0, 0.0]]), torch.full((3,), -1.0), 1.0)
    np.testing.assert_array_equal(q.assign(torch.tensor([[1.0, 0.0], [-1.0, 0.0]])).numpy(), [0, 2])


@pytest.mark.parametrize("source", ["banana", "gaussian", "laplacian"])
def test_sources_match_their_distributions(source):
    gen = torch.Generator().manual_seed(0)
    x = getattr(toy, source)(gen, 20000).numpy()
    assert x.shape == (20000, 2)
    if source == "banana":
        np.testing.assert_allclose(x[:, 0].std(), 1.0, atol=0.03)
        np.testing.assert_allclose((x[:, 1] - 0.25 * x[:, 0] ** 2 + 2.0).std(), 0.5, atol=0.02)
    elif source == "gaussian":
        np.testing.assert_allclose(x.std(0), [1.0, 1.0], atol=0.03)
    else:
        np.testing.assert_allclose(np.abs(x).mean(0), [1.0, 1.0], atol=0.03)


def test_train_and_roundtrip():
    model, history = toy.train(toy.Config(**CFG), steps=30, batch_size=128, device="cpu")
    assert history and all(np.isfinite(r) and np.isfinite(d) for _, r, d in history)
    x = toy.banana(torch.Generator().manual_seed(5), 64)
    x_hat, strings = toy.compress_samples(model, x)
    assert x_hat.shape == x.shape and len(strings) == 64
    assert sum(len(s) for s in strings) > 0


def test_ecvq_improves_and_compares():
    lam = 3.0
    q0 = toy.train_ecvq(toy.banana, lam, num_codewords=32, steps=0, batch_size=512, device="cpu")
    q = toy.train_ecvq(toy.banana, lam, num_codewords=32, steps=40, batch_size=512, device="cpu")
    x = toy.banana(torch.Generator().manual_seed(9), 4096)
    r0, d0 = q0.rate_distortion(x)
    r1, d1 = q.rate_distortion(x)
    assert float(r1) + lam * float(d1) < float(r0) + lam * float(d0)
    np.testing.assert_allclose(float(torch.exp2(q.log2_p).sum()), 1.0, rtol=1e-5)
    rows = toy.compare_ntc_vq(toy.banana, lambdas=(3.0,), ntc_steps=30, vq_steps=20,
                              num_codewords=32, device="cpu")
    assert {m for m, *_ in rows} == {"ntc", "ecvq"}
    assert all(r > 0 and d >= 0 for _, _, r, d in rows)


def test_rd_points_and_csv(tmp_path):
    r, d = toy.rd_point_ntc(toy.Config(**CFG), toy.banana, steps=20, eval_n=2048, device="cpu")
    assert r > 0 and np.isfinite(d)
    r, d = toy.rd_point_ecvq(toy.gaussian, 1.0, num_codewords=16, steps=5, eval_n=2048, device="cpu")
    assert r > 0 and d > 0
    path = tmp_path / "out" / "rd.csv"
    toy.compare_ntc_vq(toy.laplacian, lambdas=(1.0,), csv_path=str(path), ntc_steps=5,
                       vq_steps=3, num_codewords=8, device="cpu")
    assert path.read_text().splitlines()[0] == "method,lambda,rate_bits_per_sample,mse_per_sample"


def test_entry_points_need_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        toy.train(toy.Config(**CFG), steps=1)
