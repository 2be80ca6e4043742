"""The port's LPIPS against the JAX package's: synthetic torch-layout VGG16
and LPIPS-head weights written by ``tools/convert_lpips.py``, read by both
packages through ``TPC_LPIPS_WEIGHTS``; the distances, d(a, a) = 0, and the
gradient with respect to b; files the port refuses; the random fallback
without a weights file."""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compression_tpu.models.hific import lpips as jax_lpips
from compression_tpu_torch import convert
from compression_tpu_torch.models.hific import lpips

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))  # for tools/

from tools.convert_lpips import TORCH_CONV_IDX, convert_from_state_dicts, write_params  # noqa: E402

torch.set_num_threads(1)


def synthetic_states(seed=0):
    """Torch-layout VGG16 and LPIPS-head state dicts of the right shapes."""
    rng = np.random.RandomState(seed)
    vgg, cin = {}, 3
    for w, ti in zip([w for widths in jax_lpips._BLOCKS for w in widths], TORCH_CONV_IDX):
        vgg[f"features.{ti}.weight"] = rng.randn(w, cin, 3, 3).astype(np.float32) * 0.05
        vgg[f"features.{ti}.bias"] = rng.randn(w).astype(np.float32) * 0.01
        cin = w
    lins = {f"lin{i}.model.1.weight": np.abs(rng.randn(1, widths[-1], 1, 1)).astype(np.float32)
            for i, widths in enumerate(jax_lpips._BLOCKS)}
    return vgg, lins


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The converted file, and both packages' models read from it."""
    vgg, lins = synthetic_states()
    path = tmp_path_factory.mktemp("lpips") / "lpips_vgg16.msgpack"
    write_params(convert_from_state_dicts(vgg, lins), str(path))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPC_LPIPS_WEIGHTS", str(path))
        assert lpips.lpips_params_path() == str(path)
        jax_model, jax_params = jax_lpips.make_lpips(16)
        port = lpips.make_lpips()
    return path, (vgg, lins), (jax_model, jax_params), port


def test_both_packages_read_the_converted_weights(weights):
    """The port holds each torch-layout array under the name the tool maps
    it to (``features.N`` of the 13 convolutions in order ->
    ``vgg.conv{b}_{c}``, ``lin{i}.model.1`` -> ``lin{i}``), and the same
    tree as the JAX package."""
    path, (vgg, lins), (_, jax_params), port = weights
    state = port.state_dict()
    names = [f"vgg.conv{b}_{c}" for b, widths in enumerate(jax_lpips._BLOCKS)
             for c in range(len(widths))]
    assert len(names) == len(TORCH_CONV_IDX)
    for name, ti in zip(names, TORCH_CONV_IDX):
        for leaf in ("weight", "bias"):
            np.testing.assert_array_equal(state[f"{name}.{leaf}"].numpy(),
                                          vgg[f"features.{ti}.{leaf}"])
    np.testing.assert_array_equal(state["lin3"].numpy(), lins["lin3.model.1.weight"].reshape(-1))
    want = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_params))
    assert sorted(want) == sorted(state)
    for k, v in want.items():
        assert torch.equal(state[k], v), k
    assert not any(p.requires_grad for p in port.parameters())


def _distance_and_grad(jax_model, jax_params, port, a, b, dtype):
    """Both packages' distances and d(sum of distances)/db in ``dtype``."""

    def jax_fn(b, params, a):
        d = jax_model.apply(params, a, b)
        return jnp.sum(d), d

    cast = lambda v: jnp.asarray(v, dtype)  # noqa: E731
    (_, want), want_g = jax.jit(jax.value_and_grad(jax_fn, has_aux=True))(
        cast(b), jax.tree_util.tree_map(cast, jax_params), cast(a))
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    bt = torch.from_numpy(b.astype(dtype)).requires_grad_()
    got = port.to(tdtype)(torch.from_numpy(a.astype(dtype)), bt)
    got.sum().backward()
    port.to(torch.float32)
    return (got.detach().numpy(), bt.grad.numpy()), (np.asarray(want), np.asarray(want_g))


def _pair(hw, seed=1):
    rng = np.random.RandomState(seed)
    a = rng.rand(2, *hw, 3).astype(np.float32)
    return a, np.clip(a + 0.2 * rng.randn(*a.shape), 0, 1).astype(np.float32)


def test_same_function_as_jax_in_float64(weights):
    """In float64 both packages compute the same function: the distances
    and the gradient within 1e-10 (of the largest entry), at 24x20, where
    every pool floors an odd size (12x10 -> 6x5 -> 3x2 -> 1x1)."""
    _, _, (jax_model, jax_params), port = weights
    a, b = _pair((24, 20))
    (got, got_g), (want, want_g) = _distance_and_grad(
        jax_model, jax_params, port, a, b, np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-10)
    np.testing.assert_allclose(got_g, want_g, rtol=0, atol=1e-10 * np.abs(want_g).max())


@pytest.mark.parametrize("hw", [(64, 64), (48, 40)])
def test_distances_and_gradient_match_jax(weights, hw):
    """float32, the port's precision: (N,) distances within 1e-5 relative,
    d(a, a) = 0 in both packages, and d(sum of distances)/db within 1e-4 of
    its largest entry over taps 0-2 (heads 3 and 4 set to 0). With these
    synthetic weights the deep taps' features have norms in the hundreds to
    thousands, their normalized differences cancel, and each package's
    float32 gradient through taps 3-4 is ~1% off its own float64 one (the
    float64 test holds the whole function); at 48x40 the pools floor odd
    sizes (24x20 -> 12x10 -> 6x5 -> 3x2)."""
    _, _, (jax_model, jax_params), port = weights
    a, b = _pair(hw)
    (got, _), (want, _) = _distance_and_grad(jax_model, jax_params, port, a, b, np.float32)
    assert got.shape == (2,) and float(np.min(want)) > 1e-4
    np.testing.assert_allclose(got, want, rtol=1e-5)
    shallow = lpips.LPIPS()
    shallow.load_state_dict(port.state_dict())
    shallow_params = jax.tree_util.tree_map(lambda v: v, jax_params)
    for i in (3, 4):
        getattr(shallow, f"lin{i}").data.zero_()
        shallow_params["params"][f"lin{i}"] = jnp.zeros_like(jax_params["params"][f"lin{i}"])
    (_, got_g), (_, want_g) = _distance_and_grad(
        jax_model, shallow_params, shallow, a, b, np.float32)
    np.testing.assert_allclose(got_g, want_g, rtol=1e-4, atol=1e-4 * np.abs(want_g).max())
    same_jax = np.asarray(jax_model.apply(jax_params, jnp.asarray(a), jnp.asarray(a)))
    with torch.no_grad():
        same = port(torch.from_numpy(a), torch.from_numpy(a)).numpy()
    assert np.all(same == 0.0) and np.all(same_jax == 0.0)


def test_torch_layout_rejects_missing_weights(tmp_path, monkeypatch):
    """A converted file without one of the torch-layout weights, or with a
    head of the wrong width, is refused by the port's loader."""
    vgg, lins = synthetic_states()
    params = convert_from_state_dicts(vgg, lins)
    del params["params"]["vgg"]["conv4_2"]["kernel"]
    missing = tmp_path / "missing.msgpack"
    write_params(params, str(missing))
    monkeypatch.setenv("TPC_LPIPS_WEIGHTS", str(missing))
    with pytest.raises(RuntimeError, match="Missing key"):
        lpips.make_lpips()
    params = convert_from_state_dicts(vgg, lins)
    params["params"]["lin2"] = params["params"]["lin2"][:7]
    narrow = tmp_path / "narrow.msgpack"
    write_params(params, str(narrow))
    monkeypatch.setenv("TPC_LPIPS_WEIGHTS", str(narrow))
    with pytest.raises(RuntimeError, match="size mismatch"):
        lpips.make_lpips()


def test_random_fallback_without_weights(monkeypatch, capsys):
    """No file: flax's nn.Conv init drawn from a seed (lecun_normal kernels,
    zero biases), heads at 1/C, a warning; no parameter needs a gradient."""
    monkeypatch.delenv("TPC_LPIPS_WEIGHTS", raising=False)
    assert lpips.lpips_params_path() is None
    model = lpips.make_lpips()
    assert "no converted LPIPS weights" in capsys.readouterr().err
    state = model.state_dict()
    for k, v in lpips.make_lpips().state_dict().items():
        assert torch.equal(state[k], v), k
    w = state["vgg.conv3_1.weight"]
    assert abs(w.std().item() * np.sqrt(512 * 9) - 1.0) < 0.02
    assert torch.equal(state["vgg.conv3_1.bias"], torch.zeros(512))
    assert torch.equal(state["lin4"], torch.full((512,), 1 / 512))
    assert not any(p.requires_grad for p in model.parameters())
    x = torch.rand(1, 32, 32, 3)
    assert model(x, x).item() == 0.0
