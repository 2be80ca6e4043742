"""GDN at any width and dtype: the port's GDN layer at C = 256 and 320 in
float32, in float64 and in bfloat16 against the JAX GDN layer (forward and
gradients), the route FusedGDN takes to K1 or the general kernel, and the
general kernel's input checks. On the CPU both kernels' wrappers run the
plain twin; the card tests are in tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compression_tpu.layers import GDN as JaxGDN
from compression_tpu_torch import convert
from compression_tpu_torch.layers import GDN, gdn_kernel
from compression_tpu_torch.layers.gdn_kernel import (
    FusedGDN,
    fused_gdn_general,
    fused_gdn_reference,
    routes_to_k1,
)

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_pallas_gdn.py's tolerance
TOL64 = dict(rtol=1e-12, atol=1e-12)
# bfloat16 keeps 8 significant bits. The JAX layer rounds x*x, the norm,
# the rsqrt and the product to bfloat16 one after another, the port's twin
# (as the kernels) rounds once at the end: outputs may differ by two bf16
# ulps of the JAX output. The backward runs in bfloat16 on both sides, its
# sums over rows in another order: gradients within four bf16 ulps (2^-5)
# of each one's largest entry.
BF16_ULPS = 2
BF16_GRAD_TOL = 2.0 ** -5


def _case(c, inverse, dtype=np.float32):
    """x and the cotangent w in ``dtype``; the raw parameters float32, as a
    checkpoint holds them (the layer casts them to its ``dtype``)."""
    rng = np.random.RandomState(c + inverse)
    x = rng.randn(2, 5, 7, c).astype(dtype)
    w = rng.randn(2, 5, 7, c).astype(dtype)
    beta_raw = rng.uniform(0.3, 1.5, c).astype(np.float32)
    gamma_raw = rng.uniform(0.0, 0.4 / np.sqrt(c), (c, c)).astype(np.float32)
    return x, w, beta_raw, gamma_raw


def _jax(x, w, beta_raw, gamma_raw, inverse, dtype):
    """The JAX layer's output and the gradients of sum(y * w) for x and the
    raw beta and gamma."""
    flax_mod = JaxGDN(inverse=inverse, dtype=dtype)

    def loss(params, x):
        y = flax_mod.apply(params, x)
        return jnp.sum(y.astype(w.dtype) * w), y

    params = {"params": {"beta": jnp.asarray(beta_raw), "gamma": jnp.asarray(gamma_raw)}}
    (_, y), (g_params, g_x) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    return (np.asarray(y.astype(w.dtype)), np.asarray(g_x),
            np.asarray(g_params["params"]["beta"]), np.asarray(g_params["params"]["gamma"]))


def _port(x, w, beta_raw, gamma_raw, inverse, dtype):
    """The port's layer, its raw parameters through the weight bridge."""
    mod = GDN(x.shape[-1], inverse=inverse, dtype=dtype)
    mod.load_state_dict(convert.params_from_numpy({"beta": beta_raw, "gamma": gamma_raw}))
    xt = torch.from_numpy(x).requires_grad_()
    y = mod(xt)
    torch.sum(y.to(xt.dtype) * torch.from_numpy(w)).backward()
    return y, xt.grad.numpy(), mod.beta.grad.numpy(), mod.gamma.grad.numpy()


@pytest.mark.parametrize("c", [256, 320])
@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_matches_jax_float32(c, inverse):
    case = _case(c, inverse)
    want = _jax(*case, inverse, None)
    y, *grads = _port(*case, inverse, None)
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.detach().numpy(), want[0], **TOL)
    for got, ref in zip(grads, want[1:]):
        np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("c", [256, 320])
@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_matches_jax_float64(c, inverse):
    case = _case(c, inverse, np.float64)
    want = _jax(*case, inverse, jnp.float64)
    y, *grads = _port(*case, inverse, torch.float64)
    assert y.dtype == torch.float64
    np.testing.assert_allclose(y.detach().numpy(), want[0], **TOL64)
    # dx is float64; the raw parameters' gradients come back float32 on both
    # sides, cast from the same float64 values.
    for got, ref in zip(grads, want[1:]):
        assert got.dtype == ref.dtype
        np.testing.assert_allclose(got, ref, **TOL64)


@pytest.mark.parametrize("c", [256, 320])
@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_matches_jax_bfloat16(c, inverse):
    case = _case(c, inverse)
    want = _jax(*case, inverse, jnp.bfloat16)
    y, *grads = _port(*case, inverse, torch.bfloat16)
    assert y.dtype == torch.bfloat16
    got = y.detach().float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want[0]), 2.0 ** -126))) - 7)
    assert np.max(np.abs(got - want[0]) / ulp) <= BF16_ULPS
    for got, ref in zip(grads, want[1:]):
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=BF16_GRAD_TOL * np.abs(ref).max())


@pytest.mark.parametrize("dtype,c,k1", [
    (torch.float32, 8, True), (torch.float32, 40, True), (torch.float32, 192, True),
    (torch.float32, 193, False), (torch.float32, 224, False), (torch.float32, 256, False),
    (torch.float32, 320, False), (torch.float64, 64, False), (torch.float64, 256, False),
    (torch.bfloat16, 192, False), (torch.float16, 128, False),
])
@pytest.mark.parametrize("inverse", [False, True])
def test_route_to_k1_or_the_general_kernel(monkeypatch, dtype, c, k1, inverse):
    """FusedGDN calls exactly one of the two wrappers, K1 for float32 at a
    width it takes (padded to a multiple of 32 up to 192), the general
    kernel for everything else, and never both."""
    x = torch.randn(3, c).to(dtype)
    beta = torch.ones(c, dtype=dtype)
    gamma = (0.1 * torch.eye(c)).to(dtype)
    assert routes_to_k1(x, beta, gamma) == k1
    called = []
    for name in ("fused_gdn", "fused_gdn_general"):
        real = getattr(gdn_kernel, name)
        monkeypatch.setattr(gdn_kernel, name,
                            lambda *a, name=name, real=real: called.append(name) or real(*a))
    y = FusedGDN.apply(x, beta, gamma, inverse)
    assert called == ["fused_gdn" if k1 else "fused_gdn_general"]
    assert y.dtype == dtype
    torch.testing.assert_close(y, fused_gdn_reference(x, beta, gamma, inverse), rtol=0, atol=0)


def test_route_needs_all_three_float32():
    x = torch.randn(3, 64)
    beta, gamma = torch.ones(64), torch.eye(64)
    assert routes_to_k1(x, beta, gamma)
    assert not routes_to_k1(x, beta.double(), gamma)
    assert not routes_to_k1(x, beta, gamma.bfloat16())


def test_general_wrapper_runs_the_twin_on_cpu_without_counting():
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(2, 3, 257)).to(torch.bfloat16)
    beta = torch.ones(257, dtype=torch.bfloat16)
    gamma = torch.from_numpy(rng.uniform(0, 0.01, (257, 257))).to(torch.bfloat16)
    before = fused_gdn_general.launches
    got = fused_gdn_general(x, beta, gamma, True)
    assert fused_gdn_general.launches == before
    assert torch.equal(got, fused_gdn_reference(x, beta, gamma, True))
    # The twin accumulates a low-precision norm in float32 and rounds once.
    xf, bf, gf = x.float(), beta.float(), gamma.float()
    assert torch.equal(got, (xf * torch.sqrt(torch.matmul(xf * xf, gf) + bf)).bfloat16())


def test_general_wrapper_checks_its_inputs():
    check = gdn_kernel._check_general_inputs
    x, beta, gamma = torch.randn(4, 300), torch.ones(300), torch.eye(300)
    assert check(x, beta, gamma) == 300
    assert check(x.double(), beta.double(), gamma.double()) == 300
    with pytest.raises(TypeError, match="unsupported dtype"):
        check(x.to(torch.int32), beta, gamma)
    with pytest.raises(TypeError, match="beta is torch.float64"):
        check(x, beta.double(), gamma)
    with pytest.raises(ValueError, match="contiguous"):
        check(x, beta, gamma.t())
    with pytest.raises(ValueError, match="do not match"):
        check(x, beta[:299].contiguous(), gamma)
    with pytest.raises(ValueError, match="C = 0"):
        check(torch.randn(4, 0), torch.ones(0), torch.eye(0))
    with pytest.raises(ValueError, match="unsupported device"):
        fused_gdn_general(x.to("meta"), beta.to("meta"), gamma.to("meta"))
