"""The port's fused GDN (K1's plain twin and the GDN module) against the JAX
package: the Pallas kernel in interpret mode, the lax GDN path and the flax
module; K1's autograd Function (forward by the twin here, backward in plain
ops) against gradcheck and jax.grad. The CUDA kernel itself runs only on
the card (tests/test_torch_cuda.py); its 3xTF32 arithmetic is emulated
here."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compression_tpu.layers import GDN as JaxGDN
from compression_tpu.layers.pallas.gdn_kernel import fused_gdn as jax_fused_gdn
from compression_tpu_torch import convert
from compression_tpu_torch.layers import GDN, fused_gdn, fused_gdn_reference
from compression_tpu_torch.layers import gdn_kernel, parameters
from compression_tpu_torch.layers.gdn_kernel import FusedGDN, gdn_autograd, pad_channels

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_pallas_gdn.py's tolerance
CKPT = pathlib.Path(__file__).resolve().parent.parent / "ckpt" / "bmshj2018.msgpack"


def _inputs(seed, shape, c):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape, c).astype(np.float32)
    beta = rng.uniform(0.5, 2.0, c).astype(np.float32)
    gamma = (rng.uniform(0, 0.1, (c, c)) + 0.05 * np.eye(c)).astype(np.float32)
    return x, beta, gamma


# Ragged row counts: 126, 256 and 75 rows against 512-row Pallas tiles and
# 64-row CUDA tiles.
@pytest.mark.parametrize("shape", [(2, 7, 9), (1, 16, 16), (3, 5, 5)])
@pytest.mark.parametrize("c", [64, 128, 192])
@pytest.mark.parametrize("inverse", [False, True])
def test_twin_matches_pallas_interpret(shape, c, inverse):
    x, beta, gamma = _inputs(c + len(shape), shape, c)
    got = fused_gdn_reference(
        torch.from_numpy(x), torch.from_numpy(beta), torch.from_numpy(gamma),
        inverse,
    ).numpy()
    want_pallas = jax_fused_gdn(
        jnp.asarray(x), jnp.asarray(beta), jnp.asarray(gamma),
        inverse=inverse, interpret=True,
    )
    np.testing.assert_allclose(got, np.asarray(want_pallas), **TOL)


def test_wrapper_runs_twin_on_cpu_without_counting():
    x, beta, gamma = _inputs(3, (2, 4, 4), 64)
    args = (torch.from_numpy(x), torch.from_numpy(beta), torch.from_numpy(gamma))
    before = fused_gdn.launches
    np.testing.assert_array_equal(
        fused_gdn(*args, inverse=True).numpy(),
        fused_gdn_reference(*args, inverse=True).numpy(),
    )
    assert fused_gdn.launches == before


@pytest.mark.parametrize("c,ok", [(192, True), (64, True), (32, True),
                                  (48, False), (224, False), (256, False)])
def test_supported_channels(c, ok):
    assert gdn_kernel.supported_channels(c) == ok


@pytest.mark.parametrize("c", [32, 64, 128, 192])
@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_module_matches_flax_lax_path(c, inverse):
    """The port's GDN (K1's twin on the CPU) against the flax GDN module's
    lax path, from the same raw (sqrt-space) parameters."""
    rng = np.random.RandomState(11 + inverse + c)
    x = rng.randn(2, 7, 5, c).astype(np.float32)  # 70 rows: ragged
    flax_mod = JaxGDN(inverse=inverse)
    # Raw parameters off their init, a few below the beta_min bound, so the
    # reparameterization is exercised.
    beta_raw = rng.uniform(-0.2, 1.5, c).astype(np.float32)
    gamma_raw = rng.uniform(-0.1, 0.4 / np.sqrt(c), (c, c)).astype(np.float32)
    params = {"params": {"beta": jnp.asarray(beta_raw),
                         "gamma": jnp.asarray(gamma_raw)}}
    want = flax_mod.apply(params, jnp.asarray(x))
    mod = GDN(c, inverse=inverse)
    mod.load_state_dict({"beta": torch.from_numpy(beta_raw),
                         "gamma": torch.from_numpy(gamma_raw)})
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("c", [8, 16, 40])
@pytest.mark.parametrize("inverse", [False, True])
def test_padded_width_gives_the_twin_at_any_width(c, inverse):
    """K1 runs C that is not a multiple of 32 at the width pad_channels
    gives (x's new columns 0, beta's 1, gamma's new rows and columns 0):
    the twin at that width, cut back to C, is the twin at C (the padded
    products add exact zeros), and the new channels come out 0. Against
    the Pallas kernel (interpret mode) too, at the kernel tolerance."""
    x, beta, gamma = (torch.from_numpy(a) for a in _inputs(c, (2, 7, 9), c))
    xp, bp, gp = pad_channels(x, beta, gamma)
    width = -(-c // 32) * 32
    assert xp.shape == (2, 7, 9, width) and bp.shape == (width,)
    assert gp.shape == (width, width) and xp.is_contiguous()
    assert torch.equal(xp[..., :c], x) and not xp[..., c:].any()
    assert torch.equal(bp[c:], torch.ones(width - c)) and not gp[c:].any()
    assert not gp[:, c:].any()
    padded = fused_gdn_reference(xp, bp, gp, inverse)
    want = fused_gdn_reference(x, beta, gamma, inverse)
    torch.testing.assert_close(padded[..., :c], want, rtol=1e-6, atol=1e-7)
    assert not padded[..., c:].any()
    pallas = jax_fused_gdn(jnp.asarray(x.numpy()), jnp.asarray(beta.numpy()),
                           jnp.asarray(gamma.numpy()), inverse=inverse, interpret=True)
    np.testing.assert_allclose(padded[..., :c].numpy(), np.asarray(pallas), **TOL)
    assert pad_channels(xp, bp, gp)[0] is xp  # already a multiple of 32


@pytest.mark.parametrize("c", [8, 16, 40])
@pytest.mark.parametrize("inverse", [False, True])
def test_function_gradients_at_any_width(c, inverse):
    """FusedGDN at C = 8, 16, 40 (on the CPU its forward is the twin):
    gradients equal autograd through the padded path cut back to C, which
    is what the card computes, and autograd through the twin at C."""
    x, beta, gamma = (torch.from_numpy(a) for a in _inputs(c + 1, (3, 5, 6), c))
    gy = torch.from_numpy(np.random.RandomState(c).randn(3, 5, 6, c).astype(np.float32))

    def padded(x, beta, gamma, inverse):
        return fused_gdn_reference(*pad_channels(x, beta, gamma), inverse)[..., :c]

    grads = []
    for fn in (lambda *a: FusedGDN.apply(*a, inverse), lambda *a: padded(*a, inverse),
               lambda *a: fused_gdn_reference(*a, inverse)):
        leaves = [t.clone().requires_grad_() for t in (x, beta, gamma)]
        fn(*leaves).backward(gy)
        grads.append([t.grad for t in leaves])
    for other in grads[1:]:
        for got, want in zip(grads[0], other):
            torch.testing.assert_close(got, want, rtol=1e-5,
                                       atol=1e-5 * want.abs().max().item())


def test_nonneg_apply_is_bit_equal():
    from compression_tpu.layers import parameters as jax_parameters

    raw = np.random.RandomState(5).uniform(-0.5, 1.5, 257).astype(np.float32)
    for minimum in (0.0, 1e-6):
        want = np.asarray(jax_parameters.nonneg_apply(jnp.asarray(raw), minimum))
        got = parameters.nonneg_apply(torch.from_numpy(raw), minimum).numpy()
        np.testing.assert_array_equal(got, want)


def test_plain_exponents_take_torch_ops():
    x = torch.from_numpy(np.random.RandomState(2).randn(3, 4, 16).astype(np.float32))
    mod = GDN(16, alpha=1.0, epsilon=1.0)
    with torch.no_grad():
        got = mod(x)
        beta = parameters.nonneg_apply(mod.beta, 1e-6)
        gamma = parameters.nonneg_apply(mod.gamma, 0.0)
        want = x / (torch.abs(x) @ gamma + beta)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# -- K1 under autograd --------------------------------------------------------


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape", [(2, 3, 5), (7,)])
def test_function_gradcheck_float64(shape, inverse):
    """The Function's backward (plain ops) against finite differences of its
    forward, in float64, for x, beta and gamma."""
    rng = np.random.RandomState(len(shape) + 3 * inverse)
    c = 6
    x = torch.from_numpy(rng.randn(*shape, c)).requires_grad_()
    beta = torch.from_numpy(rng.uniform(0.5, 2.0, c)).requires_grad_()
    gamma = torch.from_numpy(rng.uniform(0, 0.1, (c, c)) + 0.05 * np.eye(c))
    gamma.requires_grad_()
    assert torch.autograd.gradcheck(
        lambda *a: FusedGDN.apply(*a, inverse), (x, beta, gamma))


@pytest.mark.parametrize("c", [32, 192])
@pytest.mark.parametrize("inverse", [False, True])
def test_module_gradients_match_jax_grad(c, inverse):
    """Gradients of a scalar of the port's GDN (through the Function and
    the sqrt reparameterization) against jax.grad of the flax GDN's lax
    path, for x and the raw beta and gamma, in float32. Tolerance: 1e-4
    relative to each gradient's largest entry (fp32 sums of C terms in
    another order)."""
    rng = np.random.RandomState(c + inverse)
    x = rng.randn(2, 5, 7, c).astype(np.float32)
    w = rng.randn(2, 5, 7, c).astype(np.float32)
    beta_raw = rng.uniform(0.3, 1.5, c).astype(np.float32)
    gamma_raw = rng.uniform(0.0, 0.4 / np.sqrt(c), (c, c)).astype(np.float32)
    flax_mod = JaxGDN(inverse=inverse)

    def jax_loss(params, x):
        return jnp.sum(flax_mod.apply(params, x) * w)

    params = {"params": {"beta": jnp.asarray(beta_raw), "gamma": jnp.asarray(gamma_raw)}}
    g_params, g_x = jax.grad(jax_loss, argnums=(0, 1))(params, jnp.asarray(x))
    mod = GDN(c, inverse=inverse)
    mod.load_state_dict({"beta": torch.from_numpy(beta_raw),
                         "gamma": torch.from_numpy(gamma_raw)})
    xt = torch.from_numpy(x).requires_grad_()
    torch.sum(mod(xt) * torch.from_numpy(w)).backward()
    for got, want in ((xt.grad, g_x), (mod.beta.grad, g_params["params"]["beta"]),
                      (mod.gamma.grad, g_params["params"]["gamma"])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


def test_function_takes_channels_last_views_and_counts_nothing_on_cpu():
    """A channels_last NCHW tensor seen as NHWC (what SignalConv2D hands
    GDN) goes through the Function; gradients equal autograd through the
    twin, and the CPU run launches no kernel."""
    gen = torch.Generator().manual_seed(0)
    xc = torch.randn(2, 16, 6, 5, generator=gen).to(memory_format=torch.channels_last)
    beta = torch.rand(16, generator=gen) + 0.5
    gamma = torch.rand(16, 16, generator=gen) * 0.1
    before = fused_gdn.launches
    grads = []
    for fn in (gdn_autograd, fused_gdn_reference):
        x = xc.permute(0, 2, 3, 1).detach().requires_grad_()
        b, g = beta.clone().requires_grad_(), gamma.clone().requires_grad_()
        (fn(x, b, g, True) ** 2).sum().backward()
        grads.append((x.grad, b.grad, g.grad))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert fused_gdn.launches == before


# -- K1's arithmetic on the card: 3xTF32 ------------------------------------


def _tf32(a):
    """cvt.rna.tf32.f32: round to the nearest TF32 value (10 fraction bits),
    ties away from zero, by masking the low 13 bits."""
    return ((a.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_gdn(x, beta, gamma, inverse, products):
    """(x*x) @ gamma as the tensor cores take it: 3 products (hi and lo
    parts, lo*hi + hi*lo summed first, then hi*hi) or 1 (hi*hi), each
    product exact and every sum in fp32."""
    sq = x * x
    a_hi, b_hi = _tf32(sq), _tf32(gamma)
    norm = a_hi @ b_hi
    if products == 3:
        a_lo, b_lo = _tf32(sq - a_hi), _tf32(gamma - b_hi)
        norm = (a_lo @ b_hi + a_hi @ b_lo) + norm
    norm = norm + beta
    return x * (torch.sqrt(norm) if inverse else torch.rsqrt(norm))


@pytest.fixture(scope="module")
def ckpt_gdn_params():
    return convert.load_flax_msgpack(CKPT)["params"]["params"]


@pytest.mark.parametrize("products", [3, 1])
@pytest.mark.parametrize("layer", ["analysis/gdn0", "analysis/gdn1", "analysis/gdn2",
                                   "synthesis/igdn0", "synthesis/igdn1", "synthesis/igdn2"])
def test_tf32_split_against_pallas_on_checkpoint(ckpt_gdn_params, layer, products):
    """With the checkpoint's effective beta and gamma (C = 192) and x spread
    over 1e-3..1e3, 3xTF32 stays within the kernel tolerance of the Pallas
    kernel; 1xTF32 (11 bits) misses it, which is why K1 splits."""
    transform, name = layer.split("/")
    raw = ckpt_gdn_params[transform][name]
    inverse = name.startswith("i")
    beta = parameters.nonneg_apply(torch.from_numpy(np.asarray(raw["beta"])), 1e-6)
    gamma = parameters.nonneg_apply(torch.from_numpy(np.asarray(raw["gamma"])), 0.0)
    rng = np.random.RandomState(sum(map(ord, layer)))
    x = (rng.choice([-1.0, 1.0], (512, 192))
         * 10.0 ** rng.uniform(-3, 3, (512, 192))).astype(np.float32)
    want = np.asarray(jax_fused_gdn(
        jnp.asarray(x), jnp.asarray(beta.numpy()), jnp.asarray(gamma.numpy()),
        inverse=inverse, interpret=True))
    got = _tf32_gdn(torch.from_numpy(x), beta, gamma, inverse, products).numpy()
    if products == 3:
        np.testing.assert_allclose(got, want, **TOL)
    else:
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(got, want, **TOL)


def test_tf32_rounding_is_cvt_rna():
    vals = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, 1.0 + 3 * 2.0 ** -12,
                         -(1.0 + 2.0 ** -11), 3.0e-30])
    got = _tf32(vals)
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0, 1.0 + 2.0 ** -10,
                         -(1.0 + 2.0 ** -10), 3.0e-30])
    assert torch.equal(got[:5], want[:5])
    assert (got[5].view(torch.int32) & 0x1FFF) == 0
