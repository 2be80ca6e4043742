"""The port's training-side ops against the JAX package's, on the same
seeded NumPy inputs: round_st and the soft-round family, the entropy
models' training calls (values, bits and gradients), and the image
metrics and distortion terms (PSNR, SSIM, MS-SSIM)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compression_tpu.distributions.deep_factorized import DeepFactorized as JaxDeepFactorized
from compression_tpu.distributions.uniform_noise import NoisyNormal as JaxNoisyNormal
from compression_tpu.distributions.uniform_noise import UniformNoiseAdapter as JaxNoisyAdapter
from compression_tpu.entropy_models import ContinuousBatchedEntropyModel as JaxBatched
from compression_tpu.entropy_models import LocationScaleIndexedEntropyModel as JaxIndexed
from compression_tpu.models import common as jax_common
from compression_tpu.ops import round_ops as jax_round
from compression_tpu.util import image as jax_image
from compression_tpu_torch.distributions.uniform_noise import NoisyNormal
from compression_tpu_torch.entropy_models import (
    ContinuousBatchedEntropyModel,
    LocationScaleIndexedEntropyModel,
)
from compression_tpu_torch.entropy_models import continuous_batched, continuous_indexed
from compression_tpu_torch.layers.priors import DeepFactorizedPrior
from compression_tpu_torch.models import common
from compression_tpu_torch.ops import round_ops
from compression_tpu_torch.util import image

torch.set_num_threads(1)


def _grad(fn, *arrays):
    """Value and gradients of sum(fn(*tensors)) in torch."""
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*ts)
    out.sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _jax_grad(fn, *arrays):
    out = fn(*[jnp.asarray(a) for a in arrays])
    grads = jax.grad(lambda *a: jnp.sum(fn(*a)), argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    return np.asarray(out), [np.asarray(g) for g in grads]


# -- rounding -------------------------------------------------------------------


@pytest.mark.parametrize("with_offset", [False, True])
def test_round_st_matches_jax(with_offset):
    """Forward a round (half to even, ties included), gradient the identity."""
    rng = np.random.RandomState(1)
    x = (rng.randn(5, 7) * 4).astype(np.float32)
    x[0, :4] = [0.5, 1.5, -2.5, 2.5]
    off = rng.uniform(-0.5, 0.5, 7).astype(np.float32) if with_offset else None
    got, (gx,) = _grad(lambda t: round_ops.round_st(
        t, None if off is None else torch.from_numpy(off)) * 3.0, x)
    want, (wx,) = _jax_grad(lambda t: jax_round.round_st(
        t, None if off is None else jnp.asarray(off)) * 3.0, x)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gx, wx)
    np.testing.assert_array_equal(gx, np.full_like(x, 3.0))


@pytest.mark.parametrize("fn", ["soft_round", "soft_round_inverse",
                                "soft_round_conditional_mean"])
@pytest.mark.parametrize("alpha", [0.0, 5e-4, 1.0, 7.5, 40.0])
def test_soft_round_family_matches_jax(fn, alpha):
    """Values and d/dx against the JAX functions, in float64 (below
    _ALPHA_EPS the identity; large alpha saturates the tanh guard).
    Tolerance 1e-10 relative: the same float64 formula."""
    rng = np.random.RandomState(int(alpha * 10) + len(fn))
    x = (rng.randn(64) * 3).astype(np.float64)
    x[:3] = [0.5, -1.5, 2.0]
    got, (gx,) = _grad(lambda t: getattr(round_ops, fn)(t, alpha), x)
    want, (wx,) = _jax_grad(lambda t: getattr(jax_round, fn)(t, alpha), x)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    # Where the inverse lands on its interval's edge (y = m -+ 1/2), r sits on
    # the clip at -+1/2 up to the last bit of atanh(tanh(.)), and which side
    # it falls decides whether the (steep) derivative passes: compare values
    # only there.
    edge = {"soft_round": np.zeros_like(x, bool),
            "soft_round_inverse": x % 1 == 0,
            "soft_round_conditional_mean": (x - 0.5) % 1 == 0}[fn]
    np.testing.assert_allclose(gx[~edge], wx[~edge], rtol=1e-8, atol=1e-10)


# -- entropy models: training calls ---------------------------------------------


def _prior_params(seed, channels=4):
    """DeepFactorized parameters off their init, as NumPy float32."""
    prior = DeepFactorizedPrior((channels,), generator=torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    out = []
    for field, spread in ((prior.matrices, 0.3), (prior.biases, 1.0), (prior.factors, 0.5)):
        out.append([(p.detach().numpy() + spread * rng.randn(*p.shape)).astype(np.float32)
                    for p in field])
    return out


def _port_prior(params):
    prior = DeepFactorizedPrior((params[0][0].shape[0],))
    tensors = [[torch.from_numpy(a).requires_grad_() for a in field] for field in params]
    for dst, src in zip((prior.matrices, prior.biases, prior.factors), tensors):
        for i, t in enumerate(src):
            dst[i] = torch.nn.Parameter(t)
    return prior


def _flat(fields):
    return [a for field in fields for a in field]


@pytest.mark.parametrize("laplace_tail_mass", [0.0, 1e-3])
def test_batched_model_quantized_matches_jax(laplace_tail_mass):
    """training=False: y_tilde on the prior's offset grid, bits per image,
    and gradients for y and every prior parameter (second derivatives of
    the CDF: the port's closed-form density against jax.jvp). Tolerance:
    bits 1e-5 relative, gradients 1e-4 of each one's largest entry."""
    params = _prior_params(3)
    rng = np.random.RandomState(7)
    y = (rng.randn(2, 3, 5, 4) * 3).astype(np.float32)
    w_y = rng.randn(*y.shape).astype(np.float32)

    def jax_fn(y, *flat):
        n = len(params[0])
        df = JaxDeepFactorized(tuple(flat[:n]), tuple(flat[n:2 * n]), tuple(flat[2 * n:]))
        em = JaxBatched(JaxNoisyAdapter(df), coding_rank=3,
                        laplace_tail_mass=laplace_tail_mass)
        y_tilde, bits = em(y, training=False)
        return jnp.sum(bits) + jnp.sum(y_tilde * w_y), (y_tilde, bits)

    flat = [jnp.asarray(a) for a in _flat(params)]
    (_, (want_yt, want_bits)), grads = jax.value_and_grad(
        jax_fn, argnums=tuple(range(1 + len(flat))), has_aux=True)(jnp.asarray(y), *flat)

    prior = _port_prior(params)
    yt = torch.from_numpy(y).requires_grad_()
    em = ContinuousBatchedEntropyModel(prior(), coding_rank=3,
                                       laplace_tail_mass=laplace_tail_mass)
    y_tilde, bits = em(yt, training=False)
    (bits.sum() + (y_tilde * torch.from_numpy(w_y)).sum()).backward()
    # The offsets come from each package's float32 root-find, which differ
    # in the last bits (XLA's transcendentals; ROADMAP section 3): y_tilde to
    # 1e-6, the integer grid points equal.
    np.testing.assert_allclose(y_tilde.detach().numpy(), np.asarray(want_yt), atol=1e-6)
    np.testing.assert_allclose(bits.detach().numpy(), np.asarray(want_bits), rtol=1e-5)
    got = [yt.grad] + [p.grad for p in (*prior.matrices, *prior.biases, *prior.factors)]
    for g, w in zip(got, grads):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max())


def test_indexed_model_quantized_matches_jax():
    """training=False of the scale-indexed model: y_tilde = round(y), bits
    per image, and gradients for y and the scale, with scales below
    SCALES_MIN and above SCALES_MAX so the identity-if-towards bounds act.
    Tolerance: bits 1e-5 relative; gradients 1e-3 relative and 1e-4 of the
    largest entry: at |y| / scale up to ~100 both differentiate log_ndtr
    deep in its tail, where XLA's and torch's float32 formulas differ by up
    to 5e-4 relative."""
    rng = np.random.RandomState(11)
    y = (rng.randn(2, 4, 3, 6) * 4).astype(np.float32)
    scale = np.exp(rng.uniform(np.log(0.03), np.log(400.0), y.shape)).astype(np.float32)
    w_y = rng.randn(*y.shape).astype(np.float32)

    def jax_fn(y, scale):
        y_tilde, bits = JaxIndexed(JaxNoisyNormal, coding_rank=3)(y, scale, training=False)
        return jnp.sum(bits) + jnp.sum(y_tilde * w_y), (y_tilde, bits)

    (_, (want_yt, want_bits)), (gy, gs) = jax.value_and_grad(
        jax_fn, argnums=(0, 1), has_aux=True)(jnp.asarray(y), jnp.asarray(scale))
    yt, st = (torch.from_numpy(a).requires_grad_() for a in (y, scale))
    em = LocationScaleIndexedEntropyModel(NoisyNormal, coding_rank=3)
    y_tilde, bits = em(yt, st, training=False)
    (bits.sum() + (y_tilde * torch.from_numpy(w_y)).sum()).backward()
    np.testing.assert_array_equal(y_tilde.detach().numpy(), np.asarray(want_yt))
    np.testing.assert_allclose(bits.detach().numpy(), np.asarray(want_bits), rtol=1e-5)
    for g, w in ((yt.grad, gy), (st.grad, gs)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3, atol=1e-4 * np.abs(w).max())
    np.testing.assert_array_equal(em.quantize(yt).detach().numpy(), np.round(y))


def test_bits_on_jax_noisy_y_tilde(monkeypatch):
    """training=True: the JAX models' own noise (y_tilde - y) fed to the
    port's training calls gives the same y_tilde and bits (1e-5 relative)."""
    params = _prior_params(5)
    rng = np.random.RandomState(2)
    z = (rng.randn(2, 2, 3, 4) * 2).astype(np.float32)
    y = (rng.randn(2, 4, 6, 4) * 3).astype(np.float32)
    scale = np.exp(rng.uniform(np.log(0.11), np.log(50.0), y.shape)).astype(np.float32)
    df = JaxDeepFactorized(*(tuple(jnp.asarray(a) for a in f) for f in params))
    jz, jz_bits = JaxBatched(JaxNoisyAdapter(df), coding_rank=3)(
        jnp.asarray(z), rng=jax.random.PRNGKey(0), training=True)
    jy, jy_bits = JaxIndexed(JaxNoisyNormal, coding_rank=3)(
        jnp.asarray(y), jnp.asarray(scale), rng=jax.random.PRNGKey(1), training=True)
    for module, want in ((continuous_batched, jz), (continuous_indexed, jy)):
        monkeypatch.setattr(
            module, "uniform_noise",
            lambda t, gen, want=want: torch.from_numpy(np.asarray(want) - t.detach().numpy()))
    prior = _port_prior(params)
    gen = torch.Generator().manual_seed(0)
    pz, pz_bits = ContinuousBatchedEntropyModel(prior(), coding_rank=3)(torch.from_numpy(z), gen)
    py, py_bits = LocationScaleIndexedEntropyModel(NoisyNormal, coding_rank=3)(
        torch.from_numpy(y), torch.from_numpy(scale), generator=gen)
    for got, want in ((pz, jz), (pz_bits, jz_bits), (py, jy), (py_bits, jy_bits)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_port_noise_is_uniform_half_and_seeded():
    em = LocationScaleIndexedEntropyModel(NoisyNormal, coding_rank=1)
    y = torch.zeros(200_000)
    scale = torch.ones(200_000)
    a, _ = em(y, scale, generator=torch.Generator().manual_seed(4))
    b, _ = em(y, scale, generator=torch.Generator().manual_seed(4))
    c, _ = em(y, scale, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.min() >= -0.5 and a.max() < 0.5
    assert abs(a.mean().item()) < 0.005          # 4.5 standard errors
    assert abs(a.var().item() - 1 / 12) < 0.001  # U(-1/2, 1/2) variance
    with pytest.raises(ValueError, match="generator"):
        em(y, scale)


# -- image metrics ----------------------------------------------------------------


def _images(seed, shape):
    rng = np.random.RandomState(seed)
    a = rng.rand(*shape).astype(np.float32)
    b = np.clip(a + 0.15 * rng.randn(*shape), 0, 1).astype(np.float32)
    return a, b


def test_psnr_matches_jax():
    a, b = _images(0, (3, 17, 19, 3))
    got = image.psnr(torch.from_numpy(a * 255), torch.from_numpy(b * 255)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_image.psnr(a * 255, b * 255)), rtol=1e-6)


@pytest.mark.parametrize("shape", [(2, 40, 37, 3), (33, 48, 1)])
def test_ssim_values_and_gradients_match_jax(shape):
    """Odd sizes and an unbatched input; max_val 1. Tolerance: values
    1e-5, gradients 1e-4 of the largest entry (fp32 window sums)."""
    a, b = _images(1, shape)
    got, (ga, gb) = _grad(lambda x, y: image.ssim(x, y, max_val=1.0), a, b)
    want, (wa, wb) = _jax_grad(lambda x, y: jax_image.ssim(x, y, max_val=1.0), a, b)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    for g, w in ((ga, wa), (gb, wb)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("hw", [(176, 176), (181, 190)])
def test_msssim_values_and_gradients_match_jax(hw):
    """Five scales; at 181x190 the count-normalised pool averages partial
    edge windows at every level."""
    a, b = _images(2, (2, *hw, 3))
    got, (ga, gb) = _grad(lambda x, y: image.msssim(x, y, max_val=1.0), a, b)
    want, (wa, wb) = _jax_grad(lambda x, y: jax_image.msssim(x, y, max_val=1.0), a, b)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    for g, w in ((ga, wa), (gb, wb)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max())
    with pytest.raises(ValueError, match="176"):
        image.msssim(torch.zeros(1, 175, 200, 3), torch.zeros(1, 175, 200, 3))


def test_avg_pool_is_count_normalised_at_odd_sizes():
    x = np.random.RandomState(3).rand(2, 7, 5, 3).astype(np.float32)
    got = image._avg_pool2(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_image._avg_pool2(jnp.asarray(x))), rtol=1e-6)
    np.testing.assert_allclose(got[:, -1, -1], x[:, 6, 4], rtol=1e-6)  # a 1-pixel window


def test_weighted_term_derivative_is_bounded_at_zero():
    """max(v, 0)^w exactly; its derivative taken at max(v, 1e-2), as the
    JAX custom_jvp does: finite at v = 0 and below."""
    v = np.array([-0.1, 0.0, 1e-6, 0.004, 0.02, 0.5, 1.0], np.float32)
    for w in (0.0448, 0.1333, 0.3001):
        got, (g,) = _grad(lambda t: image._WeightedTerm.apply(t, w), v)
        want, (wg,) = _jax_grad(lambda t: jax_image._weighted_term(t, w), v)
        np.testing.assert_allclose(got, want, rtol=1e-6)  # float32 pow, 1 ulp
        np.testing.assert_allclose(g, wg, rtol=1e-6)
        assert np.isfinite(g).all() and g[1] == pytest.approx(w * 1e-2 ** (w - 1), rel=1e-5)


@pytest.mark.parametrize("kind,hw", [("mse", (64, 64)), ("msssim", (64, 64)),
                                     ("msssim", (176, 180))])
def test_distortion_loss_matches_jax(kind, hw):
    """The loss term, its metric and d/dx_hat, with x_hat partly outside
    [0, 1] and partly on its edges (MS-SSIM clips it); SSIM below 176 px,
    MS-SSIM from 176 up."""
    x, x_hat = _images(4, (2, *hw, 3))
    x_hat = x_hat * 1.2 - 0.1
    x_hat[:, :4, :4] = 0.0   # ties with the clip's bounds, where jnp.clip
    x_hat[:, 4:8, :4] = 1.0  # passes half the gradient
    xt, ht = torch.from_numpy(x), torch.from_numpy(x_hat).requires_grad_()
    loss, name, metric = common.distortion_loss(xt, ht, kind)
    loss.backward()

    def jax_loss(h):
        term, _, m = jax_common.distortion_loss(jnp.asarray(x), h, kind)
        return term, m

    (want, want_m), wg = jax.value_and_grad(jax_loss, has_aux=True)(jnp.asarray(x_hat))
    assert name == kind
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(metric.item(), float(want_m), rtol=1e-5)
    wg = np.asarray(wg)
    np.testing.assert_allclose(ht.grad.numpy(), wg, rtol=1e-4, atol=1e-4 * np.abs(wg).max())
    with pytest.raises(ValueError, match="unknown distortion"):
        common.distortion_loss(xt, ht, "l1")
