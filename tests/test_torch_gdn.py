"""The port's fused GDN (K1's plain twin and the GDN module) against the JAX
package: the Pallas kernel in interpret mode, the lax GDN path and the flax
module. The CUDA kernel itself runs only on the card
(tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compression_tpu.layers import GDN as JaxGDN
from compression_tpu.layers.pallas.gdn_kernel import fused_gdn as jax_fused_gdn
from compression_tpu_torch.layers import GDN, fused_gdn, fused_gdn_reference
from compression_tpu_torch.layers import gdn_kernel, parameters

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_pallas_gdn.py's tolerance


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
