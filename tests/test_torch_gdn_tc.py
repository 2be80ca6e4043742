"""The general GDN kernel's arithmetic on the tensor cores (csrc/gdn.cu,
``fused_gdn_general``), emulated in torch on the CPU: the kernel itself runs
only on the card (tests/test_torch_cuda.py). Each route takes its products
as the kernel does, k in steps of its mma's depth into one accumulator:

* float32: x*x and gamma split into hi = tf32(v) and lo = tf32(v - hi);
  the mma.sync form (m16n8k8 tf32) adds lo*hi, hi*lo, then hi*hi into one
  accumulator each step (3xTF32); the TMA form (wgmma) adds lo*lo, lo*hi
  and hi*lo into one accumulator and hi*hi into another, summed at the
  end; each against the JAX Pallas kernel in interpret mode within its
  tolerance, 2e-5;
* float16 and bfloat16, one TF32 product: x squared in float (never in the
  16-bit type) and rounded to TF32, gamma exact in TF32; against the twin
  within two ulps of the output type, with float16 |x| up to 1,000, whose
  square overflows float16;
* float64, DMMA (m8n8k4): IEEE products in steps of 4; against the twin
  within 1e-12.

Inputs are made from a seed with numpy, x of magnitude spread
log-uniformly with random signs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compression_tpu.layers.pallas.gdn_kernel import fused_gdn as jax_fused_gdn
from compression_tpu_torch.layers import fused_gdn_reference

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_pallas_gdn.py's tolerance
BITS = {torch.bfloat16: 8, torch.float16: 11}  # significant bits of y's type


def _tf32(a):
    """cvt.rna.tf32.f32: round to the nearest TF32 value (10 fraction bits),
    ties away from zero, by masking the low 13 bits."""
    return ((a.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _scale(norm, inverse):
    """The kernel's epilogue: rsqrt, and IGDN as norm * rsqrt(norm) in
    float; rsqrt and sqrt in double."""
    if norm.dtype == torch.float64:
        return torch.sqrt(norm) if inverse else torch.rsqrt(norm)
    r = torch.rsqrt(norm)
    return norm * r if inverse else r


def _tensor_core_gdn(x, beta, gamma, inverse, square_in=None, tma=False):
    """The general kernel's arithmetic on (rows, C) tensors in their storage
    dtype: for float32 the mma.sync form's 3xTF32 or (``tma``) the TMA
    form's four products in two accumulators, one TF32 product for 16-bit
    types (x*x in ``square_in``, float unless given), DMMA for float64; y
    in x's dtype."""
    if x.dtype == torch.float64:
        xa, depth = x, 4
        sums = [[(x * x, gamma)]]
    else:
        xa, g, depth = x.float(), gamma.float(), 8
        sq = (x * x).float() if square_in is not None else xa * xa
        hi = _tf32(sq)
        if x.dtype == torch.float32:
            lo, g_hi = _tf32(sq - hi), _tf32(g)
            g_lo = _tf32(g - g_hi)
            sums = ([[(lo, g_lo), (lo, g_hi), (hi, g_lo)], [(hi, g_hi)]] if tma
                    else [[(lo, g_hi), (hi, g_lo), (hi, g_hi)]])
        else:
            sums = [[(hi, g)]]
    norms = [torch.zeros(x.shape, dtype=xa.dtype) for _ in sums]
    for k0 in range(0, x.shape[-1], depth):
        for i, products in enumerate(sums):
            for a, b in products:
                norms[i] = norms[i] + a[:, k0:k0 + depth] @ b[k0:k0 + depth]
    norm = (norms[-1] + norms[0] if len(norms) > 1 else norms[0]) + beta.to(xa.dtype)
    return (xa * _scale(norm, inverse)).to(x.dtype)


def _case(seed, rows, c, top=3.0, bottom=-3.0):
    """x of magnitude 10**uniform(bottom, top) with random signs; beta in
    [0.5, 2], gamma in [0, 0.1] plus 0.05 on the diagonal."""
    rng = np.random.RandomState(seed)
    x = rng.choice([-1.0, 1.0], (rows, c)) * 10.0 ** rng.uniform(bottom, top, (rows, c))
    beta = rng.uniform(0.5, 2.0, c)
    gamma = rng.uniform(0, 0.1, (c, c)) + 0.05 * np.eye(c)
    return x, beta, gamma


def _ulps(got, want):
    """The largest distance of ``got`` from ``want`` in ulps of ``want``'s
    16-bit type (below its smallest normal, the subnormal spacing)."""
    g, w = got.double(), want.double()
    info = torch.finfo(want.dtype)
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(info.tiny)))
                     - (BITS[want.dtype] - 1))
    return ((g - w).abs() / ulp).max().item()


@pytest.mark.parametrize("c", [224, 256, 320, 512])
@pytest.mark.parametrize("inverse", [False, True])
def test_3xtf32_against_pallas(c, inverse):
    x, beta, gamma = (a.astype(np.float32) for a in _case(c + inverse, 256, c))
    want = np.asarray(jax_fused_gdn(jnp.asarray(x), jnp.asarray(beta), jnp.asarray(gamma),
                                    inverse=inverse, interpret=True))
    got = _tensor_core_gdn(*map(torch.from_numpy, (x, beta, gamma)), inverse)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("c", [224, 256, 320, 512])
@pytest.mark.parametrize("inverse", [False, True])
def test_tma_form_products_against_pallas(c, inverse):
    """The TMA form's four products (lo*lo kept) in two accumulators stay
    within the tolerance too, closer to the Pallas kernel than 3xTF32."""
    x, beta, gamma = (a.astype(np.float32) for a in _case(c + inverse, 256, c))
    want = np.asarray(jax_fused_gdn(jnp.asarray(x), jnp.asarray(beta), jnp.asarray(gamma),
                                    inverse=inverse, interpret=True))
    args = list(map(torch.from_numpy, (x, beta, gamma)))
    got = _tensor_core_gdn(*args, inverse, tma=True).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    three = _tensor_core_gdn(*args, inverse).numpy()
    assert np.abs(got - want).mean() <= np.abs(three - want).mean()


# float16 GDN at |x| up to 1,000 (x*x up to 1e6, past float16's 65,504);
# IGDN at |x| up to 10, where y stays finite in float16.
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("inverse", [False, True])
def test_one_tf32_product_in_16_bit_types(dtype, inverse):
    x, beta, gamma = (torch.from_numpy(a).to(dtype)
                      for a in _case(192 + inverse, 512, 192, top=1.0 if inverse else 3.0))
    want = fused_gdn_reference(x, beta, gamma, inverse)
    got = _tensor_core_gdn(x, beta, gamma, inverse)
    assert torch.isfinite(want).all() and got.dtype == dtype
    assert _ulps(got, want) <= 2


def test_squaring_in_float16_fails():
    """x*x taken in float16 overflows above |x| = 256: the norm turns
    infinite and y collapses to 0, far outside two ulps of the twin."""
    x, beta, gamma = (torch.from_numpy(a).to(torch.float16) for a in _case(7, 512, 192))
    assert x.abs().max() > 256
    want = fused_gdn_reference(x, beta, gamma)
    bad = _tensor_core_gdn(x, beta, gamma, False, square_in=torch.float16)
    assert torch.isfinite(want).all() and _ulps(bad, want) > 2


@pytest.mark.parametrize("inverse", [False, True])
def test_dmma_steps_in_float64(inverse):
    x, beta, gamma = (torch.from_numpy(a) for a in _case(64 + inverse, 512, 256))
    got = _tensor_core_gdn(x, beta, gamma, inverse)
    xs = x.numpy()
    norm = (xs * xs) @ gamma.numpy() + beta.numpy()
    exact = xs * (np.sqrt(norm) if inverse else 1.0 / np.sqrt(norm))
    for want in (fused_gdn_reference(x, beta, gamma, inverse).numpy(), exact):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
