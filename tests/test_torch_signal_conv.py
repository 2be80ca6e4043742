"""The port's SignalConv2D against the JAX package's, for each layer kind
bmshj2018 uses, in float32 at 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compression_tpu.layers import SignalConv2D as JaxSignalConv2D
from compression_tpu.layers.signal_conv import phase_kernel as jax_phase_kernel
from compression_tpu_torch.convert import kernel_to_torch
from compression_tpu_torch.layers import SignalConv2D
from compression_tpu_torch.layers.signal_conv import phase_kernel

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)

# bmshj2018's layer kinds: analysis/hyper-analysis down-sampling, synthesis
# /hyper-synthesis up-sampling, and the 3x3 stride-1 hyper layers.
KINDS = {
    "corr5_down2": dict(kernel_support=5, corr=True, strides_down=2),
    "conv5_up2": dict(kernel_support=5, corr=False, strides_up=2),
    "corr3": dict(kernel_support=3, corr=True),
}


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("hw", [(8, 6), (7, 9)])
def test_matches_jax(kind, use_bias, hw):
    spec = KINDS[kind]
    cin, cout = 4, 6
    rng = np.random.RandomState(len(kind) + 10 * use_bias + hw[0])
    x = rng.randn(2, *hw, cin).astype(np.float32)
    k = spec["kernel_support"]
    kernel = rng.randn(k, k, cin, cout).astype(np.float32) * 0.2
    bias = rng.randn(cout).astype(np.float32)

    flax_mod = JaxSignalConv2D(cout, padding="same_zeros", use_bias=use_bias,
                               **spec)
    params = {"kernel": jnp.asarray(kernel)}
    if use_bias:
        params["bias"] = jnp.asarray(bias)
    want = np.asarray(flax_mod.apply({"params": params}, jnp.asarray(x)))

    mod = SignalConv2D(cin, cout, padding="same_zeros", use_bias=use_bias,
                       **spec)
    state = {"weight": kernel_to_torch(kernel)}
    if use_bias:
        state["bias"] = torch.from_numpy(bias)
    mod.load_state_dict(state)
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("k,su,lo", [(5, 2, 2), (5, 2, 3), (3, 2, 1), (9, 4, 4)])
def test_phase_kernel_is_the_same_gather(k, su, lo):
    kernel = np.random.RandomState(k * su).randn(k, k, 3, 2).astype(np.float32)
    want, want_mlo, want_m = jax_phase_kernel(jnp.asarray(kernel), (su, su), (lo, lo))
    got, mlo, m = phase_kernel(kernel_to_torch(kernel), (su, su), (lo, lo))
    assert list(mlo) == list(want_mlo) and list(m) == list(want_m)
    # JAX: (*M, cin, P*cout); port: OIHW (P*cout, cin, *M).
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).transpose(3, 2, 0, 1))


def test_output_is_nhwc_contiguous():
    mod = SignalConv2D(4, 8, 5, corr=False, strides_up=2, padding="same_zeros",
                       use_bias=True)
    with torch.no_grad():
        y = mod(torch.randn(1, 3, 5, 4))
    assert y.shape == (1, 6, 10, 8)
    assert y.is_contiguous()


def test_reflect_padding_is_not_ported():
    mod = SignalConv2D(2, 2, 3, padding="same_reflect")
    with pytest.raises(ValueError, match="padding"):
        mod(torch.zeros(1, 4, 4, 2))
