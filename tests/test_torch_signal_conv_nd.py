"""The port's N-D signal convolution against the JAX package's
(tests/test_signal_conv.py:87-216): SignalConv1D and SignalConv3D, the
``same_reflect`` padding (zero-stuffed before it reflects), channel-separable
kernels (up-sampled by zero-stuffing, the JAX package's lhs_dilation),
RDFT kernels and their parameters, and the identity initializer. float64
inputs at 1e-9 (the golden grids' tolerance), float32 modules forward and
backward at 1e-5."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compression_tpu.layers import SignalConv1D as JaxSignalConv1D
from compression_tpu.layers import SignalConv2D as JaxSignalConv2D
from compression_tpu.layers import SignalConv3D as JaxSignalConv3D
from compression_tpu.layers import parameters as jax_parameters
from compression_tpu.layers import signal_conv as jax_sc
from compression_tpu.layers.initializers import identity_kernel_init as jax_identity_init
from compression_tpu_torch.convert import kernel_from_torch, params_from_numpy
from compression_tpu_torch.layers import (
    GDNParameter,
    Parameter,
    RDFTParameter,
    SignalConv1D,
    SignalConv2D,
    SignalConv3D,
    identity_kernel_init,
    parameters,
    signal_conv,
)

torch.set_num_threads(1)

F64 = dict(rtol=1e-9, atol=1e-9)
F32 = dict(rtol=1e-5, atol=1e-5)


def _kernel_to_torch64(kernel):
    nd = kernel.ndim
    return torch.from_numpy(np.ascontiguousarray(kernel.transpose(nd - 1, nd - 2, *range(nd - 2))))


def _conv(x, kernel, **kw):
    want = np.asarray(jax_sc.signal_conv(jnp.asarray(x), jnp.asarray(kernel), **kw))
    got = signal_conv(torch.from_numpy(x), _kernel_to_torch64(kernel), **kw).numpy()
    assert got.shape == want.shape, (got.shape, want.shape, kw)
    np.testing.assert_allclose(got, want, **F64, err_msg=str(kw))


@pytest.mark.parametrize("padding", ["valid", "same_zeros", "same_reflect"])
@pytest.mark.parametrize("corr", [True, False])
def test_1d_grid_matches_jax(padding, corr):
    for k, sd, su, extra in itertools.product([1, 4, 5], [1, 2, 3], [1, 2, 3], [True, False]):
        n = max(k, 6) if padding == "same_reflect" else 7
        rng = np.random.RandomState(hash((k, corr, sd, su)) % 2 ** 31)
        _conv(rng.randn(2, n, 3), rng.randn(k, 3, 2), corr=corr, strides_down=sd,
              strides_up=su, padding=padding, extra_pad_end=extra)


@pytest.mark.parametrize("padding", ["valid", "same_zeros", "same_reflect"])
@pytest.mark.parametrize("k", [(3, 3), (2, 4), (5, 5)])
def test_2d_grid_matches_jax(k, padding):
    for corr, sd, su in itertools.product([True, False], [(1, 1), (2, 2), (2, 1)],
                                          [(1, 1), (2, 2), (1, 2)]):
        rng = np.random.RandomState(hash((k, corr, sd, su, padding)) % 2 ** 31)
        _conv(rng.randn(1, 8, 9, 2), rng.randn(*k, 2, 3), corr=corr, strides_down=sd,
              strides_up=su, padding=padding)


def test_reflect_wider_than_the_signal_matches_jax():
    """Pads of the signal's length or more reflect again (NumPy's and
    jnp.pad's reflect); F.pad would refuse them."""
    rng = np.random.RandomState(0)
    _conv(rng.randn(1, 3, 2), rng.randn(9, 2, 2), corr=True, padding="same_reflect")
    _conv(rng.randn(1, 1, 2), rng.randn(5, 2, 2), corr=True, padding="same_reflect")


@pytest.mark.parametrize("padding", ["valid", "same_zeros", "same_reflect"])
def test_3d_matches_jax(padding):
    rng = np.random.RandomState(0)
    x = rng.randn(1, 5, 6, 7, 2)
    kernel = rng.randn(3, 3, 3, 2, 4)
    _conv(x, kernel, corr=True, strides_down=(1, 2, 1), padding=padding)
    _conv(x, kernel, corr=False, strides_up=(2, 1, 2), padding=padding)
    _conv(x, rng.randn(2, 3, 4, 2, 3), corr=False, strides_up=2, strides_down=(1, 1, 2),
          padding=padding, extra_pad_end=False)


@pytest.mark.parametrize("padding", ["valid", "same_zeros", "same_reflect"])
@pytest.mark.parametrize("su", [1, 2])
def test_channel_separable_matches_jax(padding, su):
    rng = np.random.RandomState(1)
    cin, mult = 3, 2
    x = rng.randn(2, 10, 9, cin)
    kernel = rng.randn(3, 3, 1, cin * mult)
    for corr, sd, extra in itertools.product([True, False], [1, 2], [True, False]):
        _conv(x, kernel, corr=corr, strides_down=sd, strides_up=su, padding=padding,
              extra_pad_end=extra, channel_separable=True)
    _conv(rng.randn(1, 7, cin), rng.randn(5, 1, cin), corr=False, strides_up=3,
          padding=padding, channel_separable=True)


def test_channel_separable_rejects_a_dense_kernel():
    with pytest.raises(ValueError, match="channel_separable"):
        signal_conv(torch.zeros(1, 5, 5, 3), torch.zeros(4, 3, 3, 3), channel_separable=True)


MODULES = {
    "conv1d_reflect_down": (SignalConv1D, JaxSignalConv1D, (2, 11, 3), dict(
        kernel_support=5, corr=True, strides_down=2, padding="same_reflect")),
    "conv1d_up": (SignalConv1D, JaxSignalConv1D, (2, 6, 3), dict(
        kernel_support=4, corr=False, strides_up=3, padding="same_zeros")),
    "conv3d_down": (SignalConv3D, JaxSignalConv3D, (1, 6, 5, 7, 3), dict(
        kernel_support=3, corr=True, strides_down=(2, 1, 2), padding="same_zeros")),
    "conv3d_up_reflect": (SignalConv3D, JaxSignalConv3D, (1, 3, 4, 3, 3), dict(
        kernel_support=(3, 2, 3), corr=False, strides_up=2, padding="same_reflect")),
    "conv2d_reflect_down": (SignalConv2D, JaxSignalConv2D, (2, 12, 10, 3), dict(
        kernel_support=5, corr=True, strides_down=2, padding="same_reflect")),
    "conv2d_separable_up": (SignalConv2D, JaxSignalConv2D, (2, 6, 5, 3), dict(
        kernel_support=5, corr=False, strides_up=2, padding="same_zeros",
        channel_separable=True)),
    "conv2d_rdft": (SignalConv2D, JaxSignalConv2D, (2, 9, 8, 3), dict(
        kernel_support=5, corr=True, strides_down=2, padding="same_zeros",
        kernel_param="rdft")),
    "conv3d_rdft_separable": (SignalConv3D, JaxSignalConv3D, (1, 4, 5, 4, 3), dict(
        kernel_support=3, corr=True, padding="same_reflect", kernel_param="rdft",
        channel_separable=True)),
}


@pytest.mark.parametrize("name", sorted(MODULES))
@pytest.mark.parametrize("use_bias", [False, True])
def test_modules_forward_and_backward_match_jax(name, use_bias):
    """float32 forward and every gradient, the JAX params mapped through the
    weight bridge (kernel, kernel_rdft, bias)."""
    port_cls, jax_cls, shape, kw = MODULES[name]
    filters = 2 if kw.get("channel_separable") else 4
    rng = np.random.RandomState(len(name) + use_bias)
    x = rng.randn(*shape).astype(np.float32)
    jax_mod = jax_cls(filters, use_bias=use_bias, **kw)
    params = jax_mod.init(jax.random.PRNGKey(len(name)), jnp.asarray(x))["params"]
    if use_bias:
        params = dict(params, bias=jnp.asarray(rng.randn(*params["bias"].shape).astype(np.float32)))
    mod = port_cls(shape[-1], filters, use_bias=use_bias, **kw)
    state = params_from_numpy({"layer": jax.tree_util.tree_map(np.asarray, params)})
    mod.load_state_dict({k.split(".", 1)[1]: v for k, v in state.items()})
    assert ("weight_rdft" in dict(mod.named_parameters())) == (kw.get("kernel_param") == "rdft")

    def jax_loss(p, v):
        return jnp.sum(jax_mod.apply({"params": p}, v) ** 2), jax_mod.apply({"params": p}, v)

    (_, want), (gp, gx) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = mod(xt)
    (y ** 2).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), **F32)
    gx = np.asarray(gx)
    np.testing.assert_allclose(xt.grad.numpy(), gx, rtol=1e-5, atol=1e-5 * np.abs(gx).max())
    grads = params_from_numpy({"layer": jax.tree_util.tree_map(np.asarray, gp)})
    for key, value in grads.items():
        got = dict(mod.named_parameters())[key.split(".", 1)[1]].grad
        scale = float(np.abs(value.numpy()).max())
        np.testing.assert_allclose(got.numpy(), value.numpy(), rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=key)


def test_rdft_basis_and_transforms_equal_jax():
    for n in (1, 2, 9, 25, 27):
        np.testing.assert_array_equal(parameters.rdft_basis(n), jax_parameters.rdft_basis(n))
        b = parameters.rdft_basis(n)
        np.testing.assert_allclose(b @ b.T, np.eye(n), atol=1e-12)
    kernel = np.random.RandomState(0).randn(3, 3, 2, 4)
    basis = parameters.rdft_basis(9)
    coeffs = parameters.rdft_init(torch.from_numpy(kernel), basis)
    np.testing.assert_allclose(coeffs.numpy(), np.asarray(jax_parameters.rdft_init(jnp.asarray(kernel), basis)), **F64)
    back = parameters.rdft_apply(coeffs, basis, (3, 3))
    np.testing.assert_allclose(back.numpy(), np.asarray(jax_parameters.rdft_apply(
        jnp.asarray(coeffs.numpy()), basis, (3, 3))), **F64)
    np.testing.assert_allclose(back.numpy(), kernel, atol=1e-12)


def test_rdft_module_params_and_default_init():
    m = SignalConv2D(2, 2, (3, 3), corr=True, padding="same_zeros", kernel_param="rdft")
    assert m.weight is None and m.weight_rdft.shape == (9, 2, 2)
    y = m(torch.ones(1, 8, 8, 2))
    assert y.shape == (1, 8, 8, 2)
    # A one-tap support keeps a plain kernel, as in the JAX package.
    assert SignalConv2D(2, 2, 1, kernel_param="rdft").weight.shape == (2, 2, 1, 1)
    with pytest.raises(ValueError, match="kernel_param"):
        SignalConv2D(2, 2, 3, kernel_param="fourier")


def test_parameter_wrappers_roundtrip_and_grad():
    g = GDNParameter.create(torch.tensor([0.5, 0.0, 2.0]), minimum=0.0)
    np.testing.assert_allclose(g().detach().numpy(), [0.5, 0.0, 2.0], atol=1e-6)
    assert isinstance(g, Parameter)
    (g() ** 2).sum().backward()
    assert g.stored.grad.shape == g.stored.shape
    kernel = np.random.RandomState(0).randn(3, 3, 2, 4).astype(np.float32)
    r = RDFTParameter.create(kernel)
    np.testing.assert_allclose(r().detach().numpy(), kernel, atol=1e-5)
    assert r.coeffs.shape == (9, 2, 4)
    from compression_tpu import RDFTParameter as JaxRDFTParameter

    np.testing.assert_allclose(r.coeffs.detach().numpy(),
                               np.asarray(JaxRDFTParameter.create(kernel).coeffs), **F32)


@pytest.mark.parametrize("shape", [(5, 5, 3, 3), (3, 2, 4), (3, 3, 3, 2, 2), (1, 4, 6)])
def test_identity_initializer_equals_jax(shape):
    want = np.asarray(jax_identity_init(1.5)(jax.random.PRNGKey(0), shape))
    torch_shape = (shape[-1], shape[-2]) + shape[:-2]
    got = identity_kernel_init(1.5)(None, torch_shape)
    np.testing.assert_array_equal(kernel_from_torch(got), want)


def test_identity_initializer_is_identity():
    m = SignalConv2D(3, 3, (5, 5), corr=True, padding="same_zeros",
                     kernel_init=identity_kernel_init())
    x = torch.from_numpy(np.random.RandomState(2).randn(1, 9, 9, 3).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(m(x).numpy(), x.numpy(), rtol=1e-6, atol=1e-12)
    m = SignalConv1D(3, 3, 4, corr=True, padding="same_reflect", kernel_param="rdft",
                     kernel_init=identity_kernel_init())
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 7, 3).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(m(x).numpy(), x.numpy(), rtol=1e-6, atol=1e-6)
