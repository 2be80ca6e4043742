"""The port's halo-sharded convolutions (``parallel/spatial.py``) on virtual
CPU shards: down- and up-convolutions against the port's dense
``signal_conv`` at 1, 2 and 4 shards, strides 1 and 2 (and the codecs' 4),
odd and even kernels, both orientations, in float64 within 1e-9
(tests/test_parallel_extras.py's tolerance); a few cases against the JAX
package's sharded functions on its virtual devices; the restrictions'
ValueErrors; a transform stack of SignalConv2D and GDN layers against its
module."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compression_tpu.parallel import data_parallel as jax_dp
from compression_tpu.parallel import spatial as jax_spatial
from compression_tpu_torch.layers import GDN, SignalConv2D
from compression_tpu_torch.layers.signal_conv import signal_conv
from compression_tpu_torch.parallel import make_mesh
from compression_tpu_torch.parallel.data_parallel import Mesh
from compression_tpu_torch.parallel.spatial import (
    gather_rows,
    shard_rows,
    sharded_signal_conv2d,
    sharded_signal_conv2d_up,
    sharded_transform_apply,
)

torch.set_num_threads(1)

DOWN = [(k, s) for k, s in itertools.product((3, 4, 5), (1, 2))] + [(9, 4)]
UP = [(5, 2), (4, 2), (3, 2), (9, 4), (3, 1)]


def _rand(rng, *shape):
    return torch.from_numpy(rng.randn(*shape))


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("corr", [True, False])
def test_sharded_down_conv_matches_dense(shards, corr):
    rng = np.random.RandomState(shards)
    mesh = make_mesh(shards, device="cpu")
    x = _rand(rng, 2, 32, 16, 3)
    for k, s in DOWN:
        kernel = _rand(rng, 4, 3, k, k)
        want = signal_conv(x, kernel, corr=corr, padding="same_zeros", strides_down=s)
        got = gather_rows(sharded_signal_conv2d(x, kernel, mesh, corr=corr, strides_down=s))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-9,
                                   err_msg=f"{k}x{k} stride {s}")


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("corr", [False, True])
def test_sharded_up_conv_matches_dense(shards, corr):
    rng = np.random.RandomState(10 + shards)
    mesh = make_mesh(shards, device="cpu")
    x = _rand(rng, 2, 16, 8, 3)
    for k, s in UP:
        kernel = _rand(rng, 4, 3, k, k)
        want = signal_conv(x, kernel, corr=corr, padding="same_zeros", strides_up=s)
        got = gather_rows(sharded_signal_conv2d_up(x, kernel, mesh, corr=corr, strides_up=s))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-9,
                                   err_msg=f"{k}x{k} up {s}")


def test_shards_stay_on_their_devices_and_chain():
    """The output is one shard per mesh position, each on its device; a
    list of shards goes in as it is (a second conv reads the first's)."""
    rng = np.random.RandomState(3)
    other = torch.device("cpu", 0)
    mesh = Mesh(("cpu", other))
    x = _rand(rng, 1, 16, 8, 3)
    k1, k2 = _rand(rng, 4, 3, 5, 5), _rand(rng, 2, 4, 3, 3)
    shards = sharded_signal_conv2d(x, k1, mesh, strides_down=2)
    assert len(shards) == 2 and [tuple(s.shape) for s in shards] == [(1, 4, 4, 4)] * 2
    got = gather_rows(sharded_signal_conv2d_up(shards, k2, mesh, corr=False))
    want = signal_conv(signal_conv(x, k1, corr=True, padding="same_zeros", strides_down=2),
                       k2, corr=False, padding="same_zeros", strides_up=2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-9)


@pytest.mark.parametrize("case", ["down 5x5/2", "down 4x4/1", "up 5x5/2", "up 9x9/4"])
def test_sharded_convs_match_jax(case):
    """Against the JAX package's sharded functions over 4 of its virtual
    devices, in float64 (kernels through the layout bridge: OIHW to
    HWIO)."""
    direction, spec = case.split()
    k, s = (int(v) for v in spec.replace("x", " ").replace("/", " ").split()[1:])
    rng = np.random.RandomState(7)
    x = rng.randn(1, 32 if direction == "down" else 16, 8, 3)
    kernel = rng.randn(4, 3, k, k)
    jax_kernel = jnp.asarray(kernel.transpose(2, 3, 1, 0))
    jmesh = jax_dp.make_mesh(4)
    mesh = make_mesh(4, device="cpu")
    if direction == "down":
        want = jax_spatial.sharded_signal_conv2d(jnp.asarray(x), jax_kernel, jmesh,
                                                 strides_down=s)
        got = sharded_signal_conv2d(torch.from_numpy(x), torch.from_numpy(kernel), mesh,
                                    strides_down=s)
    else:
        want = jax_spatial.sharded_signal_conv2d_up(jnp.asarray(x), jax_kernel, jmesh,
                                                    strides_up=s)
        got = sharded_signal_conv2d_up(torch.from_numpy(x), torch.from_numpy(kernel), mesh,
                                       strides_up=s)
    np.testing.assert_allclose(gather_rows(got).numpy(), np.asarray(jax.device_get(want)),
                               rtol=0, atol=1e-9)


def test_restrictions_raise():
    mesh = make_mesh(4, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        sharded_signal_conv2d(torch.zeros(1, 12, 8, 3), torch.zeros(4, 3, 3, 3), mesh,
                              strides_down=2)
    with pytest.raises(ValueError, match="divide"):
        sharded_signal_conv2d_up(torch.zeros(1, 10, 8, 3), torch.zeros(4, 3, 3, 3), mesh)
    with pytest.raises(ValueError, match="smaller than the halo"):
        sharded_signal_conv2d(torch.zeros(1, 8, 8, 3), torch.zeros(4, 3, 9, 9), mesh)
    with pytest.raises(ValueError, match="smaller than the halo"):
        sharded_signal_conv2d_up(torch.zeros(1, 4, 8, 3), torch.zeros(4, 3, 9, 9), mesh,
                                 strides_up=1)
    with pytest.raises(ValueError, match="must divide"):
        shard_rows(torch.zeros(1, 6, 8, 3), mesh)
    reflect = torch.nn.Sequential()
    reflect.add_module("conv0", SignalConv2D(3, 4, 3, padding="same_reflect"))
    with pytest.raises(ValueError, match="same_zeros"):
        sharded_transform_apply(reflect, torch.zeros(1, 8, 8, 3), mesh)
    other = torch.nn.Sequential()
    other.add_module("act", torch.nn.ReLU())
    with pytest.raises(TypeError, match="SignalConv2D and GDN"):
        sharded_transform_apply(other, torch.zeros(1, 8, 8, 3), mesh)


def test_transform_stack_matches_its_module():
    """A stack of strided SignalConv2Ds with bias and activation and a GDN
    between them, sharded over 4 shards (two of them on a second device),
    against the module's forward, float32 within 1e-5."""
    gen = torch.Generator().manual_seed(0)
    stack = torch.nn.Sequential()
    stack.add_module("conv0", SignalConv2D(3, 8, 5, corr=True, strides_down=2,
                                           padding="same_zeros", use_bias=True,
                                           generator=gen))
    stack.add_module("gdn0", GDN(8))
    stack.add_module("conv1", SignalConv2D(8, 6, 3, corr=False, strides_up=2,
                                           padding="same_zeros", use_bias=True,
                                           activation=torch.relu, generator=gen))
    x = torch.from_numpy(np.random.RandomState(1).rand(2, 32, 16, 3).astype(np.float32))
    other = torch.device("cpu", 0)
    with torch.no_grad():
        want = stack(x)
        for mesh in (make_mesh(4, device="cpu"), Mesh(("cpu", other, "cpu", other))):
            got = gather_rows(sharded_transform_apply(stack, x, mesh))
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
