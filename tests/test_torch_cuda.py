"""Tests of the port that need the card: the CUDA kernel K1 against its plain
twin, and the codec on the card against the CPU path. They skip without a
GPU. This file imports neither JAX nor the JAX package, so on a machine
without JAX run it alone, without the suite's conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from compression_tpu_torch.layers import fused_gdn, fused_gdn_reference
from compression_tpu_torch.models import bmshj2018

TOL = dict(rtol=2e-5, atol=2e-5)  # the TPU kernel's tolerance

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from compression_tpu_torch.util.device import strict_fp32

    strict_fp32()
    return torch.device("cuda")


def _inputs(seed, rows, c, device):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, c, generator=gen)
    beta = torch.rand(c, generator=gen) * 1.5 + 0.5
    gamma = torch.rand(c, c, generator=gen) * 0.1 + 0.05 * torch.eye(c)
    return [t.to(device) for t in (x, beta, gamma)]


@pytest.mark.parametrize("c", [32, 64, 128, 192])
@pytest.mark.parametrize("rows", [1, 63, 4551, 200_000])
@pytest.mark.parametrize("inverse", [False, True])
def test_kernel_matches_twin(cuda, c, rows, inverse):
    x, beta, gamma = _inputs(c + rows, rows, c, cuda)
    before = fused_gdn.launches
    with torch.inference_mode():
        got = fused_gdn(x, beta, gamma, inverse)
        torch.cuda.synchronize()
        want = fused_gdn_reference(x, beta, gamma, inverse)
    assert fused_gdn.launches == before + 1
    torch.testing.assert_close(got, want, **TOL)


def test_kernel_takes_leading_dims(cuda):
    x, beta, gamma = _inputs(1, 2 * 7 * 9, 192, cuda)
    x4 = x.reshape(2, 7, 9, 192)
    with torch.inference_mode():
        got = fused_gdn(x4, beta, gamma)
        want = fused_gdn_reference(x4, beta, gamma)
    assert got.shape == x4.shape
    torch.testing.assert_close(got, want, **TOL)


def test_kernel_rejects_what_it_cannot_take(cuda):
    x, beta, gamma = _inputs(2, 64, 192, cuda)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="contiguous"):
            fused_gdn(x.t(), beta, gamma[:64, :64].contiguous())
        with pytest.raises(TypeError, match="float32"):
            fused_gdn(x.double(), beta, gamma)
        x48, b48, g48 = _inputs(3, 64, 48, cuda)
        with pytest.raises(ValueError, match="unsupported"):
            fused_gdn(x48, b48, g48)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_gdn(x.requires_grad_(), beta, gamma)


def test_codec_on_card_round_trip_matches_cpu(cuda):
    torch.manual_seed(0)
    cfg = bmshj2018.Config(num_filters=32, num_latents=32, num_hyperlatents=32)
    cpu_model = bmshj2018.BMSHJ2018Model(cfg)
    gpu_model = bmshj2018.BMSHJ2018Model(cfg)
    gpu_model.load_state_dict(cpu_model.state_dict())
    cpu = bmshj2018.Codec(cpu_model, device="cpu")
    gpu = bmshj2018.Codec(gpu_model, device=cuda,
                          tables={"side": cpu.side_em.tables, "main": cpu.em.tables})
    rng = np.random.RandomState(0)
    images = (rng.rand(3, 96, 130, 3) * 255).astype(np.uint8)
    before = fused_gdn.launches
    blobs = gpu.compress_batch(images)
    out = gpu.decompress_batch(blobs)
    assert fused_gdn.launches == before + 6
    assert out.shape == images.shape and out.dtype == np.uint8
    assert gpu.compress_batch(images) == blobs
    np.testing.assert_array_equal(gpu.decompress(blobs[2]), out[2])
    iter_out = np.concatenate(list(gpu.decompress_iter(gpu.compress_iter([images[:1], images[1:]]))))
    np.testing.assert_array_equal(iter_out, out)
    # The CPU codec's own round trip lands within one level.
    cpu_out = cpu.decompress_batch(cpu.compress_batch(images))
    assert np.abs(cpu_out.astype(np.int16) - out.astype(np.int16)).max() <= 1
