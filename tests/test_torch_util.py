"""The port's host utilities against the JAX package's: padding, slim_int,
the blob parser; and the pipeline's ordering and error propagation."""

import threading

import numpy as np
import pytest
import torch

from compression_tpu.models.device_coding import parse_host_blobs as jax_parse
from compression_tpu.util import PackedTensors as JaxPackedTensors
from compression_tpu.util.image import pad_to_multiple_np as jax_pad
from compression_tpu.util.numeric import slim_int as jax_slim_int
from compression_tpu_torch.models.device_coding import parse_host_blobs
from compression_tpu_torch.parallel import Pipeline
from compression_tpu_torch.util.device import resolve_device
from compression_tpu_torch.util.image import pad_to_multiple_np, psnr_np
from compression_tpu_torch.util.numeric import slim_int
from compression_tpu_torch.util.profiling import StageTimer

torch.set_num_threads(1)


@pytest.mark.parametrize("hw", [(64, 64), (70, 100), (1, 129)])
def test_pad_to_multiple_matches_jax(hw):
    images = np.random.RandomState(hw[1]).randint(0, 256, (2, *hw, 3)).astype(np.uint8)
    got, got_hw = pad_to_multiple_np(images, 64)
    want, want_hw = jax_pad(images, 64)
    np.testing.assert_array_equal(got, want)
    assert got_hw == want_hw == hw


@pytest.mark.parametrize("lo,hi", [(-128, 127), (-129, 5), (0, 40000), (0, 0)])
def test_slim_int_matches_jax(lo, hi):
    values = np.array([lo, hi, (lo + hi) // 2], np.int32)
    got, want = slim_int(values), jax_slim_int(values)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _blob(xshape, fields=4):
    packed = JaxPackedTensors()
    packed.model = "bmshj2018-hyperprior"
    tensors = [b"y", b"z", np.array(xshape, np.int32), np.array([1, 1], np.int32)]
    packed.pack(tensors + [np.array([4], np.int32)] * (fields - 4))
    return packed.string


def test_parse_host_blobs_matches_jax():
    blobs = [_blob((64, 64)), _blob((64, 64))]
    got, want = parse_host_blobs(blobs), jax_parse(blobs)
    assert got[0] == want[0] and got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    with pytest.raises(ValueError, match="same-size"):
        parse_host_blobs([_blob((64, 64)), _blob((64, 128))])
    for parse in (parse_host_blobs, jax_parse):  # a device-coded blob
        with pytest.raises(ValueError, match="cannot mix"):
            parse([_blob((64, 64)), _blob((64, 64), fields=5)])


def test_pipeline_keeps_order_and_overlaps():
    started = threading.Event()

    def host(x):
        started.wait(5)  # the second batch dispatches before the first ends
        return x * 10

    def device(x):
        if x == 1:
            started.set()
        return x

    out = list(Pipeline(device, host, depth=2).run(range(6)))
    assert out == [0, 10, 20, 30, 40, 50]


def test_pipeline_raises_host_errors():
    def host(x):
        if x == 2:
            raise RuntimeError("coder failed")
        return x

    with pytest.raises(RuntimeError, match="coder failed"):
        list(Pipeline(lambda x: x, host, depth=2).run(range(4)))


def test_stage_timer_on_cpu():
    timer = StageTimer()
    for _ in range(3):
        with timer.stage("a"):
            pass
    assert timer.counts["a"] == 3
    assert "a" in timer.report()
    timer.reset()
    assert not timer.counts


def test_psnr_and_cpu_device():
    a = np.zeros((1, 4, 4, 3), np.uint8)
    b = a.copy()
    b[0, 0, 0, 0] = 16
    np.testing.assert_allclose(psnr_np(a, b), 10 * np.log10(255.0**2 / (256 / 48)))
    assert resolve_device("cpu") == torch.device("cpu")
