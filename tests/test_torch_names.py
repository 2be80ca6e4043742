"""The last public names of the JAX package the port lacked:
``parallel.pipeline.pipeline_map``, ``util.image.pad_to_multiple`` and
``unpad``, and the post-install smoke run ``all_tests``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compression_tpu.util import image as jax_image
from compression_tpu_torch import all_tests
from compression_tpu_torch.parallel.pipeline import pipeline_map
from compression_tpu_torch.util.image import pad_to_multiple, unpad


def test_pipeline_preserves_order_and_results():
    """tests/test_parallel_extras.py's pipeline_map case."""
    dev = lambda x: x * 2  # noqa: E731
    host = lambda a: int(a.sum())  # noqa: E731
    batches = [torch.full((4,), i) for i in range(10)]
    assert pipeline_map(dev, host, batches, depth=3) == [i * 8 for i in range(10)]
    assert pipeline_map(dev, host, [], depth=2) == []


@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.int32])
@pytest.mark.parametrize("shape,multiple", [
    ((2, 70, 100, 3), 64), ((5, 7, 2), 4), ((1, 64, 64, 3), 16), ((3, 2, 9, 13, 1), 8),
])
def test_pad_to_multiple_and_unpad_match_jax(dtype, shape, multiple):
    rng = np.random.RandomState(len(shape) + multiple)
    x = (rng.rand(*shape) * 255).astype(dtype)
    want, want_hw = jax_image.pad_to_multiple(jnp.asarray(x), multiple)
    got, hw = pad_to_multiple(torch.from_numpy(x), multiple)
    assert hw == want_hw == (shape[-3], shape[-2])
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = unpad(got, hw)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jax_image.unpad(want, hw)))
    np.testing.assert_array_equal(back.numpy(), x)


def test_all_tests_without_a_tests_tree(monkeypatch, tmp_path, capsys):
    """Installed without the repo's tests/: the import and host-coder
    round trip, as compression_tpu/all_tests.py does it."""
    monkeypatch.setattr(all_tests, "TESTS_DIR", str(tmp_path / "no-tests"))
    assert all_tests.main() == 0
    assert "compression_tpu_torch 0.1.0: smoke test OK" in capsys.readouterr().out


def test_all_tests_runs_the_ports_tests(monkeypatch, tmp_path):
    """Beside a tests/ tree it hands pytest the port's test files only."""
    for name in ("test_torch_a.py", "test_torch_b.py", "test_jax_thing.py"):
        (tmp_path / name).write_text("")
    seen = []
    monkeypatch.setattr(all_tests, "TESTS_DIR", str(tmp_path))
    monkeypatch.setattr(pytest, "main", lambda args: seen.append(args) or 0)
    assert all_tests.main() == 0
    assert seen == [[str(tmp_path / "test_torch_a.py"), str(tmp_path / "test_torch_b.py"), "-q"]]
