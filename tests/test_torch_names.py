"""The last public names of the JAX package the port lacked:
``parallel.pipeline.pipeline_map``, ``util.image.pad_to_multiple`` and
``unpad``, the post-install smoke run ``all_tests``, and the multi-device
names of ``compression_tpu.parallel`` and its modules."""

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


@pytest.mark.parametrize("module", ["parallel", "parallel.data_parallel", "parallel.spatial",
                                    "parallel.charm_sharded"])
def test_the_multi_device_names_are_present(module):
    """Every name the JAX package's multi-device modules export, and every
    family's sharded functions and SpatialCodec."""
    import importlib

    want = importlib.import_module(f"compression_tpu.{module}").__all__
    got = importlib.import_module(f"compression_tpu_torch.{module}")
    assert [n for n in want if not hasattr(got, n)] == []
    if module == "parallel":
        from compression_tpu.models import bls2017, bmshj2018, mbt2018, ms2020
        from compression_tpu.models.hific import model as hific

        from compression_tpu_torch.models import bls2017 as p_bls, bmshj2018 as p_bmshj
        from compression_tpu_torch.models import mbt2018 as p_mbt, ms2020 as p_ms
        from compression_tpu_torch.models.hific import model as p_hific

        for jax_mod, port_mod in ((bls2017, p_bls), (bmshj2018, p_bmshj), (mbt2018, p_mbt),
                                  (ms2020, p_ms), (hific, p_hific)):
            names = [n for n in dir(jax_mod) if n.startswith("sharded_")] + ["SpatialCodec"]
            assert [n for n in names if not hasattr(port_mod, n)] == [], port_mod.__name__
