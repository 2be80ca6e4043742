"""The two packages' tfci CLIs on one model directory (TPC_TINY_MODELS=1,
the port with ``--device cpu``): the JAX CLI trains a checkpoint and
compresses with it, writing the shared table file; the port's CLI, on that
file, writes byte-identical ``.tfci`` files with each coder the family has;
each package decodes the other's files within one level on at least 99% of
pixels; both ``dump`` the same text; and the port's ``train`` resumes the
JAX CLI's ``.train.msgpack`` with its Adam moments."""

import os

import numpy as np
import pytest

from compression_tpu_torch.models import common
from compression_tpu_torch.util import image as image_util

# (train name, compress name, extra compress args, patch, coders). bls2017
# caches no tables, so each package builds its own: its files are held to
# their pixels, not their bytes.
FAMILIES = {
    "bmshj2018": ("bmshj2018", "bmshj2018", [], 64, ("host", "device")),
    "mbt2018": ("mbt2018", "mbt2018", [], 64, ("host", "device")),
    "ms2020": ("ms2020", "ms2020", [], 64, ("host", "device")),
    "b2018": ("b2018", "b2018-gdn-128", ["--rd_parameter", "2"], 32, ("host",)),
    "bls2017": ("bls2017", "bls2017", [], 32, ("host",)),
}


@pytest.fixture()
def shared_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("TPC_TINY_MODELS", "1")
    monkeypatch.setenv("TPC_MODEL_DIR", str(tmp_path / "models"))
    monkeypatch.delenv("TPC_TABLE_CACHE_FILE", raising=False)
    h, w = 96, 128
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack(
        [xx / w * 255, yy / h * 255, (np.sin(xx / 7) * np.cos(yy / 5) * 0.5 + 0.5) * 255], -1
    ).astype(np.uint8)
    png = str(tmp_path / "in.png")
    image_util.write_png(png, img)
    return tmp_path, png


def _jax(argv):
    from compression_tpu.cli.tfci import main

    assert main(argv) == 0


def _port(argv):
    from compression_tpu_torch.cli.tfci import main

    assert main(["--device", "cpu"] + argv) == 0


def _close(a, b):
    a, b = image_util.read_png(a), image_util.read_png(b)
    assert a.shape == b.shape
    diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
    assert diff.max() <= 1 and np.mean(diff == 0) >= 0.99, (diff.max(), np.mean(diff == 0))


@pytest.mark.parametrize("family", ["bmshj2018", "mbt2018", "b2018", "bls2017"])
def test_both_clis_share_files(shared_dir, capsys, family):
    check_both_clis_share_files(shared_dir, capsys, family)


def check_both_clis_share_files(shared_dir, capsys, family):
    """The body of the test, shared with test_torch_cli_interop_ms2020.py
    (a file of its own so that the test runs spread over workers)."""
    from compression_tpu_torch.cli import registry

    tmp, png = shared_dir
    train_name, name, extra, patch, coders = FAMILIES[family]
    train = ["train", train_name, "--batch-size", "2", "--patch-size", str(patch)]
    _jax(train + ["--steps", "1"])

    def path(tag):
        return str(tmp / tag)

    for coder in coders:
        flag = ["--device-coder"] if coder == "device" else []
        _jax(["compress", name, png, path(f"jax_{coder}.tfci"), *extra, *flag])
        _port(["compress", name, png, path(f"port_{coder}.tfci"), *extra, *flag])
        jax_blob = open(path(f"jax_{coder}.tfci"), "rb").read()
        port_blob = open(path(f"port_{coder}.tfci"), "rb").read()
        if family != "bls2017":
            assert port_blob == jax_blob, coder
        _port(["decompress", path(f"jax_{coder}.tfci"), path(f"port_of_jax_{coder}.png")])
        _jax(["decompress", path(f"port_{coder}.tfci"), path(f"jax_of_port_{coder}.png")])
        _close(path(f"port_of_jax_{coder}.png"), path(f"jax_of_port_{coder}.png"))
    ckpt = registry.checkpoint_path(name)
    if family == "bls2017":
        _port(["decompress", path("port_host.tfci"), path("port_own.png")])
        _jax(["decompress", path("jax_host.tfci"), path("jax_own.png")])
        _close(path("port_own.png"), path("jax_own.png"))
        assert not [f for f in os.listdir(tmp / "models") if f.endswith(".tables.npz")]
    else:
        st = os.stat(ckpt)
        assert os.path.exists(f"{ckpt}.{st.st_mtime_ns}.{st.st_size}.tables.npz")

    capsys.readouterr()
    _jax(["dump", path("jax_host.tfci")])
    jax_dump = capsys.readouterr().out
    _port(["dump", path("jax_host.tfci")])
    assert capsys.readouterr().out == jax_dump

    # The JAX CLI's training state resumes in the port's, Adam moments too.
    stem = os.path.splitext(ckpt)[0]
    _port(train + ["--steps", "2"])
    assert f"resumed from {stem}.train.msgpack @ step 1" in capsys.readouterr().out
    _, step, adam = common.load_checkpoint(f"{stem}.train.msgpack")
    assert step == 2 and adam["count"] == 2
