"""The port's tfci CLI on the CPU (``--device cpu``), at TPC_TINY_MODELS=1:
each test of tests/test_cli.py against ``compression_tpu_torch.cli.tfci``
(``--spatial N`` and ``train --num-devices N`` over N virtual CPU shards),
the LPIPS weights found in the model directory, and the CLI's imports (no
JAX, no JAX package, no PIL)."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from compression_tpu_torch import convert
from compression_tpu_torch.util import PackedTensors
from compression_tpu_torch.util import image as image_util

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def cli_env(tmp_path, monkeypatch):
    monkeypatch.setenv("TPC_TINY_MODELS", "1")
    monkeypatch.setenv("TPC_MODEL_DIR", str(tmp_path / "models"))
    monkeypatch.delenv("TPC_TABLE_CACHE_FILE", raising=False)
    h, w = 96, 128
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack(
        [xx / w * 255, yy / h * 255, ((xx + yy) % 64) * 4], -1
    ).astype(np.uint8)
    png = str(tmp_path / "in.png")
    image_util.write_png(png, img)
    return tmp_path, png, img


def _main(argv, device="cpu"):
    from compression_tpu_torch.cli.tfci import main

    return main((["--device", device] if device else []) + argv)


def test_models_verb(capsys):
    assert _main(["models"], device=None) == 0
    out = capsys.readouterr().out
    for name in ("bls2017", "bmshj2018-hyperprior", "ms2020-cc10", "hific-lo"):
        assert name in out
    # Accepted for the JAX CLI's sake: the port is always float32-strict.
    assert _main(["--strict-f32", "models"], device=None) == 0


def test_full_cycle_bls2017(cli_env, capsys):
    tmp_path, png, img = cli_env
    assert _main([
        "train", "bls2017", "--steps", "3", "--batch-size", "2",
        "--patch-size", "32",
    ]) == 0
    tfci = str(tmp_path / "out.tfci")
    out_png = str(tmp_path / "out.png")
    assert _main(["compress", "bls2017", png, tfci]) == 0
    assert os.path.getsize(tfci) > 0
    assert _main(["decompress", tfci, out_png]) == 0
    recon = image_util.read_png(out_png)
    assert recon.shape == img.shape

    npz_path = str(tmp_path / "dump.npz")
    assert _main(["dump", tfci, "--output", npz_path], device=None) == 0
    dump = capsys.readouterr().out
    assert "model: bls2017" in dump and "tensor 0" in dump
    packed = PackedTensors(open(tfci, "rb").read())
    extracted = np.load(npz_path)
    assert str(extracted["model"]) == "bls2017"
    for key, kind, count, _size in packed.describe():
        if key == "MD":
            continue
        if kind == "bytes" and count == 1:
            assert (extracted[key].tobytes()
                    == packed.unpack_one(int(key), object)[0])
        elif kind != "bytes":
            np.testing.assert_array_equal(
                extracted[key],
                packed.unpack_one(int(key), np.int64 if kind == "int64" else np.float32),
            )

    csv = str(tmp_path / "rd.csv")
    assert _main(["eval", "bls2017", png, "--csv", csv]) == 0
    lines = open(csv).read().strip().splitlines()
    # A 96px image is too small for MS-SSIM: the column is SSIM, for the
    # whole set.
    assert lines[0] == "image,bpp,psnr,ssim" and len(lines) == 3


def test_compress_requires_checkpoint(cli_env):
    tmp_path, png, _ = cli_env
    with pytest.raises(FileNotFoundError):
        _main(["compress", "mbt2018", png])


def test_unknown_model(cli_env):
    _, png, _ = cli_env
    with pytest.raises(KeyError):
        _main(["compress", "not-a-model", png])


def test_registry_propagates_requested_name():
    """The packed .tfci model name equals the requested registry name, so
    alias and quality-suffixed encodes decode from their checkpoints."""
    from compression_tpu_torch.cli import registry

    for name in (
        "bmshj2018",
        "bmshj2018-hyperprior-mse-6",
        "mbt2018",
        "ms2020-cc10-mse-3",
        "bls2017-factorized-mse",
    ):
        entry, _ = registry.resolve(name)
        assert entry.config.model_name == name, name
    entry, _ = registry.resolve("hific-lo")
    assert entry.make_model().config.name == "hific-lo"


def test_bmshj2018_factorized_roundtrip(cli_env):
    from compression_tpu_torch.cli import registry

    entry, _ = registry.resolve("bmshj2018-factorized-mse-3")
    assert entry.config.model_name == "bmshj2018-factorized-mse-3"
    assert entry.config.arch == "bmshj2018"
    model = entry.make_model()
    img = (np.random.RandomState(0).rand(64, 48, 3) * 255).astype(np.uint8)
    out = entry.decompress(model, entry.compress(model, img, device="cpu"),
                           device="cpu")
    assert out.shape == img.shape
    entry, _ = registry.resolve("b2018-gdn-192-2")
    assert entry.config.model_name == "b2018-gdn-192-2"
    assert entry.config.quality == 2
    entry, _ = registry.resolve("b2018-leaky_relu-192-1")
    assert entry.config.activation == "leaky_relu"


def test_full_cycle_alias_name_roundtrip(cli_env):
    """Train via the alias 'bmshj2018' -> compress -> decompress resolves
    back to the same checkpoint (packed name == alias)."""
    tmp_path, png, img = cli_env
    assert _main([
        "train", "bmshj2018", "--steps", "2", "--batch-size", "2",
        "--patch-size", "64",
    ]) == 0
    tfci = str(tmp_path / "alias.tfci")
    out_png = str(tmp_path / "alias.png")
    assert _main(["compress", "bmshj2018", png, tfci]) == 0
    assert PackedTensors(open(tfci, "rb").read()).model == "bmshj2018"
    assert _main(["decompress", tfci, out_png]) == 0
    assert image_util.read_png(out_png).shape == img.shape


def test_flags_not_ported_raise(cli_env):
    """--spatial exits as the JAX CLI does, before writing anything: on a
    family without a SpatialCodec (b2018), and past the devices this
    process sees (with --device cpu, a virtual shard a core)."""
    tmp_path, png, _ = cli_env
    tfci = str(tmp_path / "x.tfci")
    with pytest.raises(SystemExit, match="--spatial needs one of the codec families "
                                         "bls2017/bmshj2018/mbt2018/ms2020/hific; "
                                         "got 'b2018'"):
        _main(["compress", "b2018-gdn-128-2", png, tfci, "--spatial", "2",
               "--allow-random"])
    too_many = os.cpu_count() + 1
    with pytest.raises(SystemExit, match=f"--spatial {too_many}: this process sees "
                                         f"{os.cpu_count()} device"):
        _main(["compress", "bls2017", png, tfci, "--spatial", str(too_many),
               "--allow-random"])
    assert not os.path.exists(tfci)
    assert _main(["compress", "bls2017", png, tfci, "--allow-random"]) == 0
    with pytest.raises(SystemExit, match="this process sees"):
        _main(["decompress", tfci, "--spatial", "-1", "--allow-random"])


def test_spatial_flag_roundtrip(cli_env):
    """--spatial N (tests/test_cli.py's test): compress + decompress with
    the transforms H-sharded over N virtual CPU shards; the reconstruction
    matches the dense decode of the same stream within one level. Also
    bmshj2018 (a hyperprior family) over 2 shards."""
    tmp_path, png, img = cli_env
    assert _main(["train", "bls2017", "--steps", "2", "--batch-size", "2",
                  "--patch-size", "32"]) == 0
    for name, n, extra in (("bls2017", "4", []), ("bmshj2018", "2", ["--allow-random"])):
        tfci = str(tmp_path / f"{name}.tfci")
        out_png, dense_png = str(tmp_path / f"{name}.png"), str(tmp_path / f"{name}_d.png")
        assert _main(["compress", name, png, tfci, "--spatial", n] + extra) == 0
        assert _main(["decompress", tfci, out_png, "--spatial", n] + extra) == 0
        assert _main(["decompress", tfci, dense_png] + extra) == 0
        recon, dense = image_util.read_png(out_png), image_util.read_png(dense_png)
        assert recon.shape == img.shape
        np.testing.assert_allclose(recon.astype(np.int32), dense.astype(np.int32), atol=1)


def test_jit_decompress(cli_env):
    """--jit (the single-program decode) writes the PNG a plain decompress
    writes; another family than bmshj2018 gets the JAX CLI's SystemExit."""
    tmp_path, png, img = cli_env
    tfci = str(tmp_path / "h.tfci")
    plain, jit = str(tmp_path / "plain.png"), str(tmp_path / "jit.png")
    assert _main(["compress", "bmshj2018", png, tfci, "--allow-random"]) == 0
    assert _main(["decompress", tfci, plain, "--allow-random"]) == 0
    assert _main(["decompress", tfci, jit, "--allow-random", "--jit"]) == 0
    assert open(jit, "rb").read() == open(plain, "rb").read()
    assert image_util.read_png(jit).shape == img.shape
    other = str(tmp_path / "f.tfci")
    assert _main(["compress", "bls2017", png, other, "--allow-random"]) == 0
    with pytest.raises(SystemExit, match="--jit decode is implemented for the "
                                         "bmshj2018 family; 'bls2017' is bls2017"):
        _main(["decompress", other, str(tmp_path / "x.png"), "--allow-random", "--jit"])


def test_runs_on_cuda_unless_told_otherwise(cli_env):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the test is for hosts without it")
    _, png, _ = cli_env
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _main(["compress", "bls2017", png, "--allow-random"], device=None)


def test_data_parallel_training_raises(cli_env):
    """--num-devices that does not divide the batch: the JAX message."""
    with pytest.raises(ValueError, match=r"batch_size \(2\) must be divisible by "
                                         r"num_devices \(3\) for data parallelism"):
        _main(["train", "bls2017", "--steps", "1", "--batch-size", "2",
               "--patch-size", "32", "--num-devices", "3"])


def test_data_parallel_training(cli_env):
    """train --num-devices 2 --device cpu: data-parallel steps over 2
    virtual CPU shards; the checkpoint (the one-device layout) resumes
    on one device, and compresses."""
    from compression_tpu_torch.cli import registry
    from compression_tpu_torch.models import common

    tmp_path, png, _ = cli_env
    state = os.path.splitext(registry.checkpoint_path("bls2017"))[0] + ".train.msgpack"
    args = ["train", "bls2017", "--batch-size", "2", "--patch-size", "32"]
    assert _main(args + ["--steps", "2", "--num-devices", "2"]) == 0
    _, step, adam = common.load_checkpoint(state)
    assert step == 2 and adam["count"] == 2
    assert _main(args + ["--steps", "3"]) == 0
    assert common.load_checkpoint(state)[1] == 3
    assert _main(["compress", "bls2017", png, str(tmp_path / "dp.tfci")]) == 0


def test_train_init_from_warm_start(cli_env):
    """--init-from transfers the source model's parameters: a 0-step
    fine-tune saves them unchanged."""
    from compression_tpu_torch.cli import registry

    assert _main([
        "train", "bls2017-factorized-mse-5", "--steps", "3",
        "--batch-size", "2", "--patch-size", "32",
    ]) == 0
    src = convert.load_flax_msgpack(registry.checkpoint_path("bls2017-factorized-mse-5"))
    assert _main([
        "train", "bls2017-factorized-msssim-5", "--steps", "0",
        "--batch-size", "2", "--patch-size", "32",
        "--init-from", "bls2017-factorized-mse-5",
    ]) == 0
    dst = convert.load_flax_msgpack(
        registry.checkpoint_path("bls2017-factorized-msssim-5"))
    src_params = convert.params_from_numpy(src)
    dst_params = convert.params_from_numpy(dst)
    assert src_params.keys() == dst_params.keys()
    for key, value in src_params.items():
        torch.testing.assert_close(dst_params[key], value, rtol=0, atol=0)


def test_train_init_from_family_mismatch(cli_env):
    with pytest.raises(SystemExit):
        _main([
            "train", "mbt2018-mean-mse-5", "--steps", "1",
            "--batch-size", "2", "--patch-size", "32",
            "--init-from", "bls2017-factorized-mse-5",
        ])


def test_lpips_weights_found_in_the_model_dir(tmp_path, monkeypatch):
    from compression_tpu_torch.models.hific import lpips

    monkeypatch.delenv("TPC_LPIPS_WEIGHTS", raising=False)
    monkeypatch.setenv("TPC_MODEL_DIR", str(tmp_path))
    assert lpips.lpips_params_path() is None
    want = lpips.LPIPS(seed=3)
    path = tmp_path / "lpips_vgg16.msgpack"
    path.write_bytes(convert.pack_msgpack(
        {"params": convert.params_to_numpy(want.state_dict())}))
    assert lpips.lpips_params_path() == str(path)
    got = lpips.make_lpips().state_dict()
    for key, value in want.state_dict().items():
        torch.testing.assert_close(got[key], value, rtol=0, atol=0)
    monkeypatch.setenv("TPC_LPIPS_WEIGHTS", str(tmp_path / "missing.msgpack"))
    assert lpips.lpips_params_path() == str(path)


def _imported_modules(argv, tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, TPC_MODEL_DIR=str(tmp_path))
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "compression_tpu_torch.cli.tfci",
         *argv], capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    names = re.findall(r"^import time:\s*\d+\s*\|\s*\d+\s*\|\s*(\S+)", proc.stderr, re.M)
    return proc.stdout, {name.split(".")[0] for name in names}


def test_cli_imports_neither_jax_nor_the_jax_package_nor_pil(tmp_path):
    out, top = _imported_modules(["models"], tmp_path)
    assert "hific-lo" in out
    assert "compression_tpu_torch" in top and "torch" in top
    assert not top & {"jax", "jaxlib", "flax", "optax", "compression_tpu", "PIL"}, top


def test_eval_lpips_column(cli_env, capsys):
    tmp_path, png, _ = cli_env
    assert _main(["train", "bls2017", "--steps", "1", "--batch-size", "2",
                  "--patch-size", "32"]) == 0
    csv = str(tmp_path / "rd.csv")
    assert _main(["eval", "bls2017", png, "--csv", csv, "--lpips"]) == 0
    lines = open(csv).read().strip().splitlines()
    assert lines[0] == "image,bpp,psnr,ssim,lpips" and len(lines) == 3
    assert all(np.isfinite(float(v)) for v in lines[-1].split(",")[1:])


@pytest.mark.parametrize("argv, message", [
    (["train", "hific-lo", "--lmbda", "1"], "--lmbda does not apply to HiFiC"),
    (["train", "hific-lo", "--hinge-integral", "0.5"], "requires --rate-probe-glob"),
    (["train", "b2018", "--lmbda", "1"], "--lmbda does not apply to b2018"),
    (["compress", "bls2017", "x.png", "--rd_parameter", "2"], "only applies to variable-rate"),
    (["compress", "b2018-gdn-128-1", "x.png", "--rd_parameter", "2"],
     "conflicting rate points"),
    (["compress", "bls2017", "x.png", "--device-coder", "--allow-random"],
     "--device-coder needs a hyperprior family"),
])
def test_flag_checks(cli_env, argv, message):
    """Each flag's check stops the verb before it trains or codes."""
    tmp_path, png, _ = cli_env
    argv = [png if a == "x.png" else a for a in argv]
    with pytest.raises(SystemExit, match=message):
        _main(argv)

