"""The port's bmshj2018 codec against the JAX package's: the weight bridge
and its msgpack reader, the full-width transforms of the committed
checkpoint, a small codec's round trip on the CPU with either coder, and
host- and device-coded blobs that cross between the packages; plus the rule
that the port never imports JAX."""

import pathlib
import re

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from compression_tpu.models import bmshj2018 as jax_bmshj2018
from compression_tpu.util import PackedTensors as JaxPackedTensors
from compression_tpu_torch import convert
from compression_tpu_torch.models import bmshj2018

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CKPT = ROOT / "ckpt" / "bmshj2018.msgpack"
SMALL = dict(num_filters=16, num_latents=16, num_hyperlatents=8)


def _structured_images(n, h, w, seed=0):
    """Gradients + texture + a block + mild noise (bench.py's recipe)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    image = np.stack([xx / w * 255, yy / h * 255,
                      (np.sin(xx / 17) * np.cos(yy / 23) * 0.5 + 0.5) * 255], -1)
    image[h // 4 : h // 2, w // 4 : w // 2] = [255, 64, 32]
    rng = np.random.RandomState(seed)
    return np.stack([
        np.clip(image + rng.randn(h, w, 3) * 4, 0, 255).astype(np.uint8)
        for _ in range(n)
    ])


# -- weight bridge --------------------------------------------------------


def _flax_ext(code, data):
    if code == 1:
        shape, dtype, buf = msgpack.unpackb(data)
        return np.frombuffer(buf, dtype=dtype).reshape(shape)
    raise AssertionError(f"unexpected ext {code}")


def _assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want and type(got) is type(want), path


def test_msgpack_reader_matches_msgpack_package_on_checkpoint():
    raw = CKPT.read_bytes()
    want = msgpack.unpackb(raw, ext_hook=_flax_ext, strict_map_key=False)
    got = convert.load_flax_msgpack(CKPT)
    _assert_trees_equal(got, want)
    leaves = got["params"]["params"]
    assert got["step"] == 6000
    assert leaves["analysis"]["conv1"]["kernel"].shape == (5, 5, 192, 192)


def test_msgpack_reader_on_every_type():
    obj = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63 - 1,
                 -1, -32, -33, -128, -129, -32768, -32769, -2**31 - 1, -2**63],
        "floats": [0.5, -1e300, 3.25],
        "strs": ["", "a" * 31, "b" * 32, "c" * 300, "ü" * 40000],
        "bins": [b"", b"x" * 255, b"y" * 256, b"z" * 70000],
        "misc": [None, True, False, list(range(20)), {str(i): i for i in range(20)}],
        "nested": {"a": {"b": [[], {}]}},
    }
    assert convert.unpack_msgpack(msgpack.packb(obj, use_bin_type=True)) == obj
    arrays = {"f32": np.arange(6, dtype=np.float32).reshape(2, 3),
              "i8": np.array([-3, 4], np.int8), "f64": np.array(2.5),
              "u16": np.arange(300, dtype=np.uint16)}
    got = convert.unpack_msgpack(serialization.msgpack_serialize(arrays))
    _assert_trees_equal(got, arrays)


def test_params_from_numpy_maps_every_leaf():
    state = convert.params_from_numpy(convert.load_flax_msgpack(CKPT))
    model = bmshj2018.BMSHJ2018Model()
    model.load_state_dict(state)  # strict: every parameter, no extras
    assert len(state) == 49
    assert tuple(state["analysis.conv0.weight"].shape) == (192, 3, 5, 5)
    assert tuple(state["hyperprior.matrices.1"].shape) == (128, 3, 3)


# -- full-width transforms ------------------------------------------------


def test_full_width_transforms_from_checkpoint_match_jax():
    tree = convert.load_flax_msgpack(CKPT)["params"]["params"]
    jax_params = {"params": jax.tree_util.tree_map(
        jnp.asarray, {k: tree[k] for k in
                      ("analysis", "synthesis", "hyper_analysis", "hyper_synthesis")}
    )}
    jax_model = jax_bmshj2018.BMSHJ2018Model(jax_bmshj2018.Config())
    model = bmshj2018.load_model(CKPT)
    x = _structured_images(1, 64, 64).astype(np.float32) / 255.0
    y, z = jax_model.apply(jax_params, jnp.asarray(x),
                           method=jax_bmshj2018.BMSHJ2018Model.encode_latents)
    z_hat, y_hat = np.round(np.asarray(z)), np.round(np.asarray(y))
    sigma = jax_model.apply(jax_params, jnp.asarray(z_hat),
                            method=jax_bmshj2018.BMSHJ2018Model.sigma_from_zhat)
    x_hat = jax_model.apply(jax_params, jnp.asarray(y_hat),
                            method=jax_bmshj2018.BMSHJ2018Model.synthesize)
    with torch.no_grad():
        ty, tz = model.encode_latents(torch.from_numpy(x))
        tsigma = model.sigma_from_zhat(torch.from_numpy(z_hat))
        tx_hat = model.synthesize(torch.from_numpy(y_hat))
    for got, want in ((ty, y), (tz, z), (tsigma, sigma), (tx_hat, x_hat)):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


# -- small codec: round trip and cross-package blobs ----------------------


@pytest.fixture(scope="module")
def small_models():
    """A random small-width JAX model and the port's copy of it."""
    cfg = jax_bmshj2018.Config(**SMALL)
    jax_model = jax_bmshj2018.BMSHJ2018Model(cfg)
    params = jax_model.init(jax.random.PRNGKey(3), jnp.zeros((1, 64, 64, 3)),
                            jax.random.PRNGKey(4), training=True)
    blob = serialization.to_bytes({"params": params, "step": 0})
    model = bmshj2018.BMSHJ2018Model(bmshj2018.Config(**SMALL))
    model.load_state_dict(convert.params_from_numpy(convert.unpack_msgpack(blob)))
    return jax_model, params, model


def test_small_codec_round_trip_on_cpu(small_models):
    _, _, model = small_models
    codec = bmshj2018.Codec(model, device="cpu")
    images = _structured_images(3, 70, 100, seed=1)  # padded to 128x128
    blobs = codec.compress_batch(images)
    out = codec.decompress_batch(blobs)
    assert out.shape == images.shape and out.dtype == np.uint8
    # The decode is exactly the synthesis of the encoder's rounded latents.
    from compression_tpu_torch.util.image import pad_to_multiple_np

    x, _ = pad_to_multiple_np(images, 64)
    with torch.no_grad():
        y, _ = model.encode_latents(torch.from_numpy(x).float() / 255.0)
        want = torch.clamp(torch.round(model.synthesize(torch.round(y)) * 255.0), 0, 255)
    np.testing.assert_array_equal(out, want.to(torch.uint8).numpy()[:, :70, :100])
    assert codec.compress_batch(images) == blobs  # deterministic
    np.testing.assert_array_equal(codec.decompress(blobs[1]), out[1])
    batches = [images[:2], images[2:]]
    iter_blobs = list(codec.compress_iter(batches))
    assert iter_blobs[0] + iter_blobs[1] == blobs
    decoded = np.concatenate(list(codec.decompress_iter(iter_blobs)))
    np.testing.assert_array_equal(decoded, out)
    assert "enc/code_y" in codec.timer.report()


def test_blobs_cross_decode_both_ways_on_pinned_tables(small_models):
    jax_model, params, model = small_models
    jax_codec = jax_bmshj2018.Codec(jax_model, params)
    # Pinned tables: the float32 root-find offsets may differ in the last
    # bits between the packages (see test_torch_entropy.py).
    tables = {"side": jax_codec.side_em.tables, "main": jax_codec.em.tables}
    codec = bmshj2018.Codec(model, device="cpu", tables=tables)
    images = _structured_images(2, 64, 128, seed=2)

    # First: both packages derive the same symbols and CDF rows.
    jy8, jy16, jz16, jz_hat, _, jy, jz = jax_codec._front(jax_codec._p, jnp.asarray(images))
    jrows = jax_codec.em.rows(jax_codec._sigma(jz_hat))
    with torch.inference_mode():
        ty, tz, tz_hat = codec._front(torch.from_numpy(images))
        trows = codec._rows(tz_hat)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(tz_hat.numpy(), np.asarray(jz_hat))
    np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows))

    ours = codec.compress_batch(images)
    theirs = jax_codec.compress_batch(images)
    assert ours == theirs  # byte-identical blobs
    for blob in ours:
        assert JaxPackedTensors(blob).model == "bmshj2018-hyperprior"
    by_jax = jax_codec.decompress_batch(ours)
    by_port = codec.decompress_batch(theirs)
    assert by_jax.shape == by_port.shape == images.shape
    # Same symbols in, float32 synthesis out: XLA's and torch's convolutions
    # round differently, so a pixel may land one level apart.
    diff = np.abs(by_jax.astype(np.int16) - by_port.astype(np.int16))
    assert diff.max() <= 1 and np.mean(diff == 0) > 0.99


def _fields(blob):
    return [k for k, *_ in JaxPackedTensors(blob).describe() if k != "MD"]


def test_device_blobs_byte_identical_and_cross_decode_on_pinned_tables(small_models):
    jax_model, params, model = small_models
    jax_codec = jax_bmshj2018.Codec(jax_model, params)
    tables = {"side": jax_codec.side_em.tables, "main": jax_codec.em.tables}
    codec = bmshj2018.Codec(model, device="cpu", tables=tables)
    images = _structured_images(2, 64, 128, seed=2)

    ours = codec.compress_batch(images, coder="device")
    theirs = jax_codec.compress_batch(images, coder="device")
    assert ours == theirs  # byte-identical 5-field blobs
    for blob in ours:
        assert len(_fields(blob)) == 5
        assert JaxPackedTensors(blob).model == "bmshj2018-hyperprior"
    by_jax = jax_codec.decompress_batch(ours)
    by_port = codec.decompress_batch(theirs)
    # Within each package the device-coded decode is exactly the host-coded
    # one (same symbols, same synthesis).
    np.testing.assert_array_equal(
        by_port, codec.decompress_batch(codec.compress_batch(images)))
    np.testing.assert_array_equal(
        by_jax, jax_codec.decompress_batch(jax_codec.compress_batch(images)))
    diff = np.abs(by_jax.astype(np.int16) - by_port.astype(np.int16))
    assert diff.max() <= 1 and np.mean(diff == 0) > 0.99


def test_device_coded_round_trip_iterators_and_rejections(small_models):
    codec = bmshj2018.Codec(small_models[2], device="cpu")
    images = _structured_images(3, 70, 100, seed=5)  # padded to 128x128
    host = codec.compress_batch(images)
    dev = codec.compress_batch(images, coder="device")
    assert all(len(_fields(b)) == 5 for b in dev)
    assert not any(len(_fields(b)) == 5 for b in host)
    ref = codec.decompress_batch(host)
    np.testing.assert_array_equal(codec.decompress_batch(dev), ref)
    assert codec.compress_batch(images, coder="device") == dev  # deterministic
    np.testing.assert_array_equal(codec.decompress(dev[1]), ref[1])
    for b_host, b_dev in zip(host, dev):  # compact: rANS pays only lane states
        hp, dp = JaxPackedTensors(b_host), JaxPackedTensors(b_dev)
        K = int(dp.unpack_one(4, np.int32)[0])
        assert len(dp.unpack_one(0, object)[0]) <= (
            len(hp.unpack_one(0, object)[0]) * 1.1 + 4 * K + 16)

    piped = list(codec.compress_iter([images[:2], images[2:]], coder="device"))
    assert piped[0] + piped[1] == dev
    mixed_batches = [dev[:2], host[2:]]  # the format is detected per batch
    np.testing.assert_array_equal(
        np.concatenate(list(codec.decompress_iter(mixed_batches))), ref)
    assert "enc/fetch_stream" in codec.timer.report()

    with pytest.raises(ValueError, match="cannot mix"):
        codec.decompress_batch([host[0], dev[1]])
    with pytest.raises(ValueError, match="cannot mix"):
        codec.decompress_batch([dev[0], host[1]])
    other = codec.compress_batch(_structured_images(1, 64, 64), coder="device")
    with pytest.raises(ValueError, match="same-size"):
        codec.decompress_batch([dev[0], other[0]])
    with pytest.raises(ValueError, match="unknown coder"):
        codec.compress_batch(images, coder="gpu")


def test_device_coder_falls_back_to_the_host_coder_on_overflow(small_models):
    from compression_tpu_torch.codec import rans
    from compression_tpu_torch.models import device_coding

    codec = bmshj2018.Codec(small_models[2], device="cpu")
    images = _structured_images(2, 64, 64, seed=6)
    N = 4 * 4 * SMALL["num_latents"]
    enc, dec, K, _cap = device_coding.rans_for(codec, N)
    codec._rans_cache[(N, K)] = (rans.make_rans_encoder(codec.em.tables, K, 8),
                                 dec, K, 8)
    blobs = codec.compress_batch(images, coder="device")
    assert blobs == codec.compress_batch(images)  # host-coded, 4 fields


def test_corrupt_device_stream_raises(small_models):
    codec = bmshj2018.Codec(small_models[2], device="cpu")
    blob = codec.compress(_structured_images(1, 64, 64, seed=7)[0], coder="device")
    packed = JaxPackedTensors(blob)
    fields = packed.unpack([object, object, np.int32, np.int32, np.int32])
    words = bytearray(bytes(fields[0][0]))
    words[len(words) // 2] ^= 0xFF
    bad = JaxPackedTensors()
    bad.model = packed.model
    bad.pack([bytes(words), bytes(fields[1][0])] + [np.asarray(f) for f in fields[2:]])
    with pytest.raises(ValueError, match="rANS"):
        codec.decompress(bad.string)


def test_cuda_is_the_default_and_missing_cuda_raises(small_models):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the test is for hosts without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bmshj2018.Codec(small_models[2])


# -- the port stands alone ------------------------------------------------

_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|flax|optax|msgpack)\b|compression_tpu\.", re.M
)


def test_port_never_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "compression_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    hits = []
    for path in files:
        for m in _FORBIDDEN.finditer(path.read_text()):
            line = path.read_text()[: m.start()].count("\n") + 1
            hits.append(f"{path.relative_to(ROOT)}:{line}: {m.group(0).strip()}")
    assert len(files) > 20 and not hits, hits
    names = {path.relative_to(ROOT).as_posix() for path in files}
    for module in ("bls2017", "mbt2018", "b2018", "ms2020", "codec_base", "device_coding"):
        assert f"compression_tpu_torch/models/{module}.py" in names
    assert "compression_tpu_torch/parallel/charm_pipeline.py" in names
    for module in ("cli/tfci", "cli/registry", "models/codec_cache"):
        assert f"compression_tpu_torch/{module}.py" in names
