"""The port's table disk cache and codec cache
(``compression_tpu_torch/models/codec_cache.py``), the table files both
packages read, and the PNG codec the CLI uses where there is no PIL
(``compression_tpu_torch/util/image.py``), held against PIL here."""

import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from compression_tpu.entropy_models import continuous_base as jax_base
from compression_tpu_torch.entropy_models import continuous_base
from compression_tpu_torch.models import bmshj2018, codec_cache, common
from compression_tpu_torch.util import image as image_util

TABLE_FIELDS = ("cdf", "cdf_length", "cdf_offset", "offset", "precision")


def _tiny_bmshj2018():
    return bmshj2018.BMSHJ2018Model(bmshj2018.Config(
        num_filters=8, num_latents=8, num_hyperlatents=4), seed=3)


def _assert_tables_equal(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        for field in TABLE_FIELDS:
            np.testing.assert_array_equal(getattr(got[name], field),
                                          getattr(want[name], field))


def test_each_package_reads_the_others_table_file(tmp_path):
    codec = bmshj2018.Codec(_tiny_bmshj2018(), device="cpu")
    tables = {"side": codec.side_em.tables, "main": codec.em.tables}
    continuous_base.save_tables(str(tmp_path / "port.npz"), tables)
    _assert_tables_equal(jax_base.load_tables(str(tmp_path / "port.npz")), tables)
    jax_tables = {name: jax_base.CdfTables(**{f: getattr(t, f) for f in TABLE_FIELDS})
                  for name, t in tables.items()}
    jax_base.save_tables(str(tmp_path / "jax.npz"), jax_tables)
    _assert_tables_equal(continuous_base.load_tables(str(tmp_path / "jax.npz")), tables)
    with np.load(tmp_path / "port.npz") as ours, np.load(tmp_path / "jax.npz") as theirs:
        assert sorted(ours.files) == sorted(theirs.files)
        for key in ours.files:
            assert ours[key].dtype == theirs[key].dtype, key
    assert sorted(os.listdir(tmp_path)) == ["jax.npz", "port.npz"]  # no temporaries left


def test_table_file_follows_the_checkpoint(tmp_path, monkeypatch):
    """The CLI binds ``<ckpt>.<mtime_ns>.<size>.tables.npz``: the first
    compress writes it, the next loads it, and a checkpoint with a new
    mtime gets a new file."""
    from compression_tpu_torch.cli import registry
    from compression_tpu_torch.cli.tfci import main

    monkeypatch.setenv("TPC_TINY_MODELS", "1")
    monkeypatch.setenv("TPC_MODEL_DIR", str(tmp_path / "models"))
    monkeypatch.delenv("TPC_TABLE_CACHE_FILE", raising=False)
    png = str(tmp_path / "in.png")
    image_util.write_png(png, np.random.RandomState(0).randint(0, 256, (48, 64, 3), np.uint8))
    cli = ["--device", "cpu"]
    assert main(cli + ["train", "b2018", "--steps", "1", "--batch-size", "2",
                       "--patch-size", "32"]) == 0
    ckpt = registry.checkpoint_path("b2018-gdn-128")

    def table_file():
        st = os.stat(ckpt)
        return f"{ckpt}.{st.st_mtime_ns}.{st.st_size}.tables.npz"

    compress = cli + ["compress", "b2018-gdn-128-2", png, str(tmp_path / "a.tfci")]
    assert main(compress) == 0
    first = table_file()
    before = os.stat(first)
    assert main(compress) == 0
    after = os.stat(first)
    assert (after.st_ino, after.st_mtime_ns) == (before.st_ino, before.st_mtime_ns)
    st = os.stat(ckpt)
    os.utime(ckpt, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    assert main(compress) == 0
    assert table_file() != first and os.path.exists(table_file())
    _assert_tables_equal(continuous_base.load_tables(table_file()),
                         continuous_base.load_tables(first))


def test_make_codec_is_rebuilt_after_an_optimizer_step(tmp_path, monkeypatch):
    """A module keeps its identity through an optimizer step: the codec
    cache and the table file's binding key on its tensors' versions too."""
    monkeypatch.delenv("TPC_TABLE_CACHE_FILE", raising=False)
    model = _tiny_bmshj2018()
    path = str(tmp_path / "tables.npz")
    codec_cache.register_table_cache(model, path)
    codec = bmshj2018.make_codec(model, device="cpu")
    assert bmshj2018.make_codec(model, device="cpu") is codec
    assert os.path.exists(path)
    os.remove(path)

    cfg = common.TrainConfig(batch_size=2, patch_size=64)
    optimizer = common.make_optimizer(model, cfg)
    batch = torch.from_numpy(next(common.crop_dataset(cfg)))
    common.train_step(model.train(), optimizer, bmshj2018.make_loss_fn(model), batch,
                      torch.Generator().manual_seed(0), common.lr_schedule(cfg))
    fresh = bmshj2018.make_codec(model, device="cpu")
    assert fresh is not codec
    assert not os.path.exists(path)  # the binding was to the old weights
    assert bmshj2018.make_codec(model, device="cpu") is fresh
    codec_cache.invalidate(model)
    assert bmshj2018.make_codec(model, device="cpu") is not fresh


def test_table_cache_env_fallback(tmp_path, monkeypatch):
    """$TPC_TABLE_CACHE_FILE serves a model bound to no file."""
    path = str(tmp_path / "env.npz")
    monkeypatch.setenv("TPC_TABLE_CACHE_FILE", path)
    codec = bmshj2018.Codec(_tiny_bmshj2018(), device="cpu")
    assert os.path.exists(path)
    loaded = codec_cache.tables_via_disk(lambda: pytest.fail("rebuilt"))
    _assert_tables_equal(loaded, {"side": codec.side_em.tables, "main": codec.em.tables})


# -- PNG ----------------------------------------------------------------------


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _filtered_png(path, px, ctype, filters, palette=None):
    """Writes ``px`` (H, W, samples) uint8 with row r filtered by
    ``filters[r % len(filters)]``, the encoder's side of each PNG filter."""
    h, w, ch = px.shape
    rows = px.reshape(h, w * ch).astype(np.int32)
    prev = np.zeros(w * ch, np.int32)
    out = []
    for r in range(h):
        cur, kind = rows[r], filters[r % len(filters)]
        left = np.concatenate([np.zeros(ch, np.int32), cur[:-ch]])
        upleft = np.concatenate([np.zeros(ch, np.int32), prev[:-ch]])
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(np.concatenate([[kind], (cur - pred) % 256]).astype(np.uint8))
        prev = cur
    data = zlib.compress(np.concatenate(out).tobytes())
    chunks = [_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))]
    if palette is not None:
        chunks.append(_chunk(b"PLTE", palette.tobytes()))
    half = len(data) // 2  # image data split over two IDAT chunks
    chunks += [_chunk(b"IDAT", data[:half]), _chunk(b"IDAT", data[half:]),
               _chunk(b"IEND", b"")]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + b"".join(chunks))


@pytest.mark.parametrize("ctype", [0, 2, 3, 4, 6])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (4, 3, 2, 1, 0)])
def test_png_reader_matches_pil(tmp_path, ctype, filters):
    rng = np.random.RandomState(ctype * 10 + filters[0])
    samples = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    h, w = 13, 21
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = (xx * 9 + yy * 5)[..., None] + np.arange(samples) * 40
    px = np.where(rng.rand(h, w, samples) < 0.3, rng.randint(0, 256, (h, w, samples)),
                  smooth) % 256
    palette = None
    if ctype == 3:
        palette = rng.randint(0, 256, (40, 3)).astype(np.uint8)
        px = px % 40
    path = str(tmp_path / "f.png")
    _filtered_png(path, px.astype(np.uint8), ctype, filters, palette)
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGB"))
    got = image_util.read_png(path)
    assert got.dtype == np.uint8 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, want)


def test_png_writer_is_read_by_pil(tmp_path):
    image = np.random.RandomState(1).randint(0, 256, (37, 50, 3)).astype(np.uint8)
    path = str(tmp_path / "w.png")
    image_util.write_png(path, image)
    with Image.open(path) as im:
        assert im.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(im), image)
    np.testing.assert_array_equal(image_util.read_png(path), image)


def test_png_beyond_the_reader_goes_through_pil_or_raises(tmp_path, monkeypatch):
    image = np.random.RandomState(2).randint(0, 65536, (9, 11), np.uint16)
    path = str(tmp_path / "16bit.png")
    Image.fromarray(image).save(path)
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(image_util.read_png(path), want)
    jpeg = str(tmp_path / "x.jpg")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(jpeg)
    assert image_util.read_png(jpeg).shape == (8, 8, 3)

    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    with pytest.raises(ValueError, match="bit depth 16.*PIL.*not installed"):
        image_util.read_png(path)
    with pytest.raises(ValueError, match="not a PNG file"):
        image_util.read_png(jpeg)
    corrupt = bytearray(open(str(tmp_path / "16bit.png"), "rb").read())
    corrupt[20] ^= 0xFF  # inside IHDR: its CRC no longer holds
    (tmp_path / "bad.png").write_bytes(bytes(corrupt))
    with pytest.raises(ValueError, match="corrupt PNG chunk"):
        image_util.read_png(str(tmp_path / "bad.png"))
