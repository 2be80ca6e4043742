"""The reference against the program at small sizes on the CPU: the
transforms, the z tables and range decoder, the blob and checkpoint
readers, and a training step's loss and gradients. The reference must be
able to disagree with the program, so it shares no code with it; these
tests show that the two agree where they should."""

import json
import pathlib

import numpy as np
import pytest
import torch

from benchmark import weights
from benchmark.reference import entropy, formats, models, train
from benchmark.reference.codec import ReferenceCodec

BENCH = pathlib.Path(__file__).resolve().parent.parent
CKPT = BENCH.parent / "ckpt" / "bmshj2018.msgpack"


def config(name, **widths):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg["widths"].update(widths)
    return cfg


@pytest.fixture(scope="module")
def bmshj():
    from compression_tpu_torch.models import bmshj2018

    cfg = config("bmshj2018")
    flat = weights.load(cfg, 0, "cpu")
    return cfg, flat, bmshj2018.load_model(str(CKPT)).eval()


@pytest.fixture(scope="module")
def hific():
    from compression_tpu_torch.convert import params_from_numpy
    from compression_tpu_torch.models.hific import configs, model

    cfg = config("hific-mi", num_latents=8, num_hyperlatents=4, num_residual_blocks=1)
    flat = weights.load(cfg, 5, "cpu")
    base = configs.get_config("hific-mi")
    port = model.HificModel(configs.HificConfig(**{**base.__dict__, **cfg["widths"]}))
    port.load_state_dict(params_from_numpy(weights.to_tree(flat)))
    return cfg, flat, port.eval()


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_the_checkpoint_reader_matches_the_programs(bmshj):
    from compression_tpu_torch.convert import load_flax_msgpack, params_from_numpy

    _cfg, flat, port = bmshj
    state = params_from_numpy(load_flax_msgpack(str(CKPT)))
    assert len(flat) == len(state) == len(dict(port.named_parameters()))
    for name, value in state.items():
        key = "/".join(name.split(".")[:-1] + [{"weight": "kernel"}.get(name.split(".")[-1],
                                                                          name.split(".")[-1])])
        ours = flat[key]
        if value.ndim == 4:
            ours = ours.permute(3, 2, 0, 1)
        assert torch.equal(ours, value), name


def test_bmshj2018_transforms(bmshj):
    cfg, flat, port = bmshj
    t = models.Transforms(cfg)
    x = torch.rand(2, 64, 128, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        y, z = port.encode_latents(x)
        assert rel(t.analysis(flat, x), y) < 1e-5
        assert rel(t.hyper_analysis(flat, y), z) < 1e-5
        z_hat = torch.round(z)
        assert rel(t.hyper_synthesis(flat, z_hat)[1], port.sigma_from_zhat(z_hat)) < 1e-5
        y_hat = torch.round(y)
        assert rel(t.synthesis(flat, y_hat), port.synthesize(y_hat)) < 1e-5


def test_hific_transforms(hific):
    cfg, flat, port = hific
    t = models.Transforms(cfg)
    x = torch.rand(2, 64, 128, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        y, z = port.encode_latents(x)
        assert rel(t.analysis(flat, x), y) < 1e-5
        assert rel(t.hyper_analysis(flat, y), z) < 1e-5
        mu, sigma = port.params_from_zhat(4 * z)
        mu_r, sigma_r = t.hyper_synthesis(flat, 4 * z)
        assert rel(mu_r, mu) < 1e-5 and rel(sigma_r, sigma) < 1e-5
        assert rel(t.synthesis(flat, torch.round(y)), port.generate(torch.round(y))) < 1e-5


@pytest.mark.parametrize("which", ["bmshj", "hific"])
def test_the_z_tables_equal_the_programs(which, request):
    from compression_tpu_torch.entropy_models import ContinuousBatchedEntropyModel

    _cfg, flat, port = request.getfixturevalue(which)
    ours = entropy.FactorizedTables(entropy.prior_params(flat))
    theirs = ContinuousBatchedEntropyModel(port.hyperprior(device="cpu"), coding_rank=3).build_tables()
    assert np.array_equal(ours.offset, theirs.offset.astype(np.float32))
    assert np.array_equal(ours.cdf_offset, theirs.cdf_offset)
    for c, row in enumerate(ours.rows):
        assert row == theirs.cdf[c, : theirs.cdf_length[c]].tolist()


def test_the_y_tables_equal_the_programs():
    from compression_tpu_torch.distributions import NoisyNormal
    from compression_tpu_torch.entropy_models import LocationScaleIndexedEntropyModel

    ours = entropy.GaussianTables()
    theirs = LocationScaleIndexedEntropyModel(NoisyNormal, coding_rank=3,
                                              compression=True).tables
    assert np.array_equal(ours.cdf_offset, theirs.cdf_offset)
    for r, row in enumerate(ours.rows):
        assert row == theirs.cdf[r, : theirs.cdf_length[r]].tolist()


def test_the_y_bits_count_the_programs_host_stream(bmshj):
    """The reference's cost of y symbols, escapes included, against the
    length of the program's range-coded y stream of the same symbols and
    rows: within the coder's flush."""
    from compression_tpu_torch.distributions import NoisyNormal
    from compression_tpu_torch.entropy_models import LocationScaleIndexedEntropyModel

    em = LocationScaleIndexedEntropyModel(NoisyNormal, coding_rank=3, compression=True)
    g = torch.Generator().manual_seed(6)
    sigma = torch.exp(torch.rand(2, 8, 12, 16, generator=g) * 6 - 2.5)
    y = torch.round(torch.randn(2, 8, 12, 16, generator=g) * sigma * 1.5)
    y[0, 0, 0, :3] = torch.tensor([300.0, -500.0, 40.0])  # escapes
    strings = em.compress(y, sigma)
    tables = entropy.GaussianTables()
    bits = entropy.y_coded_bits(tables, y.to(torch.int64), entropy.scale_rows(sigma),
                                entropy.range_escape_bits)
    for b in range(2):
        assert abs(8 * len(strings[b]) - 36.0 - float(bits[b])) <= 8.0


def test_the_range_decoder_reads_the_programs_z_strings(bmshj):
    from compression_tpu_torch.entropy_models import ContinuousBatchedEntropyModel

    cfg, flat, port = bmshj
    em = ContinuousBatchedEntropyModel(port.hyperprior(device="cpu"), coding_rank=3,
                                       compression=True)
    rng = np.random.default_rng(3)
    symbols = rng.integers(-12, 13, size=(2, 2, 3, 128)).astype(np.int32)
    symbols[0, 0, 0, :4] = [40, -40, 200, -7]  # escapes
    strings = em.compress_symbols(symbols)
    ref = ReferenceCodec(cfg, flat, "cpu")
    index = np.tile(np.arange(128), 6)
    for b in range(2):
        got = entropy.decode_values(strings[b], ref.tables.rows, ref.tables.cdf_offset, index)
        assert np.array_equal(got.reshape(2, 3, 128), symbols[b])


def test_the_blob_reader_reads_the_programs_blobs():
    from compression_tpu_torch.util import PackedTensors

    packed = PackedTensors()
    packed.model = "bmshj2018-hyperprior"
    packed.pack([b"\x01\x02y", b"z\x00", np.array([512, 768], np.int32),
                 np.array([8, 12], np.int32), np.array([128], np.int32)])
    model, fields = formats.read_blob(packed.string)
    assert model == "bmshj2018-hyperprior"
    assert fields[0] == b"\x01\x02y" and fields[1] == b"z\x00"
    assert fields[2].tolist() == [512, 768] and fields[4].tolist() == [128]


def test_a_training_step_matches_the_programs(bmshj):
    from compression_tpu_torch.models import bmshj2018

    cfg, flat, _port = bmshj
    port = bmshj2018.load_model(str(CKPT)).train()
    loss_fn = bmshj2018.make_loss_fn(port)
    x = torch.randint(0, 256, (2, 64, 64, 3), generator=torch.Generator().manual_seed(4),
                      dtype=torch.uint8)
    loss = loss_fn(x.float() / 255.0, torch.Generator().manual_seed(9))[0]
    loss.backward()
    losses, grads, _, _ = train.run_steps(cfg, flat, [x], torch.Generator().manual_seed(9), 1)
    loss = float(loss.detach())
    assert abs(losses[0] - loss) <= 1e-5 * abs(loss)
    for name, p in port.named_parameters():
        key = name.replace(".", "/").replace("/weight", "/kernel")
        g = grads[key]
        if p.grad.ndim == 4:
            g = g.permute(3, 2, 0, 1)
        scale = max(float(p.grad.abs().max()), 1e-12)
        assert float((g - p.grad).abs().max()) <= 1e-3 * scale, name
