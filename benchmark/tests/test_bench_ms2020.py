"""ms2020-cc10 (CHARM) in the harness before it has a cell. Its y is coded
in 10 slices, each conditioned on the slices decoded before it, one y
stream a slice in its blobs. On the CPU at small widths (y 20 channels
deep, the supports and the slices' networks as published), with weights
drawn from the seed: the reference's chain against the port's, slice by
slice; the port's blobs read back by the judge; and whole runs of a cell
that exists only in a patched manifest, as a configuration, a workload and
a ``BENCHMARK.json`` entry would make it, sound and under each fault the
cell can have. On the card, the judge's readings at the published widths
(the first sound readings, from which the cell's limits are set)."""

import contextlib
import copy
import io
import json
import math

import numpy as np
import pytest
import torch

from benchmark import control, harness, judge, program, run, weights
from benchmark.reference.codec import ReferenceCodec
from benchmark.reference.families import ms2020 as ref
from benchmark.tests.test_bench_faults import shrink, small
from benchmark.traffic import images

PUBLISHED = {"num_filters": 192, "num_latents": 320, "num_hyperlatents": 192}


def config(widths=PUBLISHED):
    return {"name": "ms2020-cc10", "family": "ms2020", "widths": dict(widths),
            "weights": {"origin": "seed"}, "precision": "float32 with TF32 off",
            "program_config": {"model_name": "ms2020-cc10"}}


@pytest.fixture(scope="module")
def charm():
    cfg = shrink(config())
    flat = weights.load(cfg, 11, "cpu")
    codec = program.build_codec(cfg, program.build_model(cfg, flat), "cpu")
    return cfg, flat, codec, images.structured_pool(2, 128, 256, 11, "cpu")


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_the_slice_chain_matches_the_programs(charm):
    """Every stage from the same inputs (the port's y and z_hat), each side
    carrying its own decoded slices down the chain: supports, each slice's
    mu and sigma to 1e-5, its symbols exactly, each decoded slice with its
    LRP and the synthesis to 1e-5; then y, z, and the symbols of the port's
    encoder against the reference codec's, exactly."""
    cfg, flat, codec, pool = charm
    w, port = cfg["widths"], codec.model
    s = w["num_latents"] // ref.y_streams(w)
    x = torch.as_tensor(pool)
    with torch.no_grad():
        y, z = port.encode_latents(x.to(torch.float32) / 255.0)
        assert rel(ref.analysis(flat, x.to(torch.float32) / 255.0, w), y) < 1e-5
        assert rel(ref.hyper_analysis(flat, y, w), z) < 1e-5
        _y, _z_sym, z_hat = codec._front(x)
        for b in range(len(pool)):
            sups = port.supports_from_zhat(z_hat[b : b + 1])
            r_sups = ref.supports(flat, z_hat[b : b + 1])
            assert all(rel(r, p) < 1e-5 for r, p in zip(r_sups, sups))
            dec, r_dec = [], []
            for i in range(ref.y_streams(w)):
                mu, sigma = port.slice_params(i, *sups, dec)
                r_mu, r_sigma = ref.slice_params(flat, i, *r_sups, r_dec, w)
                assert rel(r_mu, mu) < 1e-5 and rel(r_sigma, sigma) < 1e-5, i
                y_i = y[b : b + 1, ..., i * s : (i + 1) * s]
                sym = codec._center_round(y_i, mu)
                r_sym = torch.round(y_i - r_mu).to(torch.int32)
                assert torch.equal(r_sym, sym), i
                y_hat = codec._apply_loc(sym, mu)
                dec.append(y_hat + port.slice_lrp(i, sups[0], dec + [y_hat]))
                r_hat = r_sym.to(torch.float32) + r_mu
                r_dec.append(r_hat + ref.slice_lrp(flat, i, r_sups[0], r_dec, r_hat, w))
                assert rel(r_dec[-1], dec[-1]) < 1e-5, i
            assert rel(ref.synthesis(flat, torch.cat(r_dec, -1), w),
                       port.synthesize(torch.cat(dec, -1))) < 1e-5
        syms, z_sym, _rows, _hw = codec._encode_slices(pool)
    exp = ReferenceCodec(cfg, flat, "cpu").expected(pool)
    assert exp.streams == (s,) * ref.y_streams(w)
    assert torch.equal(exp.z_symbols, z_sym)
    assert torch.equal(exp.y_symbols, torch.cat(syms, -1))
    assert exp.y_symbols.abs().max() > 0


@pytest.mark.parametrize("coder", ["device", "host"])
def test_the_judge_reads_the_programs_blobs(charm, coder):
    """z read back whole, every slice's words counted, and the streams'
    bits within 2e-3 of what the reference's symbols cost."""
    from compression_tpu_torch.models.device_coding import parse_blobs

    cfg, flat, codec, pool = charm
    blobs = codec.compress_batch(pool, coder)
    rc = ReferenceCodec(cfg, flat, "cpu")
    exp = rc.expected(pool)
    for i, blob in enumerate(blobs):
        assert np.array_equal(rc.z_from_blob(blob), exp.z_symbols[i].numpy())
    if coder == "device":
        streams = parse_blobs(blobs, rc.streams, True)[0]
        assert len(streams) == rc.streams == 10
        for i, blob in enumerate(blobs):
            assert judge.y_words(blob, rc.streams) == sum(len(st[i]) for st in streams)
    coded, expected = judge.y_rate(rc, exp, blobs)
    assert abs(coded - expected) / expected < 2e-3
    assert np.array_equal(codec.decompress_batch(blobs), exp.images.numpy())


CELL = "ms2020-cc10.kodak768-b8.{coder}"


def cell_files(coder):
    """What a later change adds for the cell, as data: its configuration,
    its workload (the bmshj2018 cell's traffic of the same coder at the
    CPU size, 128x256 so that ten range-coded streams' flushes average
    out) and the manifest with its entries."""
    twin = f"bmshj2018.kodak768-b8.{coder}"
    wl, _cfg = small(twin)
    wl = {**wl, "config": "ms2020-cc10"}
    wl["traffic"].update(height=128, width=256)
    man = copy.deepcopy(harness.manifest())
    man["configs"].append({"name": "ms2020-cc10", "source": "https://arxiv.org/abs/2007.08739",
                           "file": "benchmark/configs/ms2020-cc10.json", "reduced": ["weights"],
                           "why": "10 slices coded in turn"})
    man["workloads"].append({"name": CELL.format(coder=coder), "config": "ms2020-cc10",
                             "traffic": f"kodak768-b8.{coder}", "chips": 1,
                             "why": "the slice chain"})
    for m in man["end_to_end"] + man["per_layer"]:
        if twin in m.get("workloads", ()):
            m["workloads"].append(CELL.format(coder=coder))
    return wl, shrink(config()), man


@pytest.mark.parametrize("fault", [None, "half_batch", "altered_answer", "sigma_doubled"])
@pytest.mark.parametrize("coder", ["device", "host"])
def test_a_cell_added_as_data_runs_and_a_fault_turns_it_false(monkeypatch, coder, fault):
    wl, cfg, man = cell_files(coder)
    monkeypatch.setattr(harness, "manifest", lambda: man)
    torch.manual_seed(0)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", CELL.format(coder=coder), "--seed", "4294967399",
                       "--seconds", "0.2"], device=torch.device("cpu"), workload=wl,
                      config=cfg, faults=() if fault is None else (fault,))
    assert rc == 0, err.getvalue()[-2000:]
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert result["correct"] is (fault is None), err.getvalue()[-2000:]
    assert set(result["checks"]) == set(wl["correct"]["limits"])
    if fault is None:
        assert set(result["metrics"]) == {
            m["name"] for m in man["end_to_end"]
            if CELL.format(coder=coder) in m.get("workloads", [CELL.format(coder=coder)])}


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [3, 2**31 + 7, 4294967296 + 5])
def test_the_judge_on_the_card_at_the_published_widths(card, seed):
    """16 seeded 768x512 images through the device coder in two batches of
    8, judged as a codec cell judges its sample; and the control (the
    reference in TF32 in the program's place) and the fault of sigma about
    doubled, read by ``benchmark/control.py``. Prints the readings."""
    cfg = config()
    flat = weights.load(cfg, seed, card)
    codec = program.build_codec(cfg, program.build_model(cfg, flat), card)
    pool = images.structured_pool(16, 512, 768, seed, card)
    batches = [pool[:8], pool[8:]]
    blobs = list(codec.compress_iter(batches, 2, "device"))
    decoded = list(codec.decompress_iter(blobs, 2))
    assert [d.shape for d in decoded] == [b.shape for b in batches]
    items = list(zip(batches, blobs, decoded))
    del codec
    torch.cuda.empty_cache()
    limits = dict.fromkeys(("pixels_off", "z_off", "y_rate_gap"), 1.0)
    checks, notes = judge.codec(cfg, flat, card, items, {"correct": {"limits": limits}})
    wl = {"traffic": {"batch": 8, "height": 512, "width": 768, "pool": 16, "coder": "device"},
          "correct": {"sample_batches": 2}}
    readings = control.codec_readings(cfg, wl, seed, card)
    numbers = {c.name: c.value for c in checks}
    print(json.dumps({"seed": seed, "sound": numbers, **readings}))
    print("\n".join(notes))
    assert all(math.isfinite(v) for v in numbers.values())
