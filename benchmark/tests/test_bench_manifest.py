"""BENCHMARK.json against the benchmark's contract, and every file it
names: names and units in their character sets, each per-layer metric's
cells reporting the end-to-end metric it moves, each workload file naming a
configuration and a driver that exist, and the check's time budget."""

import json
import pathlib
import re

import pytest

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = {w["name"]: w for w in MAN["workloads"]}
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def load(path):
    return json.loads(path.read_text())


def reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entries():
    names = [m["name"] for m in METRICS] + list(CELLS) + [c["name"] for c in MAN["configs"]]
    assert all(NAME.match(n) for n in names), names
    for group in (METRICS, MAN["workloads"], MAN["configs"]):
        assert len({e["name"] for e in group}) == len(group)
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for cell in CELLS:
        reported = [m for m in e2e.values() if reports(m, cell)]
        assert len(reported) >= 2  # setup_s and one more


def test_every_per_layer_metric_moves_what_its_cells_report():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    layers = set()
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        layers.add(m["layer"])
        for cell in m["workloads"]:
            assert cell in CELLS
            assert reports(e2e[m["moves"]], cell), (m["name"], cell)
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    for cell in CELLS:
        assert any(reports(m, cell) for m in MAN["per_layer"]), cell
    # A kernel's roofline metrics stand beside the whole step's share of the peak.
    for m in MAN["per_layer"]:
        if "_roofline" in m["name"]:
            assert any("mfu" in o["name"] and o["moves"] == m["moves"] for o in MAN["per_layer"])


def test_run_seconds_fits_a_full_check_of_24_cells():
    seconds = MAN["run_seconds"]
    assert isinstance(seconds, int) and 1 <= seconds <= 51
    runs = 2 + 14 * 24
    assert runs * (seconds + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_each_cell_finds_its_files(cell):
    w = CELLS[cell]
    wl = load(BENCH / "workloads" / f"{cell}.json")
    assert wl["config"] == w["config"] and wl["chips"] == w["chips"]
    assert (BENCH / "drivers" / f"{wl['driver']}.py").exists()
    cfg = load(BENCH / "configs" / f"{w['config']}.json")
    assert cfg["name"] == w["config"]
    assert wl["correct"]["limits"] and all(v >= 0 for v in wl["correct"]["limits"].values())
    for m in MAN["per_layer"]:
        if reports(m, cell):
            assert (BENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]


@pytest.mark.parametrize("config", MAN["configs"], ids=lambda c: c["name"])
def test_each_configuration(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["file"].startswith("benchmark/") and (ROOT / config["file"]).exists()
    assert 1 <= len(config["source"]) <= 200 and config["source"].startswith("https://")
    assert len(config["reduced"]) <= 16 and all(NAME.match(k) for k in config["reduced"])
    assert config["name"] in {w["config"] for w in MAN["workloads"]}
    cfg = load(ROOT / config["file"])
    assert cfg["reduced"] == config["reduced"] and cfg["source"] == config["source"]
    widths = ("filters", "latents", "hyperlatents", "_dim", "_rank")
    assert not any(any(w in k for w in widths) for k in config["reduced"])
    # The configuration's family is found by name on both sides.
    assert (BENCH / "families" / f"{cfg['family']}.py").exists()
    assert (BENCH / "reference" / "families" / f"{cfg['family']}.py").exists()


def test_an_unknown_family_is_refused():
    from benchmark import program, weights
    from benchmark.reference import models

    cfg = {"family": "no-such-family", "widths": {}, "weights": {"origin": "seed"}}
    for build in (lambda: program.family(cfg), lambda: models.Transforms(cfg),
                  lambda: weights.load(cfg, 0, "cpu")):
        with pytest.raises(ValueError, match="no-such-family"):
            build()


def test_paths_hold_only_benchmark_files_and_names():
    for path in BENCH.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert len(rel) <= 200 and re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
