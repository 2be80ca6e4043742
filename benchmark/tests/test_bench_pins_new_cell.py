"""A cell that a change adds as files alone (its workload, its
configuration, its ``BENCHMARK.json`` entries and its two pins files) is
found and checked by ``test_bench_pins`` as that file stands. Here
ms2020-cc10's device-coder cell, in a patched manifest and a copy of the
benchmark's data directories; its pins were read on the CPU (torch 2.13) at
``test_bench_faults``' small size and seed. A pin one unit in the last
place off fails, and so does a cell or a configuration without its pins
file."""

import json
import math
import shutil

import pytest

from benchmark import harness
from benchmark.tests import test_bench_ms2020 as ms2020
from benchmark.tests import test_bench_pins as pinning

CELL = "ms2020-cc10.kodak768-b8.device"
CONFIG = "ms2020-cc10"
CHECKS = {"pixels_off": 0.0, "z_off": 0.0, "y_rate_gap": 0.00014226931279131264}
COUNTS = {
    "compress": {"model_flops": 3064697192448.0, "conv_roofline_at_1s": 4.459703280716417},
    "decompress": {"model_flops": 3027577602048.0, "conv_roofline_at_1s": 4.404300906985075},
    "train": {"model_flops": 1827387998208.0, "conv_roofline_at_1s": 0.870991046686567},
}


def write(path, value):
    path.write_text(json.dumps(value, indent=1) + "\n")


@pytest.fixture
def added(monkeypatch, tmp_path):
    """The benchmark's workloads, configurations and pins copied, with the
    new cell's files added, and the manifest with its entries."""
    for d in ("workloads", "configs", "pins"):
        shutil.copytree(harness.HERE / d, tmp_path / d)
    wl = harness.load_json(harness.HERE / "workloads" / "bmshj2018.kodak768-b8.device.json")
    write(tmp_path / "workloads" / f"{CELL}.json", {**wl, "config": CONFIG})
    write(tmp_path / "configs" / f"{CONFIG}.json", ms2020.config())
    write(tmp_path / "pins" / "cells" / f"{CELL}.json", CHECKS)
    write(tmp_path / "pins" / "configs" / f"{CONFIG}.json", COUNTS)
    _wl, _cfg, man = ms2020.cell_files("device")
    monkeypatch.setattr(harness, "manifest", lambda: man)
    monkeypatch.setattr(pinning, "HERE", tmp_path)
    return tmp_path


def test_the_new_cell_and_configuration_are_found(added):
    assert CELL in pinning.pinned("cells")
    assert [p for n, p in pinning.counted() if n == CONFIG] == sorted(COUNTS)
    pinning.test_every_cell_is_pinned()
    pinning.test_every_configuration_is_pinned()


def test_the_new_cells_pins_are_checked(added):
    pinning.test_a_cells_checks_are_the_parents(CELL)
    for name, phase in pinning.counted():
        pinning.test_the_flops_and_conv_bounds_are_the_parents(name, phase)


@pytest.mark.parametrize("kind", ["cells", "configs"])
def test_a_pin_one_ulp_off_fails(added, kind):
    if kind == "cells":
        wrong = {**CHECKS, "y_rate_gap": math.nextafter(CHECKS["y_rate_gap"], 1.0)}
        write(added / "pins" / "cells" / f"{CELL}.json", wrong)
        with pytest.raises(AssertionError):
            pinning.test_a_cells_checks_are_the_parents(CELL)
    else:
        flops = COUNTS["decompress"]["model_flops"]
        wrong = {**COUNTS, "decompress": {**COUNTS["decompress"],
                                          "model_flops": math.nextafter(flops, math.inf)}}
        write(added / "pins" / "configs" / f"{CONFIG}.json", wrong)
        with pytest.raises(AssertionError):
            pinning.test_the_flops_and_conv_bounds_are_the_parents(CONFIG, "decompress")


@pytest.mark.parametrize("kind,name", [("cells", CELL), ("configs", CONFIG)])
def test_a_missing_pins_file_fails(added, kind, name):
    (added / "pins" / kind / f"{name}.json").unlink()
    check = (pinning.test_every_cell_is_pinned if kind == "cells"
             else pinning.test_every_configuration_is_pinned)
    with pytest.raises(AssertionError):
        check()
