"""The control of ``correct`` on the card, at a size a test run holds: the
reference computed in TF32 in the program's place must fail at least one
of each cell's limits, on three seeds, and so must each fault that
``benchmark/control.py`` reads. ``benchmark/control.py`` reads the
same at the cells' own sizes."""

import pytest

from benchmark import control, harness

CELLS = {w["name"]: w for w in harness.manifest()["workloads"]}


def small(cell):
    wl = harness.load_json(harness.HERE / "workloads" / f"{cell}.json")
    cfg = harness.load_json(harness.HERE / "configs" / f"{CELLS[cell]['config']}.json")
    t = wl["traffic"]
    if wl["driver"] == "train_step":
        t.update(batch=4, patch=128, pool=8)
    else:
        t.update(batch=2, height=256, width=384, pool=4)
    return wl, cfg


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("seed", [3, 4294967296 + 5, 2**31 + 7])
def test_the_control_fails_a_limit(card, cell, seed):
    wl, cfg = small(cell)
    readings = (control.training_readings if wl["driver"] == "train_step"
                else control.codec_readings)(cfg, wl, seed, card)
    limits = wl["correct"]["limits"]
    for name in readings:
        assert any(readings[name].get(k, 0.0) > v for k, v in limits.items()), (name, readings[name])
