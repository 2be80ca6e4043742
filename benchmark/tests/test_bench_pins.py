"""What the benchmark's cells judge and count, pinned to the bit: a change
to the harness that lets another family in must leave every number of the
cells that are there as it was.

The pins are files, found by name. ``pins/cells/<cell>.json`` holds the
checks a cell reads when it runs once on the CPU at ``test_bench_faults``'
small size and seed, with a window short enough for one round, so that the
sample it judges is fixed. ``pins/configs/<config>.json`` holds, by phase,
the configuration's model FLOPs and its convolutions' roofline reading
with 1 s of convolution device time, at the cells' sizes (8 images of
768x512 a codec call, 8 crops of 256x256 a training step). A change that
adds a cell or a configuration adds its pins file, with the numbers read
on its own tree (torch on the CPU); nothing here names a cell. The four
first cells' numbers were read from the harness before y models and blob
layouts by family came in (torch 2.13, CPU)."""

import contextlib
import io
import json

import pytest
import torch

from benchmark import harness, readers, run
from benchmark.roofline import models
from benchmark.tests.test_bench_faults import cpu_size

HERE = harness.HERE  # where the cells' workloads, configurations and pins are found


def pinned(kind: str):
    """The names that ``pins/<kind>/`` holds a file for."""
    return sorted(p.name[: -len(".json")] for p in (HERE / "pins" / kind).glob("*.json"))


def pins(kind: str, name: str) -> dict:
    return harness.load_json(HERE / "pins" / kind / f"{name}.json")


def counted():
    """(configuration, phase) of every configuration's pins."""
    return [(name, phase) for name in pinned("configs") for phase in sorted(pins("configs", name))]


def test_every_cell_is_pinned():
    assert set(pinned("cells")) == {w["name"] for w in harness.manifest()["workloads"]}


def test_every_configuration_is_pinned():
    assert set(pinned("configs")) == {c["name"] for c in harness.manifest()["configs"]}


@pytest.mark.parametrize("cell", pinned("cells"))
def test_a_cells_checks_are_the_parents(cell):
    torch.manual_seed(0)
    entry = next(w for w in harness.manifest()["workloads"] if w["name"] == cell)
    wl, cfg = cpu_size(harness.load_json(HERE / "workloads" / f"{cell}.json"),
                       harness.load_json(HERE / "configs" / f"{entry['config']}.json"))
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", "4294967391", "--seconds", "0.01"],
                      device=torch.device("cpu"), workload=wl, config=cfg)
    assert rc == 0, err.getvalue()[-2000:]
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert {k: v["value"] for k, v in result["checks"].items()} == pins("cells", cell)


class _Phase:
    """A traced phase whose convolutions took 1 s of device time."""
    activities, wall_s, busy_s = 1, 1.0, 1.0
    by_kind_s = {"conv_forward": 1.0}


@pytest.mark.parametrize("name,phase", counted())
def test_the_flops_and_conv_bounds_are_the_parents(name, phase):
    cfg = harness.load_json(HERE / "configs" / f"{name}.json")
    n, h, w = (8, 256, 256) if phase == "train" else (8, 512, 768)
    record = {"cfg": cfg, "phases": {phase: _Phase()}, "phase_steps": {"train": 1},
              "traffic": {"batch": n, "height": h, "width": w, "patch": h, "round_batches": 1}}
    want = pins("configs", name)[phase]
    assert (models.model_flops(cfg, phase, n, h, w), readers.conv_roofline(record, phase)) == \
        (want["model_flops"], want["conv_roofline_at_1s"])
