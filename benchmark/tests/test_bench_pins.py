"""What the benchmark's four cells judge and count, pinned to the bit: a
change to the harness that lets another family in must leave every number
of the cells that are there as it was. Each cell runs once on the CPU at
``test_bench_faults``' small size and seed, with a window short enough for
one round, so that the sample it judges is fixed; its checks must equal
the literals, which were read from the harness before y models and blob
layouts by family came in (torch 2.13, CPU). The model FLOPs and the
convolutions' roofline bound of each configuration at the cells' sizes are
pinned likewise."""

import contextlib
import io
import json

import pytest
import torch

from benchmark import harness, readers, run
from benchmark.roofline import models
from benchmark.tests.test_bench_faults import small

CHECKS = {
    "bmshj2018.kodak768-b8.device": {
        "pixels_off": 5.0862630208333336e-05, "z_off": 0.0,
        "y_rate_gap": 6.472043342322021e-05},
    "bmshj2018.kodak768-b8.host": {
        "pixels_off": 5.0862630208333336e-05, "z_off": 0.0,
        "y_rate_gap": 0.00015471393805263655},
    "bmshj2018.train-b8-256": {
        "loss_gap": 8.170679857016073e-07, "grad_gap_median": 1.8673589847314896e-07,
        "change_gap_median": 1.7377569829441205e-07,
        "window_loss_gap": 2.4020672671314387e-07,
        "window_change_gap_median": 3.5275594062468986e-09},
    "hific-mi.kodak768-b8.device": {
        "pixels_off": 6.103515625e-05, "z_off": 0.0, "y_rate_gap": 0.00016349532935738863},
}

# (model FLOPs, 100 x the convolutions' least time in s) of a phase: 8
# images of 768x512 a codec call, 8 crops of 256x256 a training step.
COUNTS = {
    ("bmshj2018", "compress"): (604498821120.0, 0.7877654130626867),
    ("bmshj2018", "decompress"): (589739065344.0, 0.7657359268298507),
    ("bmshj2018", "train"): (589739065344.0, 0.25524530894328357),
    ("hific-mi", "compress"): (621922222080.0, 0.9244214715223881),
    ("hific-mi", "decompress"): (4257478656000.0, 6.348219957492537),
    ("hific-mi", "train"): (2402580848640.0, 1.193639446925373),
}


def test_every_cell_is_pinned():
    assert set(CHECKS) == {w["name"] for w in harness.manifest()["workloads"]}


@pytest.mark.parametrize("cell", sorted(CHECKS))
def test_a_cells_checks_are_the_parents(cell):
    torch.manual_seed(0)
    wl, cfg = small(cell)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", "4294967391", "--seconds", "0.01"],
                      device=torch.device("cpu"), workload=wl, config=cfg)
    assert rc == 0, err.getvalue()[-2000:]
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert {k: v["value"] for k, v in result["checks"].items()} == CHECKS[cell]


class _Phase:
    """A traced phase whose convolutions took 1 s of device time."""
    activities, wall_s, busy_s = 1, 1.0, 1.0
    by_kind_s = {"conv_forward": 1.0}


@pytest.mark.parametrize("name,phase", sorted(COUNTS))
def test_the_flops_and_conv_bounds_are_the_parents(name, phase):
    cfg = harness.load_json(harness.HERE / "configs" / f"{name}.json")
    n, h, w = (8, 256, 256) if phase == "train" else (8, 512, 768)
    record = {"cfg": cfg, "phases": {phase: _Phase()}, "phase_steps": {"train": 1},
              "traffic": {"batch": n, "height": h, "width": w, "patch": h, "round_batches": 1}}
    assert (models.model_flops(cfg, phase, n, h, w),
            readers.conv_roofline(record, phase)) == COUNTS[(name, phase)]
