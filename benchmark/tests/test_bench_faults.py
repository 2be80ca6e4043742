"""A whole run of each cell on the CPU at a small size, with the harness's
look for a card skipped and the timed path broken underneath: each fault a
cell can have must turn ``correct`` false, and the sound run must read
true. Faults: half of each batch left out (the codec's blobs, the training
batch); an answer altered where it is produced (a byte of each batch's
first blob); sigma about doubled on both sides of the codec (each CDF row
six levels up), which the round trip does not show; a step that leaves the
training state unchanged, from the start or only in the window."""

import contextlib
import io
import json

import pytest
import torch

from benchmark import harness, run
from benchmark.reference import models

CELLS = {w["name"]: w for w in harness.manifest()["workloads"]}
CASES = [(cell, fault)
         for cell in sorted(CELLS)
         for fault in ((None, "half_batch", "state_unchanged", "window_state_unchanged")
                       if "train" in cell
                       else (None, "half_batch", "altered_answer", "sigma_doubled"))]


def small(cell):
    wl = harness.load_json(harness.HERE / "workloads" / f"{cell}.json")
    cfg = harness.load_json(harness.HERE / "configs" / f"{CELLS[cell]['config']}.json")
    return cpu_size(wl, cfg)


def cpu_size(wl, cfg):
    """A cell's workload and configuration at the CPU tests' small size."""
    t = wl["traffic"]
    if wl["driver"] == "train_step":
        t.update(batch=2, patch=64, height=96, width=128, pool=4, warmup_steps=4, traced_steps=2)
    else:
        t.update(batch=2, height=64, width=128, round_batches=3, pool=5, warmup_batches=2)
    return wl, shrink(cfg)


def shrink(cfg):
    """``cfg`` at the widths its family's file gives the CPU tests, if any."""
    fam = models.family(cfg)
    if hasattr(fam, "small_widths"):
        cfg["widths"] = fam.small_widths(cfg["widths"])
    return cfg


@pytest.mark.parametrize("cell,fault", CASES, ids=lambda v: str(v))
def test_a_fault_turns_correct_false(cell, fault):
    torch.manual_seed(0)
    wl, cfg = small(cell)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", "4294967391", "--seconds", "0.2"],
                      device=torch.device("cpu"), workload=wl, config=cfg,
                      faults=() if fault is None else (fault,))
    assert rc == 0, err.getvalue()[-2000:]
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert result["correct"] is (fault is None), err.getvalue()[-2000:]
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(wl["correct"]["limits"])
    if fault is None:  # every end-to-end metric of the cell, under its own name
        assert set(result["metrics"]) == {m["name"] for m in harness.manifest()["end_to_end"]
                                          if cell in m.get("workloads", [cell])}
