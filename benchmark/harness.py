"""What every driver shares: the manifest and the files it names, the run's
context, the checks that decide ``correct``, and the result line.

Everything a cell needs is found by name: ``BENCHMARK.json`` names the
cell, ``workloads/<cell>.json`` its configuration, driver and traffic,
``configs/<config>.json`` the configuration, ``drivers/<driver>.py`` the
code that runs it and ``metrics/<metric>.py`` the reader of each per-layer
metric.
"""

from __future__ import annotations

import importlib.util
import json
import math
import pathlib
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "compression_tpu")


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_module(path: pathlib.Path):
    """A module from a file whose name may hold dots (a metric's name)."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_file_" + path.stem.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Check:
    """One number compared with its limit: a run is correct only if every
    check's value is at most its limit."""
    name: str
    value: float
    limit: float

    def __post_init__(self):
        if not math.isfinite(self.value):  # a result line holds finite numbers
            self.value = 1.0

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Outcome:
    """What a driver hands back."""
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    checks: List[Check]
    record: dict = field(default_factory=dict)       # what the metric readers read
    memory_peak_bytes: int = 0
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[dict] = None
    notes: List[str] = field(default_factory=list)   # earlier lines on stderr


@dataclass
class Context:
    cell: str
    seed: int
    seconds: float
    trace: bool
    workload: dict
    config: dict
    device: object
    t_start: float
    metrics: Dict[str, dict]     # this cell's metrics by name, from the manifest
    faults: tuple = ()           # planted faults (the harness's own tests)


def host_probe_ms() -> float:
    """The host's speed at the moment: the least of three timings of a
    fixed piece of pure-Python work, in ms. Printed before and after a
    window beside the spread of its rounds, so that a slow run can be told
    from a slow host."""
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        acc = 0
        for i in range(200_000):
            acc += i & 7
        best = min(best, time.perf_counter() - t0)
    return 1e3 * best


def spread_note(name: str, values: List[float]) -> str:
    """``name: least / median / most`` of a window's per-part rates."""
    if not values:
        return f"{name}: none"
    v = sorted(values)
    return f"{name}: {v[0]:.2f} / {v[len(v) // 2]:.2f} / {v[-1]:.2f} ({len(v)} parts)"


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the port's runs must not
    load (names compared whole: ``compression_tpu_torch`` is not
    ``compression_tpu``)."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})
