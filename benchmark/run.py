"""Runs one cell of the benchmark once, on the card, and prints its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. ``BENCHMARK.json`` names the cell; the files
under ``benchmark/`` that its entries name do the rest (see
:mod:`benchmark.harness`). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
(with ``--trace 1`` also the traced seconds busy and in all), with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
with its limit. The same checks are the last lines of standard error.

Exits non-zero, printing no result, where CUDA is unavailable or the card
holds fewer devices than the cell asks for, or where a module of JAX or of
the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _cell_metrics(man: dict, cell: str, section: str) -> dict:
    return {m["name"]: m for m in man[section]
            if "workloads" not in m or cell in m["workloads"]}


def main(argv=None, device=None, faults=(), workload=None, config=None, t_start=None) -> int:
    """``device``, ``faults``, ``workload`` and ``config`` (replacements of the cell's
    files) are for the harness's own tests, which run it on the
    CPU; a run on the card passes none of them."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from benchmark import harness

    man = harness.manifest()
    entry = next((w for w in man["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    wl = workload or harness.load_json(harness.HERE / "workloads" / f"{entry['name']}.json")
    cfg = config or harness.load_json(harness.HERE / "configs" / f"{entry['config']}.json")

    import torch

    # One process with few threads: torch's intra-op pool at a thread a
    # core contends with the codec's host threads and spreads the rates.
    torch.set_num_threads(1)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
            print(f"the cell needs {entry['chips']} CUDA device(s); "
                  f"available: {torch.cuda.is_available()}, "
                  f"count: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 1
        device = torch.device("cuda", 0)

    driver = harness.load_module(harness.HERE / "drivers" / f"{wl['driver']}.py")
    ctx = harness.Context(
        cell=entry["name"], seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        workload=wl, config=cfg, device=device, t_start=t_start or T_START,
        metrics=_cell_metrics(man, entry["name"], "per_layer" if args.trace else "end_to_end"),
        faults=tuple(faults))
    outcome = driver.run(ctx)

    loaded = harness.forbidden_modules()
    if loaded:
        print("modules of JAX or of the JAX package are loaded: " + ", ".join(loaded),
              file=sys.stderr)
        return 1

    metrics = {}
    for name, m in ctx.metrics.items():
        if args.trace:
            value = harness.load_module(harness.HERE / "metrics" / f"{name}.py").read(outcome.record)
        else:  # ``<quantity>.<tag>`` (a cell's own copy of a metric) reads ``<quantity>``
            value = outcome.end_to_end.get(name, outcome.end_to_end.get(name.split(".")[0]))
        if value is not None and math.isfinite(value):
            metrics[name] = {"value": float(value), "unit": m["unit"]}
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": entry["chips"], "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    if args.trace:
        info["busy_s"] = outcome.busy_s
        info["window_s"] = outcome.window_s
    correct = outcome.failed == 0 and all(c.ok for c in outcome.checks)
    result = {"correct": correct, "attempted": outcome.attempted, "failed": outcome.failed,
              "metrics": metrics, "device": info}
    if args.trace and outcome.breakdown is not None:
        result["breakdown"] = outcome.breakdown
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in outcome.checks}

    for note in outcome.notes:
        print(note, file=sys.stderr)
    print(f"attempted {outcome.attempted}, failed {outcome.failed}", file=sys.stderr)
    for c in outcome.checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
