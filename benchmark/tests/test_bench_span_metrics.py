"""The port's spans in the drivers' records, and the metric files that read
them. A traced run on the CPU at ``test_bench_faults``' small size records
every span the port closes over the window's calls, by phase, whatever its
name, so that a span a family adds reaches a metric file of its own with no
other file edited; an untraced run records none. Each of the span metrics
reads a record made by hand, and gives None on a record without spans."""

import time

import pytest
import torch

from benchmark import harness, program, spans
from benchmark.tests.test_bench_faults import small
from benchmark.tests.test_bench_spans import RECORD

NEW = "family/new_stage"  # a span no reader in benchmark/spans.py names
DEVICE, TRAIN = "bmshj2018.kodak768-b8.device", "bmshj2018.train-b8-256"

# Each span metric and what it reads from ``RECORD``: 400 images a codec
# phase in the window, 200 training steps, 16 batches of 8 traced.
READINGS = {
    "dispatch_wait_ms_per_img.compress": 5.0, "dispatch_wait_ms_per_img.compress.host": 5.0,
    "dispatch_wait_ms_per_img.decompress": 1.0, "dispatch_wait_ms_per_img.decompress.host": 1.0,
    "device_wait_ms_per_img.compress": 2.5, "device_wait_ms_per_img.compress.host": 2.5,
    "device_wait_ms_per_img.decompress": 20.0, "device_wait_ms_per_img.decompress.host": 20.0,
    "forward_enqueue_ms.train": 10.0, "backward_enqueue_ms.train": 15.0,
    "adam_enqueue_ms.train": 5.0,
    "channel_norm_ms_per_img.compress": 1.0, "channel_norm_ms_per_img.decompress": 2.0,
}


def drive(cell, trace):
    """The cell's driver on the CPU at the small size: its Outcome."""
    torch.manual_seed(0)
    wl, cfg = small(cell)
    ctx = harness.Context(
        cell=cell, seed=4294967391, seconds=0.01, trace=trace, workload=wl, config=cfg,
        device=torch.device("cpu"), t_start=time.perf_counter(), metrics={})
    return harness.load_module(harness.HERE / "drivers" / f"{wl['driver']}.py").run(ctx)


def test_the_span_metrics_are_the_manifests():
    files = {p.name[: -len(".py")] for p in (harness.HERE / "metrics").glob("*.py")}
    entries = {m["name"]: m for m in harness.manifest()["per_layer"]}
    assert set(READINGS) <= files & set(entries)
    for name in READINGS:
        assert entries[name]["source"] == (
            "device_trace" if name.startswith("channel_norm") else "program_span")


@pytest.mark.parametrize("name", sorted(READINGS))
def test_a_span_metric_reads_its_spans(name):
    read = harness.load_module(harness.HERE / "metrics" / f"{name}.py").read
    assert read(RECORD) == pytest.approx(READINGS[name])
    bare = {k: v for k, v in RECORD.items() if not k.startswith("span_")}
    assert read(bare) is None
    assert read({**bare, "span_s": {"compress": {}}, "span_device_s": {}}) is None


@pytest.fixture
def new_stage(monkeypatch):
    """A span of a family's own around one codec stage a phase (the blobs'
    packing, the synthesis), as a family's change would open it."""
    from compression_tpu_torch.models import bmshj2018
    from compression_tpu_torch.util.profiling import span

    for method in ("_pack", "_synthesize"):
        inner = getattr(bmshj2018.Codec, method)

        def wrapped(self, *args, inner=inner, **kwargs):
            with span(NEW):
                return inner(self, *args, **kwargs)
        monkeypatch.setattr(bmshj2018.Codec, method, wrapped)


def test_a_traced_run_records_every_span_of_the_window(new_stage, tmp_path):
    out = drive(DEVICE, trace=True)
    record = out.record
    assert set(record["span_s"]) == {"compress", "decompress"}
    for phase, stage in (("compress", "enc/dispatch"), ("decompress", "dec/dispatch")):
        assert {stage, "pipeline/wait", NEW} <= set(record["span_s"][phase]), phase
        assert record["span_s"][phase][NEW] > 0
    assert set(record["span_device_s"]) == {"compress", "decompress"}
    assert any(n.startswith("traced compress: device by program span") for n in out.notes)
    # A metric file of the family's own reads the new span, with no other edit.
    reader = tmp_path / "new_stage_ms_per_img.compress.py"
    reader.write_text(
        "from benchmark import spans\n\n\n"
        "def read(record):\n"
        f"    return spans._per(record, 'span_s', 'compress', {NEW!r},\n"
        "                      record['window_images']['compress'])\n")
    got = harness.load_module(reader).read(record)
    assert got == pytest.approx(
        1e3 * record["span_s"]["compress"][NEW] / record["window_images"]["compress"])
    for name in ("dispatch_wait_ms_per_img.compress", "dispatch_wait_ms_per_img.decompress"):
        value = harness.load_module(harness.HERE / "metrics" / f"{name}.py").read(record)
        assert value is not None and value >= 0


def test_a_traced_training_run_records_the_steps_spans():
    record = drive(TRAIN, trace=True).record
    names = set(record["span_s"]["train"])
    assert {"train/forward", "train/backward", "train/optimizer"} <= names
    assert set(record["span_device_s"]) == {"train"}
    for name in ("forward_enqueue_ms.train", "backward_enqueue_ms.train",
                 "adam_enqueue_ms.train"):
        value = harness.load_module(harness.HERE / "metrics" / f"{name}.py").read(record)
        assert value is not None and value > 0


@pytest.mark.parametrize("cell", [DEVICE, TRAIN])
def test_an_untraced_run_records_no_span(monkeypatch, cell):
    from compression_tpu_torch.util import profiling

    def refused():
        raise AssertionError("an untraced run recorded the port's spans")
    monkeypatch.setattr(program, "spans", refused)
    record = drive(cell, trace=False).record
    assert "span_s" not in record and "span_device_s" not in record
    assert profiling._spans is None
    assert spans.dispatch_wait_ms_per_img(record, "compress") is None

