"""ms2020-cc10's slice-chain metrics: the four files that read the port's
``ms2020/slice_params`` and ``ms2020/slice_lrp`` spans, as
``test_bench_span_metrics`` holds the other span metrics. Each reads a
record made by hand, and gives None on a record without the spans (the
program before it opened them) or with one of the two alone. A traced run
of the cell on the CPU at ``test_bench_faults``' small size records the
chain's spans in both phases, and its decode's pipeline waits; the two
host files read them there, the two device files on the card only."""

import pytest

from benchmark import harness
from benchmark.tests.test_bench_span_metrics import drive
from benchmark.tests.test_bench_spans import RECORD

CELL = "ms2020-cc10.kodak768-b8.device"
CHAIN = ("ms2020/slice_params", "ms2020/slice_lrp")

# 400 window images a phase and 16 batches of 8 traced, as in ``RECORD``.
CHAIN_RECORD = {
    **RECORD,
    "span_s": {"compress": {**RECORD["span_s"]["compress"],
                            "ms2020/slice_params": 6.0, "ms2020/slice_lrp": 2.0},
               "decompress": {**RECORD["span_s"]["decompress"], "ms2020/supports": 1.0,
                              "ms2020/slice_params": 8.0, "ms2020/slice_lrp": 4.0}},
    "span_device_s": {"compress": {"enc/dispatch": 0.5, "ms2020/slice_params": 1.024,
                                   "ms2020/slice_lrp": 0.512},
                      "decompress": {"dec/dispatch": 0.5, "ms2020/slice_params": 1.28,
                                     "ms2020/slice_lrp": 0.64}},
}
READINGS = {
    "slice_chain_ms_per_img.compress": 12.0, "slice_chain_ms_per_img.decompress": 15.0,
    "slice_chain_enqueue_ms_per_img.compress": 20.0,
    "slice_chain_enqueue_ms_per_img.decompress": 30.0,
}
TRANSFORMS = "transforms: layers/signal_conv.py through cuDNN, hific archs.py"
STAGES = "codec stages: models/codec_base.py, models/device_coding.py, parallel/pipeline.py"


def reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py").read


def test_the_chain_metrics_are_the_manifests():
    entries = {m["name"]: m for m in harness.manifest()["per_layer"]}
    for name in READINGS:
        m = entries[name]
        device = name.startswith("slice_chain_ms")
        assert m["source"] == ("device_trace" if device else "program_span")
        assert m["layer"] == (TRANSFORMS if device else STAGES)
        assert m["workloads"] == [CELL] and m["unit"] == "ms" and m["better"] == "lower"
        assert m["moves"] in ("compress_img_s" if name.endswith(".compress")
                              else ("decompress_img_s", "decode_p95_ms"))


@pytest.mark.parametrize("name", sorted(READINGS))
def test_a_chain_metric_reads_its_spans(name):
    read = reader(name)
    assert read(CHAIN_RECORD) == pytest.approx(READINGS[name])
    bare = {k: v for k, v in CHAIN_RECORD.items() if not k.startswith("span_")}
    assert read(bare) is None
    assert read(RECORD) is None  # the spans of a program without the chain's
    key = "span_device_s" if name.startswith("slice_chain_ms") else "span_s"
    phase = name.rsplit(".", 1)[1]
    for alone in CHAIN:
        one = {**CHAIN_RECORD, key: {phase: {alone: 1.0}}}
        assert read(one) is None


def test_a_traced_run_of_the_cell_records_the_chain_and_the_decodes_waits():
    out = drive(CELL, trace=True)
    record = out.record
    for phase in ("compress", "decompress"):
        names = set(record["span_s"][phase])
        assert {"ms2020/supports", *CHAIN} <= names, phase
        value = reader(f"slice_chain_enqueue_ms_per_img.{phase}")(record)
        assert value is not None and value > 0, phase
        # The CPU has no device activity to attribute: the card's run reads it.
        assert phase in record["span_device_s"]
        assert reader(f"slice_chain_ms_per_img.{phase}")(record) is None
    assert "pipeline/wait" in record["span_s"]["decompress"]
    assert reader("dispatch_wait_ms_per_img.decompress")(record) is not None
    # Nested in dec/dispatch: the chain's host time is a part of it.
    dec = record["span_s"]["decompress"]
    assert dec["ms2020/slice_params"] + dec["ms2020/slice_lrp"] <= dec["dec/dispatch"]
