"""The port's spans (``compression_tpu_torch.util.profiling``): nothing is
kept or emitted while recording is off; what recording keeps on two
threads; the clock they share with ``torch.profiler``; the pipeline's batch
ids and waits; ``train_step``'s three parts; ``StageTimer`` the same with
recording on and off; ChannelNorm's span; ms2020's spans on its slice
chain and its decode on the shared pipeline; ``trace`` inside a recording;
many threads appending at once."""

import os
import sys
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch

from compression_tpu_torch.models import bmshj2018, common, ms2020
from compression_tpu_torch.models.hific.archs import ChannelNorm
from compression_tpu_torch.parallel import Pipeline
from compression_tpu_torch.util import profiling
from compression_tpu_torch.util.profiling import in_batch, recording, span

torch.set_num_threads(1)
SMALL = dict(num_filters=16, num_latents=16, num_hyperlatents=8)
CHARM = dict(num_filters=8, num_latents=20, num_hyperlatents=4, num_slices=10)
CHAIN = ("ms2020/supports", "ms2020/slice_params", "ms2020/slice_lrp")


def _images(n, h, w, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, h, w, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def small_codec():
    return bmshj2018.Codec(bmshj2018.BMSHJ2018Model(bmshj2018.Config(**SMALL), seed=0),
                           device="cpu")


@pytest.fixture
def no_ranges(monkeypatch):
    """Makes any profiler range, NVTX range or open span raise."""
    def refuse(*_args, **_kwargs):
        raise AssertionError("a profiler range, NVTX range or span object was made")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", refuse)
    monkeypatch.setattr(profiling, "_Open", refuse)


def _step(model):
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-3)
    for group in optimizer.param_groups:
        group["scale"] = 1.0

    def loss_fn(batch, _generator):
        return model(batch).square().mean(), {}
    batch = torch.from_numpy(_images(2, 1, 4)).reshape(2, 12)
    return lambda: common.train_step(model, optimizer, loss_fn, batch, None, lambda _: 1e-3)


def test_recording_off_keeps_nothing_and_emits_no_range(no_ranges, small_codec):
    assert profiling._spans is None
    assert span("a") is span("b")  # one shared no-op context: nothing allocated
    with span("a"), profiling.annotate("b"):
        pass
    blobs = list(small_codec.compress_iter([_images(2, 64, 64)], depth=2))
    list(small_codec.decompress_iter(blobs, depth=2))
    _step(torch.nn.Linear(12, 3))()
    with recording() as spans:
        pass
    assert spans == []


def test_recording_keeps_name_thread_parent_and_batch_on_two_threads():
    def worker():
        with span("w/outer"), span("w/inner"):
            pass

    def main_side():
        with span("m/outer"):
            t = threading.Thread(target=in_batch, args=(8, worker))
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
    with recording() as spans:
        in_batch(7, main_side)
    with span("after"):
        pass
    by_name = {s.name: s for s in spans}
    assert sorted(by_name) == ["m/outer", "w/inner", "w/outer"]
    main, inner, outer = by_name["m/outer"], by_name["w/inner"], by_name["w/outer"]
    assert main.thread == threading.get_native_id() and main.pthread == threading.get_ident()
    assert inner.thread == outer.thread != main.thread
    assert (main.parent, outer.parent, inner.parent) == (None, None, "w/outer")
    assert (main.batch, outer.batch, inner.batch) == (7, 8, 8)
    assert main.start_ns <= outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns \
        <= main.end_ns
    assert profiling._local.batch is None


def test_a_span_holds_the_profiler_interval_of_its_op():
    """Spans and ``torch.profiler`` events share the wall clock, so a span
    around an op contains the op's interval."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1000)
    with recording() as spans, profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("sum"):
            x.sum()
    (s,) = spans
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CPU and e.name() == "aten::sum"]
    assert ops
    for op in ops:
        assert s.start_ns <= op.start_ns() <= op.start_ns() + op.duration_ns() <= s.end_ns


def test_pipeline_gives_a_batch_one_id_on_both_threads_and_times_its_waits():
    def device_fn(batch):
        with span("d"):
            return batch

    def host_fn(work):
        with span("h"):
            time.sleep(0.03)
            return work
    with recording() as spans:
        out = list(Pipeline(device_fn, host_fn, depth=2).run(range(4)))
    assert out == [0, 1, 2, 3]
    dispatched = {s.batch: s for s in spans if s.name == "d"}
    hosted = {s.batch: s for s in spans if s.name == "h"}
    assert len(dispatched) == len(hosted) == 4 and set(dispatched) == set(hosted)
    main = threading.get_native_id()
    for batch, d in dispatched.items():
        assert d.thread == main and hosted[batch].thread != main
    waits = [s for s in spans if s.name == "pipeline/wait"]
    assert len(waits) == 4 and all(s.thread == main and s.batch is None for s in waits)
    # Two workers: batches 0 and 2 are each waited on for most of a sleep.
    assert sum(s.end_ns - s.start_ns for s in waits) >= 0.05e9


def test_train_step_opens_its_three_spans_in_order():
    step = _step(torch.nn.Linear(12, 3))
    with recording() as spans:
        step()
    assert [s.name for s in sorted(spans, key=lambda s: s.start_ns)] == [
        "train/forward", "train/backward", "train/optimizer"]
    assert all(a.end_ns <= b.start_ns for a, b in zip(spans, spans[1:]))


def test_stage_timer_is_the_same_with_recording_on_and_off(small_codec):
    """The same stages and calls either way; with recording on each stage is
    a span of its time, and the device waits are spans, not stages."""
    images = [_images(2, 64, 64, seed=s) for s in range(3)]
    timer = small_codec.timer

    def round_trip():
        timer.reset()
        blobs = list(small_codec.compress_iter(images, depth=2))
        list(small_codec.decompress_iter(blobs, depth=2))
        return dict(timer.counts), dict(timer.totals)
    counts_off, _ = round_trip()
    with recording() as spans:
        counts_on, totals_on = round_trip()
    assert counts_on == counts_off and "enc/code_y" in counts_on
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append((s.end_ns - s.start_ns) / 1e9)
    for name, count in counts_on.items():
        assert len(by_name[name]) == count
        assert sum(by_name[name]) == pytest.approx(totals_on[name], abs=1e-3)
    assert "wait/device" not in counts_on


def test_channel_norm_opens_its_span():
    norm = ChannelNorm(4)
    x = torch.randn(2, 3, 3, 4)
    with recording() as spans:
        y = norm(x)
    assert [s.name for s in spans] == ["hific/channel_norm"]
    np.testing.assert_allclose(y.detach().mean(-1).numpy(), 0.0, atol=1e-6)


class _Fired:
    """An event that has fired: the card's ``torch.cuda.Event`` in a CPU
    run, so that the waits on it are taken."""

    def synchronize(self):
        pass


@pytest.fixture(scope="module")
def charm_codec():
    codec = ms2020.Codec(ms2020.MS2020Model(ms2020.Config(**CHARM), seed=0), device="cpu")
    codec._event = _Fired
    return codec


def _round_trip(codec, coder, batches=3):
    images = [_images(2, 64, 64, seed=s) for s in range(batches)]
    with recording() as enc:
        blobs = list(codec.compress_iter(images, depth=2, coder=coder))
    with recording() as dec:
        assert len(list(codec.decompress_iter(blobs, depth=2))) == batches
    return enc, dec


@pytest.mark.parametrize("coder", ["device", "host"])
def test_ms2020_opens_its_chain_spans_once_a_batch_and_a_slice(charm_codec, coder):
    """Each phase opens ``ms2020/supports`` once a batch, and
    ``ms2020/slice_params`` and ``ms2020/slice_lrp`` once a batch and a
    slice (10 slices), under the batch's id."""
    for spans in _round_trip(charm_codec, coder):
        by_batch = {}
        for s in spans:
            if s.name in CHAIN:
                by_batch.setdefault(s.batch, Counter())[s.name] += 1
        assert len(by_batch) == 3 and None not in by_batch
        for counts in by_batch.values():
            assert [counts[n] for n in CHAIN] == [1, 10, 10]


def test_ms2020s_device_coded_decode_runs_on_the_shared_pipeline(charm_codec):
    """The dispatching thread enqueues every batch's whole chain and waits
    for the oldest batch under ``pipeline/wait``; a worker waits on the
    batch's event under ``wait/device`` inside ``dec/fetch_image``."""
    _enc, dec = _round_trip(charm_codec, "device")
    main = threading.get_native_id()
    chain = [s for s in dec if s.name in CHAIN or s.name == "dec/dispatch"]
    assert len(chain) == 3 * 22 and all(s.thread == main for s in chain)
    waits = [s for s in dec if s.name == "pipeline/wait"]
    assert len(waits) == 3 and all(s.thread == main and s.batch is None for s in waits)
    device = [s for s in dec if s.name == "wait/device"]
    assert len(device) == 3 and {s.batch for s in device} == {s.batch for s in chain}
    assert all(s.thread != main and s.parent == "dec/fetch_image" for s in device)


def test_trace_inside_a_recording_keeps_its_spans_and_shows_them(tmp_path):
    with recording() as spans:
        with profiling.trace(str(tmp_path)) as prof:
            with span("traced"):
                torch.ones(8).sum()
        with span("after"):
            pass
    assert [s.name for s in spans] == ["traced", "after"]
    assert any(e.key == "traced" for e in prof.key_averages())
    assert profiling._ranges is False and profiling._spans is None


def test_many_threads_lose_no_span():
    """More threads than cores append to one buffer with a short switch
    interval: every span is kept, with its own thread's parent and batch."""
    n_threads, n_spans = 4 * len(os.sched_getaffinity(0)), 300

    def worker(i):
        for _ in range(n_spans):
            with span("outer"), span("inner"):
                pass
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with recording() as spans:
            threads = [threading.Thread(target=in_batch, args=(i, worker, i))
                       for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert len(spans) == 2 * n_threads * n_spans
    by_thread = {}
    for s in spans:
        by_thread.setdefault(s.thread, set()).add((s.name, s.parent, s.batch))
    assert sorted(len(v) for v in by_thread.values()) == [2] * n_threads
    for kinds in by_thread.values():
        (batch,) = {b for _, _, b in kinds}
        assert kinds == {("outer", None, batch), ("inner", "outer", batch)}
