"""Program spans beside the device, on spans, launches and activities given
by hand (the card's profiler runs only in a chip run; the join itself is
checked on the card by ``tests/test_torch_cuda.py``), and the readers of the
metrics they give."""

import pathlib
import re
from collections import namedtuple

import pytest

from benchmark import spans, trace

S = namedtuple("S", "name start_ns end_ns thread pthread")
MAIN, WORKER_A, WORKER_B, AUTOGRAD = 100, 101, 102, 103
PORT = pathlib.Path(__file__).resolve().parent.parent.parent / "compression_tpu_torch"


def test_totals_sum_by_name():
    got = spans.totals([S("a", 0, 10**9, MAIN, 1), S("a", 0, 5 * 10**8, WORKER_A, 2),
                        S("b", 3, 3, MAIN, 1)])
    assert got == {"a": 1.5, "b": 0.0}


def test_timeline_takes_the_innermost_span():
    line = spans._Timeline([S("outer", 0, 100, MAIN, 1), S("inner", 10, 20, MAIN, 1),
                            S("late", 50, 60, MAIN, 1), S("after", 120, 130, MAIN, 1)])
    assert [line.at(t) for t in (0, 10, 19, 20, 55, 60, 110, 125, 130)] == [
        "outer", "inner", "inner", "outer", "late", "outer", None, "after", None]
    assert line.pieces(5, 125) == [("outer", 5), ("inner", 10), ("outer", 30), ("late", 10),
                                   ("outer", 40), (spans.NO_SPAN, 20), ("after", 5)]


def test_launches_go_to_the_span_open_on_their_own_thread():
    """Two workers that live one after the other share a pthread ident, and
    the profiler names both by the later one's native id, or by that of a
    thread that opened no span; the main thread dispatches meanwhile, under
    CPU ops; autograd's device thread runs ops and opened no span."""
    ss = [S("enc/dispatch", 0, 100, MAIN, 1), S("pipeline/wait", 100, 400, MAIN, 1),
          S("enc/code_z", 50, 150, WORKER_A, 7), S("dec/synth", 200, 300, WORKER_B, 7)]
    device = [(10, 30, 1), (60, 90, 2), (120, 125, 7), (210, 260, 3), (270, 280, 4),
              (320, 330, 5), (340, 350, 6)]
    launches = {1: (5, MAIN, MAIN),
                2: (55, WORKER_B, None),    # worker A, named as worker B
                7: (120, AUTOGRAD, None),   # worker A, named as a thread without spans
                3: (205, WORKER_B, None),
                4: (265, AUTOGRAD, AUTOGRAD),  # backward's kernel: the dispatcher's span
                5: (310, WORKER_B, None)}   # after worker B's span; 6: no launch seen
    got = spans.attribute(device, launches, ss, {"compress": (0, 400)}, MAIN)["compress"]
    assert got["device"] == pytest.approx({
        "enc/dispatch": 20e-9, "enc/code_z": 35e-9, "dec/synth": 50e-9,
        "pipeline/wait": 10e-9, spans.NO_SPAN: 20e-9})
    # Idle: [0, 10), [30, 60), [90, 100) in enc/dispatch, the rest under
    # pipeline/wait on the dispatching thread.
    assert got["idle"] == pytest.approx({"enc/dispatch": 50e-9, "pipeline/wait": 215e-9})
    assert sum(got["device"].values()) + sum(got["idle"].values()) == pytest.approx(400e-9)


def test_a_worker_named_by_its_pthread_ident_cut_to_32_bits():
    """On the card the profiler names a thread it does not follow by
    ``pthread_self()`` as a signed 32-bit integer."""
    worker = 140601953609408  # named 1904207552
    other = 140602532427456   # named -1811941696
    ss = [S("dec/synth", 0, 100, WORKER_A, worker), S("dec/code_y", 0, 100, WORKER_B, other)]
    launches = {1: (10, 1904207552, None), 2: (20, -1811941696, None)}
    got = spans.attribute([(10, 20, 1), (30, 35, 2)], launches, ss, {"p": (0, 100)},
                          MAIN)["p"]["device"]
    assert got == pytest.approx({"dec/synth": 10e-9, "dec/code_y": 5e-9})


def test_the_ident_behind_an_unknown_name_is_learned_from_unambiguous_launches():
    """Two workers have spans open at once; the profiler names worker B by
    a thread that opened no span. A call under that name while only B has a
    span open tells which ident the name stands for."""
    ss = [S("dec/code_y", 0, 100, WORKER_A, 7), S("dec/synth", 50, 200, WORKER_B, 8)]
    device = [(65, 75, 1), (160, 170, 2)]
    ambiguous = {1: (60, AUTOGRAD, None)}
    got = spans.attribute(device[:1], ambiguous, ss, {"p": (0, 200)}, MAIN)["p"]["device"]
    assert got == pytest.approx({spans.NO_SPAN: 10e-9})
    got = spans.attribute(device, {**ambiguous, 2: (150, AUTOGRAD, None)}, ss, {"p": (0, 200)},
                          MAIN)["p"]["device"]
    assert got == pytest.approx({"dec/synth": 20e-9})


def test_activities_count_only_their_own_time_inside_their_phase():
    ss = [S("a", 0, 1000, MAIN, 1)]
    device = [(0, 100, 1), (50, 150, 2), (500, 600, 3)]
    launches = {1: (0, MAIN, MAIN), 2: (1, MAIN, None), 3: (2, MAIN, MAIN)}
    got = spans.attribute(device, launches, ss, {"p": (0, 400), "q": (400, 700)}, MAIN)
    assert got["p"]["device"] == pytest.approx({"a": 150e-9})
    assert got["q"]["device"] == pytest.approx({"a": 100e-9})
    assert got["q"]["idle"] == pytest.approx({"a": 200e-9})


def test_without_spans_everything_is_no_span():
    got = spans.attribute([(0, 10, 1)], {1: (0, MAIN, MAIN)}, [], {"p": (0, 20)}, MAIN)["p"]
    assert got == {"device": {spans.NO_SPAN: 10e-9}, "idle": {spans.NO_SPAN: 10e-9}}


def test_notes_name_each_phase():
    lines = spans.notes({"compress": {"device": {"a": 0.5, "b": 0.25}, "idle": {"c": 0.125}}})
    assert lines == ["traced compress: device by program span a 0.5000 s, b 0.2500 s; "
                     "idle by program span c 0.1250 s"]


RECORD = {"traffic": {"round_batches": 16, "batch": 8},
          "window_images": {"compress": 400, "decompress": 400},
          "train_steps": 200,
          "span_s": {"compress": {"pipeline/wait": 2.0, "wait/device": 1.0},
                     "decompress": {"pipeline/wait": 0.4, "wait/device": 8.0},
                     "train": {"train/forward": 2.0, "train/backward": 3.0,
                               "train/optimizer": 1.0}},
          "span_device_s": {"compress": {"hific/channel_norm": 0.128},
                            "decompress": {"hific/channel_norm": 0.256}}}


def test_readers_read_the_spans():
    assert spans.dispatch_wait_ms_per_img(RECORD, "compress") == pytest.approx(5.0)
    assert spans.dispatch_wait_ms_per_img(RECORD, "decompress") == pytest.approx(1.0)
    assert spans.device_wait_ms_per_img(RECORD, "decompress") == pytest.approx(20.0)
    assert [spans.train_span_ms(RECORD, n) for n in ("forward", "backward", "optimizer")] == \
        pytest.approx([10.0, 15.0, 5.0])
    assert spans.channel_norm_ms_per_img(RECORD, "compress") == pytest.approx(1.0)
    assert spans.channel_norm_ms_per_img(RECORD, "decompress") == pytest.approx(2.0)


@pytest.mark.parametrize("read", [
    lambda r: spans.dispatch_wait_ms_per_img(r, "compress"),
    lambda r: spans.dispatch_wait_ms_per_img(r, "decompress"),
    lambda r: spans.device_wait_ms_per_img(r, "compress"),
    lambda r: spans.device_wait_ms_per_img(r, "decompress"),
    lambda r: spans.train_span_ms(r, "forward"),
    lambda r: spans.train_span_ms(r, "backward"),
    lambda r: spans.train_span_ms(r, "optimizer"),
    lambda r: spans.channel_norm_ms_per_img(r, "compress"),
    lambda r: spans.channel_norm_ms_per_img(r, "decompress"),
])
def test_readers_give_none_on_a_record_without_spans(read):
    """A port without spans (an older commit) leaves no ``span_s`` in the record."""
    bare = {k: v for k, v in RECORD.items() if not k.startswith("span_")}
    assert read(bare) is None
    assert read({**bare, "span_s": {}, "span_device_s": {"compress": {}}}) is None


def _port_span_names():
    names = set()
    for path in PORT.rglob("*.py"):
        names.update(re.findall(r"""(?:span|stage)\(\s*["']([^"']+)["']""", path.read_text()))
    return sorted(names)


def test_the_port_opens_the_spans_the_readers_read():
    assert set(spans.READ) <= set(_port_span_names())


@pytest.mark.parametrize("name", _port_span_names())
def test_no_span_name_is_a_kernel_class(name):
    """Inside ``trace(logdir)`` a span is a ``record_function`` region, a CPU
    op: its name must not move a kernel into another class."""
    assert trace.kind_of(name, [name]) == "other"
    assert trace.kind_of("void at::native::elementwise_kernel", [name]) == "other"
