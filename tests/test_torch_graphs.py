"""Launch accounting of the CUDA-graph segments (util/graphs.py) on the
CPU: a launch counts on its wrapper, or, while the launching thread
records a capture, on the capture; another thread's launches in that
window count as usual. The graphs themselves are tests/test_torch_cuda.py's."""

import threading

import torch

from compression_tpu_torch.util.graphs import Segment, count_launch, recording_launches


def _wrapper():
    def kernel():
        pass

    kernel.launches = 0
    return kernel


def test_count_launch_counts_on_the_wrapper():
    k = _wrapper()
    count_launch(k)
    count_launch(k, 2)
    assert k.launches == 3


def test_recording_takes_this_threads_launches_only():
    k = _wrapper()
    with recording_launches() as record:
        count_launch(k, 2)
        worker = threading.Thread(target=count_launch, args=(k,))
        worker.start()
        worker.join()
    assert record == {k: 2}
    assert k.launches == 1  # the worker's launch ran; the recorded ones did not
    count_launch(k)
    assert k.launches == 2


def test_recordings_nest():
    k, j = _wrapper(), _wrapper()
    with recording_launches() as outer:
        count_launch(k)
        with recording_launches() as inner:
            count_launch(j, 3)
        count_launch(k)
    assert outer == {k: 2} and inner == {j: 3}
    assert k.launches == j.launches == 0


def test_segment_runs_eagerly_on_the_cpu():
    k = _wrapper()

    def fn(x):
        count_launch(k)
        return x * 2

    seg = Segment(fn, [torch.zeros(3)])
    for i in range(1, 3):
        out = seg(torch.full((3,), float(i)))
        torch.testing.assert_close(out, torch.full((3,), 2.0 * i))
    assert seg.graph is None and seg.replay_launches == {}
    assert k.launches == 2
