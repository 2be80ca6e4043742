"""Device segments captured as CUDA graphs, with their kernel launches
counted on every replay.

A :class:`Segment` is a device function over static input tensors: the
part of a compiled program that runs between two host steps (the JAX
package's ``jax.jit`` program between its ``pure_callback``s). On the card
it is run once eagerly to warm up (cuDNN's algorithms, K1's one-time host
set-up), then captured once as a ``torch.cuda.CUDAGraph`` on the caller's
stream, and every call copies its arguments into the static inputs and
replays the graph. A failed capture raises; nothing falls back to eager
launches. On the CPU the same object runs the function eagerly.

The kernels' wrappers count each launch they enqueue through
:func:`count_launch`. While a thread captures a segment, nothing runs: the
launches that thread enqueues are recorded on the segment instead (other
threads' launches count as usual), and every replay counts them, so a
replayed kernel counts as often as it runs.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Sequence

import torch

__all__ = ["Segment", "count_launch", "recording_launches"]

_lock = threading.Lock()
_local = threading.local()


def count_launch(wrapper: Callable, n: int = 1) -> None:
    """Counts ``n`` launches of ``wrapper``'s kernel on ``wrapper.launches``,
    or, while this thread records (:func:`recording_launches`), on the
    record instead."""
    record = getattr(_local, "record", None)
    if record is not None:
        record[wrapper] = record.get(wrapper, 0) + n
        return
    with _lock:  # pipeline worker threads launch concurrently
        wrapper.launches += n


@contextlib.contextmanager
def recording_launches():
    """Within the block, the launches this thread counts go to the yielded
    ``{wrapper: n}`` and not to the wrappers' counts."""
    outer = getattr(_local, "record", None)
    _local.record = record = {}
    try:
        yield record
    finally:
        _local.record = outer


class Segment:
    """``fn(*inputs) -> outputs`` over static inputs shaped like
    ``example`` (tensors on one device), captured on ``stream`` at its
    first call on the card.

    Calls take tensors of the static inputs' shapes (any device: they are
    copied in, non-blocking, on the current stream) and return the static
    outputs, which the next call overwrites: copy what must outlive it.
    On the card, call it on ``stream`` (``torch.cuda.stream(stream)``).
    """

    def __init__(self, fn: Callable, example: Sequence[torch.Tensor], stream=None):
        self.fn = fn
        self.stream = stream
        self.inputs = [torch.empty_like(t) for t in example]
        self.graph = None
        self.outputs = None
        self.replay_launches: Dict[Callable, int] = {}

    def _capture(self) -> None:
        # Warm-up: cuDNN picks its algorithms, K1 sets its shared-memory
        # attribute; these launches run and count as usual.
        self.fn(*self.inputs)
        graph = torch.cuda.CUDAGraph()
        with recording_launches() as captured, torch.cuda.graph(
                graph, stream=self.stream, capture_error_mode="thread_local"):
            outputs = self.fn(*self.inputs)
        self.graph, self.outputs = graph, outputs
        self.replay_launches = captured

    def __call__(self, *args: torch.Tensor):
        for static, a in zip(self.inputs, args):
            static.copy_(a, non_blocking=True)
        if self.inputs[0].device.type != "cuda":
            return self.fn(*self.inputs)
        if self.graph is None:
            self._capture()
        self.graph.replay()
        for wrapper, n in self.replay_launches.items():
            count_launch(wrapper, n)
        return self.outputs
