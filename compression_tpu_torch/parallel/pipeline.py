"""Host/device coding pipeline (counterpart of
``compression_tpu/parallel/pipeline.py`` ``Pipeline``, ``pipeline_map`` and
``staggered_map``).

Double buffering: the main thread dispatches batch i+1's device stage
(asynchronous CUDA work on the codec's stream, ending in non-blocking
copies to pinned host memory and an event) while a worker thread finishes
batch i (waits on its event, range-codes on the host). With ``depth=2``
the steady state costs max(device, host) a batch instead of their sum.

PyTorch's current stream is per thread, so both stages run inside
``torch.cuda.stream(stream)``; on the CPU the stream is None.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
from typing import Callable, Iterable, Iterator, List, Optional

import torch

__all__ = ["Pipeline", "Work", "pipeline_map", "stream_context", "staggered_map"]


class Work:
    """In-flight work between the two stages: device tensors, pinned host
    copies (filled once ``event`` fires) and what the host stage needs."""

    def __init__(self, **fields):
        self.__dict__.update(fields)


def stream_context(stream: Optional["torch.cuda.Stream"]):
    """``torch.cuda.stream(stream)``, or a no-op context on the CPU."""
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


class Pipeline:
    """Two-stage device/host pipeline.

    Args:
      device_fn: batch -> in-flight work (dispatches asynchronously).
      host_fn: work -> result (blocks on the work, then runs host code).
      depth: batches in flight (2 = double buffering).
      stream: the CUDA stream both stages enqueue device work on.
    """

    def __init__(self, device_fn: Callable, host_fn: Callable, depth: int = 2,
                 stream: Optional["torch.cuda.Stream"] = None):
        self.device_fn = device_fn
        self.host_fn = host_fn
        self.depth = max(1, int(depth))
        self.stream = stream

    def _host(self, work):
        with stream_context(self.stream), torch.inference_mode():
            return self.host_fn(work)

    def run(self, batches: Iterable) -> Iterator:
        with cf.ThreadPoolExecutor(max_workers=self.depth) as pool:
            inflight: List[cf.Future] = []
            for batch in batches:
                with stream_context(self.stream), torch.inference_mode():
                    work = self.device_fn(batch)
                inflight.append(pool.submit(self._host, work))
                while len(inflight) >= self.depth:
                    yield inflight.pop(0).result()
            for fut in inflight:
                yield fut.result()


def pipeline_map(device_fn: Callable, host_fn: Callable, batches: Iterable,
                 depth: int = 2) -> List:
    """Runs ``batches`` through a :class:`Pipeline` (on the current stream)
    and returns the results in order."""
    return list(Pipeline(device_fn, host_fn, depth).run(batches))


def staggered_map(fn: Callable, items: Iterable, depth: int = 2) -> Iterator:
    """Runs ``fn`` over ``items`` with up to ``depth`` calls in flight on
    worker threads, yielding the results in input order.

    The decoder's staggering: a call that mixes device work with blocking
    host range decoding (ms2020's slice-by-slice decode) lets another
    call's device work run while it waits on the host."""
    depth = max(1, int(depth))
    with cf.ThreadPoolExecutor(max_workers=depth) as pool:
        inflight: List[cf.Future] = []
        for item in items:
            inflight.append(pool.submit(fn, item))
            while len(inflight) >= depth:
                yield inflight.pop(0).result()
        for fut in inflight:
            yield fut.result()
