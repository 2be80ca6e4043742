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

Each batch gets a number, the batch id of the spans its two stages open
(:func:`~compression_tpu_torch.util.profiling.in_batch`); the dispatching
thread's waits for the oldest batch are ``pipeline/wait`` spans.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import itertools
from typing import Callable, Iterable, Iterator, List, Optional

import torch

from compression_tpu_torch.util.profiling import in_batch, span

__all__ = ["Pipeline", "Work", "pipeline_map", "stream_context", "staggered_map"]


_BATCH_IDS = itertools.count()  # unique in the process: two pipelines may overlap


def _wait(fut: cf.Future):
    with span("pipeline/wait"):
        return fut.result()


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

    def _host(self, batch_id: int, work):
        with stream_context(self.stream), torch.inference_mode():
            return in_batch(batch_id, self.host_fn, work)

    def run(self, batches: Iterable) -> Iterator:
        with cf.ThreadPoolExecutor(max_workers=self.depth) as pool:
            inflight: List[cf.Future] = []
            for batch in batches:
                batch_id = next(_BATCH_IDS)
                with stream_context(self.stream), torch.inference_mode():
                    work = in_batch(batch_id, self.device_fn, batch)
                inflight.append(pool.submit(self._host, batch_id, work))
                while len(inflight) >= self.depth:
                    yield _wait(inflight.pop(0))
            for fut in inflight:
                yield _wait(fut)


def pipeline_map(device_fn: Callable, host_fn: Callable, batches: Iterable,
                 depth: int = 2) -> List:
    """Runs ``batches`` through a :class:`Pipeline` (on the current stream)
    and returns the results in order."""
    return list(Pipeline(device_fn, host_fn, depth).run(batches))


def staggered_map(fn: Callable, items: Iterable, depth: int = 2) -> Iterator:
    """Runs ``fn`` over ``items`` with up to ``depth`` calls in flight on
    worker threads, yielding the results in input order.

    The decoder's staggering: a call that mixes device work with blocking
    host range decoding lets another call's device work run while it waits
    on the host. Its user is ``charm_pipeline.decompress_batch_pipelined``,
    which decodes ms2020 blobs of either coder a batch a call; ms2020's
    ``Codec.decompress_iter`` is a :class:`Pipeline`, whose workers
    stagger its host-coded batches (a host round trip a slice) alike."""
    depth = max(1, int(depth))
    with cf.ThreadPoolExecutor(max_workers=depth) as pool:
        inflight: List[cf.Future] = []
        for item in items:
            inflight.append(pool.submit(fn, item))
            while len(inflight) >= depth:
                yield inflight.pop(0).result()
        for fut in inflight:
            yield fut.result()
