"""Spans, tracing and stage timing (counterpart of
``compression_tpu/util/profiling.py``).

* ``span(name)``: a named host region. While recording is off it costs one
  module-level check: it records nothing, calls nothing of the profiler or
  of CUDA, and allocates nothing. Inside ``recording()`` it appends a
  :class:`Span` when it closes. Inside ``trace(logdir)`` it is also a
  ``torch.profiler.record_function`` region and, when a card is present,
  an NVTX range. ``annotate`` is the same function under the JAX
  package's name.
* ``recording()``: keeps the spans that every thread closes while its block
  runs, on the wall clock that ``torch.profiler`` stamps its events with
  (``time.time_ns``), so spans and device activities can be laid side by
  side.
* ``in_batch(batch, fn, *args)``: ``fn(*args)`` with ``batch`` as the
  calling thread's batch id; the pipeline numbers its batches so that a
  batch's spans on the dispatching thread and on the worker share one id.
* ``trace(logdir)``: a ``torch.profiler`` trace of the host and, when a
  card is present, its CUDA activity, with every span on its timeline,
  written to ``logdir/trace.json`` (Chrome / Perfetto format).
* ``StageTimer``: host wall time per named stage, with an aggregate report;
  each stage is a span.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional

import torch

__all__ = ["Span", "span", "annotate", "recording", "in_batch", "trace", "StageTimer"]


class Span(NamedTuple):
    """One closed span. ``thread`` is ``threading.get_native_id()``;
    ``pthread`` is ``threading.get_ident()``, by which a profiler may know
    the thread (a finished thread's ident can be reused by a later one);
    ``parent`` is the name of the span enclosing it on the same thread;
    ``batch`` the thread's batch id (:func:`in_batch`) or None."""
    name: str
    start_ns: int
    end_ns: int
    thread: int
    parent: Optional[str]
    batch: Optional[int]
    pthread: int


class _ThreadState(threading.local):
    def __init__(self):
        self.open: List[str] = []
        self.batch: Optional[int] = None


_spans: Optional[List[Span]] = None   # the buffer while recording, else None
_ranges = False                       # inside trace(): spans are profiler ranges too
_nvtx = False                         # ... and NVTX ranges (a card is present)
_local = _ThreadState()
_OFF = contextlib.nullcontext()


class _Open:
    """A span while it is open; appends its :class:`Span` to the buffer it
    was opened under."""

    __slots__ = ("name", "spans", "parent", "start", "region")

    def __init__(self, name: str, spans: List[Span]):
        self.name = name
        self.spans = spans

    def __enter__(self):
        open_names = _local.open
        self.parent = open_names[-1] if open_names else None
        open_names.append(self.name)
        self.region = None
        if _ranges:
            self.region = torch.profiler.record_function(self.name)
            self.region.__enter__()
            if _nvtx:
                torch.cuda.nvtx.range_push(self.name)
        self.start = time.time_ns()

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.region is not None:
            if _nvtx:
                torch.cuda.nvtx.range_pop()
            self.region.__exit__(*exc)
        _local.open.pop()
        # list.append is atomic under the interpreter lock: worker threads
        # append to one buffer without a lock of their own.
        self.spans.append(Span(self.name, self.start, end, threading.get_native_id(),
                               self.parent, _local.batch, threading.get_ident()))
        return False


def span(name: str):
    """A named host region (see the module's docstring)."""
    if _spans is None:
        return _OFF
    return _Open(name, _spans)


annotate = span


@contextlib.contextmanager
def recording() -> Iterator[List[Span]]:
    """Switches recording on for the block and yields the list that the
    spans closed meanwhile, in any thread, are appended to (in the order
    they close). The innermost block gets the spans; a span still open
    when its block ends is appended when it closes."""
    global _spans
    outer, _spans = _spans, []
    try:
        yield _spans
    finally:
        _spans = outer


def in_batch(batch: int, fn: Callable, *args):
    """``fn(*args)`` with ``batch`` as this thread's batch id, which the
    spans it opens carry."""
    state = _local
    outer, state.batch = state.batch, batch
    try:
        return fn(*args)
    finally:
        state.batch = outer


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profiles the block (CPU, and CUDA when available), with every span as
    a profiler range, and writes the trace to ``logdir/trace.json``; yields
    the profiler. Recording is on for the block."""
    global _ranges, _nvtx
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    outer = _ranges, _nvtx
    with recording() if _spans is None else contextlib.nullcontext():
        _ranges, _nvtx = True, torch.cuda.is_available()
        try:
            with torch.profiler.profile(activities=activities) as prof:
                yield prof
        finally:
            _ranges, _nvtx = outer
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StageTimer:
    """Accumulates host wall time per named stage; ``report()`` prints a
    table. Each stage is a :func:`span`.

    Thread-safe: pipeline host stages run on worker threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        with span(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                with self._lock:
                    self.totals[name] += dt
                    self.counts[name] += 1

    def reset(self) -> None:
        with self._lock:
            self.totals.clear()
            self.counts.clear()

    def report(self) -> str:
        lines = ["stage                     total_s   calls   mean_ms"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:24s} {t:8.3f} {c:7d} {1000*t/c:9.2f}")
        return "\n".join(lines)
