"""Tracing and stage timing (counterpart of
``compression_tpu/util/profiling.py``).

* ``trace(logdir)``: a ``torch.profiler`` trace of the host and, when a
  card is present, its CUDA activity, written to ``logdir/trace.json``
  (Chrome / Perfetto format).
* ``annotate(name)``: a named region, ``torch.profiler.record_function``
  plus an NVTX range when a card is present, so host stages show on the
  timeline next to the device's work.
* ``StageTimer``: wall time per named stage, with an aggregate report.

Each stage is timed on the host clock. On a CUDA device it is also bracketed
by two ``torch.cuda.Event``s on the current stream, so the device time of
the work the stage enqueued is known too; those events are read lazily, in
``report()``/``device_ms()``, so timing never blocks the pipeline.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Tuple

import torch

__all__ = ["trace", "annotate", "StageTimer"]


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profiles the block (CPU, and CUDA when available) and writes the
    trace to ``logdir/trace.json``; yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region on the profiler's timeline (and an NVTX range on the
    card)."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


class StageTimer:
    """Accumulates wall time (and device time on CUDA) per named stage.

    Thread-safe: pipeline host stages run on worker threads."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self._lock = threading.Lock()
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._device_totals: Dict[str, float] = defaultdict(float)
        self._pending: List[Tuple[str, torch.cuda.Event, torch.cuda.Event]] = []

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        events = None
        if self.device.type == "cuda":
            events = (
                torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True),
            )
            events[0].record()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if events is not None:
                events[1].record()
            with self._lock:
                self.totals[name] += dt
                self.counts[name] += 1
                if events is not None:
                    self._pending.append((name, *events))

    def device_ms(self) -> Dict[str, float]:
        """Device milliseconds per stage (waits for the recorded events)."""
        with self._lock:
            pending, self._pending = self._pending, []
        for name, start, end in pending:
            end.synchronize()
            with self._lock:
                self._device_totals[name] += start.elapsed_time(end)
        with self._lock:
            return dict(self._device_totals)

    def reset(self) -> None:
        self.device_ms()
        with self._lock:
            self.totals.clear()
            self.counts.clear()
            self._device_totals.clear()

    def report(self) -> str:
        dev = self.device_ms() if self.device.type == "cuda" else {}
        lines = ["stage                     total_s   calls   mean_ms  device_ms"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            d = f"{dev[name]:10.2f}" if name in dev else "         -"
            lines.append(f"{name:24s} {t:8.3f} {c:7d} {1000*t/c:9.2f} {d}")
        return "\n".join(lines)
