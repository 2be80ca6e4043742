"""Stage timing (counterpart of ``compression_tpu/util/profiling.py``
``StageTimer``; the JAX version's ``trace``/``annotate`` are not ported yet).

Each stage is timed on the host clock. On a CUDA device it is also bracketed
by two ``torch.cuda.Event``s on the current stream, so the device time of
the work the stage enqueued is known too; those events are read lazily, in
``report()``/``device_ms()``, so timing never blocks the pipeline.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Tuple

import torch

__all__ = ["StageTimer"]


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
