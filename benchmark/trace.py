"""The traced part of a run: host spans the benchmark opens around its calls
into the program, and the device's activities from ``torch.profiler``.

Adapted from the repository's on-card profiler: device activities are the
kernels, copies and fills (the GPU ranges of ``record_function``
annotations are not activities); busy time is the union of their
intervals; each activity is classed by its kernel's name (K1, the general
GDN kernel, K3, K2, copies) or by the CPU ops it was launched under,
innermost first (Adam, K1's backward, convolutions backward and forward),
then by cuDNN's kernel names, else ``other``: a kernel launched where the
profiler records no CPU op (a worker thread of the codec's pipeline), or
linked to ops that name no class, is classed by its name alone. Each
activity counts only the time no earlier one covers, so the kinds add up
to the busy time. The host spans are the benchmark's own, taken on the
wall clock in any thread, which the profiler's timestamps also count in.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

KINDS = ("conv_forward", "conv_backward", "K1", "gdn_general", "gdn_backward", "adam",
         "K3", "K2", "copies", "other")


def kind_of(kernel: str, ops: List[str]) -> str:
    low, chain = kernel.lower(), " ".join(ops)
    for kind, parts in (("gdn_general", ("gdn_general_kernel", "gdn_general_tma_kernel")),
                        ("K1", ("gdn_kernel",)),
                        ("K3", ("rans_fields", "rans_encode")),
                        ("K2", ("rans_decode",)), ("copies", ("memcpy", "memset"))):
        if any(part in low for part in parts):
            return kind
    for kind, parts in (("adam", ("Optimizer.step",)),
                        ("gdn_backward", ("FusedGDNBackward",)),
                        ("conv_backward", ("convolution_backward",)),
                        ("conv_forward", ("aten::convolution", "aten::conv2d"))):
        if any(part in chain for part in parts):
            return kind
    # cuDNN's convolution kernels by name, where the ops name no class: no
    # CPU op recorded (a pipeline worker thread), or a few launches a traced
    # round that the profiler links to its own ``Buffer Flush`` or to a
    # convolution op without the ``aten::convolution`` above it.
    for kind, parts in (("conv_backward", ("dgrad", "wgrad")),
                        ("conv_forward", ("fprop", "convolve", "winograd", "fft",
                                          "nhwctonchw", "nchwtonhwc"))):
        if any(part in low for part in parts):
            return kind
    return "other"


@dataclass
class Phase:
    """What the device did during one phase span."""
    name: str
    wall_s: float
    busy_s: float = 0.0
    by_kind_s: Dict[str, float] = field(default_factory=lambda: dict.fromkeys(KINDS, 0.0))
    by_kernel_s: Dict[str, float] = field(default_factory=dict)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    activities: int = 0


def _union_gaps(intervals, start, end):
    """Gaps in [start, end] not covered by the sorted intervals."""
    gaps, at = [], start
    for s, e in intervals:
        if s > at:
            gaps.append((at, min(s, end)))
        at = max(at, e)
        if at >= end:
            break
    if at < end:
        gaps.append((at, end))
    return [(s, e) for s, e in gaps if e > s]


class Recorder:
    """Profiles what runs inside :meth:`record`, with the host spans opened
    by :meth:`span` in any thread meanwhile; :meth:`phases` reads both."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.prof = None
        self.spans: list = []
        self._recording = threading.Event()

    @contextlib.contextmanager
    def span(self, name: str):
        """A host span (``phase:<name>`` marks a phase), kept while recording."""
        start = time.time_ns()
        try:
            yield
        finally:
            if self._recording.is_set():
                self.spans.append((start, time.time_ns(), name))

    @contextlib.contextmanager
    def record(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.cuda:
            activities.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self.spans.clear()
        self._recording.set()
        try:
            with profile(activities=activities) as prof:
                yield
                if self.cuda:
                    torch.cuda.synchronize()
        finally:
            self._recording.clear()
        self.prof = prof

    def bounds(self) -> Dict[str, Tuple[int, int]]:
        """(start_ns, end_ns) of each phase span, by phase."""
        return {name[len("phase:"):]: (start, end) for start, end, name in self.spans
                if name.startswith("phase:")}

    def phases(self) -> Dict[str, Phase]:
        from torch.autograd import DeviceType

        prof = self.prof
        events = prof.events()
        cpu_names = {e.name for e in events if e.device_type == DeviceType.CPU}
        ops = {e.id: e for e in events if e.device_type == DeviceType.CPU and e.kernels}
        raw = list(prof.profiler.kineto_results.events())
        device = sorted((k.start_ns(), k.start_ns() + k.duration_ns(), k.name(),
                         k.linked_correlation_id())
                        for k in raw
                        if k.device_type() == DeviceType.CUDA and k.name() not in cpu_names)
        spans = self.spans
        host = sorted((s for s in spans if not s[2].startswith("phase:")),
                      key=lambda s: s[0])
        out = {}
        for p_start, p_end, p_name in spans:
            if not p_name.startswith("phase:"):
                continue
            phase = Phase(p_name[len("phase:"):], (p_end - p_start) / 1e9)
            inside = [d for d in device if p_start <= d[0] < p_end]
            covered, end = [], float("-inf")
            for start, stop, name, linked in inside:
                own = max(0, stop - max(start, end)) / 1e9
                covered.append((start, stop))
                end = max(end, stop)
                chain, parent = [], ops.get(linked)
                while parent is not None:
                    chain.append(parent.name)
                    parent = parent.cpu_parent
                kind = kind_of(name, chain)
                phase.by_kind_s[kind] += own
                phase.by_kernel_s[name] = phase.by_kernel_s.get(name, 0.0) + own
            phase.busy_s = sum(phase.by_kind_s.values())
            phase.activities = len(inside)
            for g_start, g_end in _union_gaps(covered, p_start, p_end):
                mid = (g_start + g_end) / 2
                open_spans = [s for s in host if s[0] <= mid <= s[1]]
                label = open_spans[-1][2] if open_spans else "no span"
                phase.idle_gaps.append((label, (g_end - g_start) / 1e9))
            out[phase.name] = phase
        return out


def breakdown(phases: Dict[str, Phase], top: int = 10) -> dict:
    """The device operations that took most time and the longest idle
    gaps, over the traced phases, each list at most ``top`` long: kernels by
    name, gaps summed by the host span open at their middle."""
    kernels: Dict[str, float] = {}
    gaps: Dict[str, float] = {}
    for p in phases.values():
        for name, s in p.by_kernel_s.items():
            kernels[name] = kernels.get(name, 0.0) + s
        for label, s in p.idle_gaps:
            key = f"{p.name}:{label}"
            gaps[key] = gaps.get(key, 0.0) + s
    return {
        "device_ops": [[n[:160], s] for n, s in sorted(kernels.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[n, s] for n, s in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]],
    }
