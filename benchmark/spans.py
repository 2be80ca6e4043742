"""The port's own spans (``compression_tpu_torch.util.profiling``) beside the
device: their totals over a window, the device time and idle gaps of a
traced phase by the span open where they arose, and the readers of the
metrics those give.

A span is any object with ``name``, ``start_ns``, ``end_ns``, ``thread``
(``threading.get_native_id()``) and ``pthread`` (``threading.get_ident()``),
as the port's ``Span`` has. The port opens ``pipeline/wait`` (the
dispatching thread waiting for the oldest batch), ``wait/device`` (a host
stage waiting on its batch's device event), the codec's stages
(``enc/*``, ``dec/*``), ``train/forward``, ``train/backward``,
``train/optimizer`` and ``hific/channel_norm``.

The join (checked on the card by ``tests/test_torch_cuda.py``): a device
activity (kernel, copy or fill) carries the correlation id of the CUDA
runtime or driver call that launched it (``cudaLaunchKernel``,
``cudaMemcpyAsync``, ...), a host event of the same profiler whose
``start_ns`` is the launch. That call's thread is found in this order:

1. the thread of the CPU op it was made under (the call's
   ``linked_correlation_id``), where the profiler records ops: the thread
   that runs the profiler and autograd's device thread, which runs
   ``loss.backward()``'s kernels. A thread that opened no span there (the
   latter) works for the dispatching thread, which waits on it, so the
   launch goes to the innermost span open on the dispatching thread;
2. else the thread the call's ``device_resource_id`` names, where that is a
   thread that opened spans. The profiler names a thread it does not follow
   (a pipeline worker) by its pthread ident cut to a signed 32-bit integer,
   and a thread it follows by its native id; so the name is resolved
   through the spans' ``thread`` and ``pthread``. Threads that share an
   ident never live at once: the one with a span open at the call made it;
3. else the ident the name stands for, learned from the calls under that
   name that only one thread could have made: the one thread, other than
   the dispatching thread, with a span open at the call. The profiler gives
   a worker's calls the native id of a thread it follows that has since
   taken the worker's pthread ident (autograd's device thread, in
   ``tests/test_torch_cuda.py``), and two pipeline workers may have spans
   open at once.

The launch goes to the innermost span open on that thread at that moment,
else it counts as ``no span``.

Each activity counts only the time no earlier one covers, as in
:mod:`benchmark.trace`, so a phase's device times add up to its busy time.
"""

from __future__ import annotations

import bisect
import re
from typing import Dict, Iterable, List, Optional, Tuple

from benchmark.trace import _union_gaps

NO_SPAN = "no span"
READ = ("pipeline/wait", "wait/device", "train/forward", "train/backward", "train/optimizer",
        "hific/channel_norm")  # the names the readers below read
_LAUNCH = re.compile(r"cu(da)?[A-Z]")  # cudaLaunchKernel, cudaMemcpyAsync, cuLaunchKernel


def totals(spans: Iterable) -> Dict[str, float]:
    """Seconds by span name."""
    out: Dict[str, float] = {}
    for s in spans:
        out[s.name] = out.get(s.name, 0.0) + (s.end_ns - s.start_ns) / 1e9
    return out


class _Timeline:
    """The innermost span open on one thread, piece by piece: spans on one
    thread nest."""

    def __init__(self, spans: List):
        edges = sorted([(s.start_ns, 1, -s.end_ns, s.name) for s in spans]
                       + [(s.end_ns, 0, 0, s.name) for s in spans])
        self.starts: List[int] = []
        self.ends: List[int] = []
        self.names: List[str] = []
        stack: List[str] = []
        at = None
        for t, opens, _, name in edges:
            if stack and at is not None and t > at:
                self.starts.append(at)
                self.ends.append(t)
                self.names.append(stack[-1])
            if opens:
                stack.append(name)
            else:
                del stack[len(stack) - 1 - stack[::-1].index(name)]
            at = t

    def at(self, t: int) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        return self.names[i] if i >= 0 and t < self.ends[i] else None

    def pieces(self, start: int, end: int) -> List[Tuple[str, int]]:
        """(innermost span or ``no span``, ns) over [start, end)."""
        out, at = [], start
        i = max(0, bisect.bisect_right(self.starts, start) - 1)
        while at < end and i < len(self.starts):
            s, e = self.starts[i], self.ends[i]
            if e > at:
                if s > at:
                    out.append((NO_SPAN, min(s, end) - at))
                    at = min(s, end)
                if at < end:
                    out.append((self.names[i], min(e, end) - at))
                    at = min(e, end)
            i += 1
        if at < end:
            out.append((NO_SPAN, end - at))
        return out


def attribute(device: List[Tuple[int, int, int]],
              launches: Dict[int, Tuple[int, int, Optional[int]]],
              spans: List, phases: Dict[str, Tuple[int, int]],
              dispatch_thread: int) -> Dict[str, Dict[str, Dict[str, float]]]:
    """Device seconds and idle seconds of each phase by program span.

    ``device``: (start_ns, end_ns, correlation id) of each device activity;
    ``launches``: correlation id -> (launch ns, thread the profiler names,
    thread of the CPU op it was made under or None);
    ``phases``: name -> (start_ns, end_ns); ``dispatch_thread``: the native
    id of the thread that runs the phase. Returns ``{phase: {"device":
    {span: s}, "idle": {span: s}}}``: idle gaps are split by the innermost
    span open on the dispatching thread.
    """
    by_thread: Dict[int, List] = {}
    ident: Dict[int, int] = {}
    for s in spans:
        by_thread.setdefault(s.thread, []).append(s)
        ident[s.thread] = s.pthread
    lines = {t: _Timeline(ss) for t, ss in by_thread.items()}
    sharing: Dict[int, List[int]] = {}
    for t, p in ident.items():
        sharing.setdefault(p, []).append(t)
    names = {**{_int32(p): p for p in sharing}, **ident}  # profiler's name -> ident
    dispatcher = lines.get(dispatch_thread)

    votes: Dict[int, Dict[int, int]] = {}
    for t, named, op_thread in launches.values():
        if op_thread is None and named not in names:
            candidates = [th for th, line in lines.items()
                          if th != dispatch_thread and line.at(t) is not None]
            if len(candidates) == 1:
                count = votes.setdefault(named, {})
                count[ident[candidates[0]]] = count.get(ident[candidates[0]], 0) + 1
    learned = {named: max(count, key=count.get) for named, count in votes.items()}

    def on(threads, t) -> Optional[str]:
        for thread in threads:
            name = lines[thread].at(t) if thread in lines else None
            if name is not None:
                return name
        return None

    def label(corr: int) -> str:
        launch = launches.get(corr)
        if launch is None:
            return NO_SPAN
        t, named, op_thread = launch
        if op_thread is not None:
            name = on([op_thread if op_thread in lines else dispatch_thread], t)
        elif named in names:
            name = on(sharing[names[named]], t)
        else:
            name = on(sharing[learned[named]], t) if named in learned else None
        return NO_SPAN if name is None else name

    out = {}
    ordered = sorted(device)
    for phase, (p_start, p_end) in phases.items():
        dev: Dict[str, float] = {}
        covered: List[Tuple[int, int]] = []
        end = float("-inf")
        for start, stop, corr in ordered:
            if not p_start <= start < p_end:
                continue
            own = max(0, stop - max(start, end)) / 1e9
            end = max(end, stop)
            covered.append((start, stop))
            name = label(corr)
            dev[name] = dev.get(name, 0.0) + own
        idle: Dict[str, float] = {}
        for g_start, g_end in _union_gaps(covered, p_start, p_end):
            pieces = (dispatcher.pieces(g_start, g_end) if dispatcher is not None
                      else [(NO_SPAN, g_end - g_start)])
            for name, ns in pieces:
                idle[name] = idle.get(name, 0.0) + ns / 1e9
        out[phase] = {"device": dev, "idle": idle}
    return out


def _int32(value: int) -> int:
    value &= 0xFFFFFFFF
    return value - (1 << 32) if value >= 1 << 31 else value


def join(prof) -> Tuple[List[Tuple[int, int, int]], Dict[int, Tuple[int, int, Optional[int]]]]:
    """The device activities of a finished ``torch.profiler`` run (the GPU
    ranges of ``record_function`` regions left out, as :mod:`benchmark.trace`
    does) and the runtime calls that launched them, as :func:`attribute`
    takes them. CPU ops are the host events with a thread: the profiler's
    own records (module loading, buffer requests) have none and reuse the
    ops' correlation ids."""
    from torch.autograd import DeviceType

    raw = list(prof.profiler.kineto_results.events())
    cpu = [e for e in raw if e.device_type() == DeviceType.CPU]
    cpu_names = {e.name() for e in cpu}
    calls = [e for e in cpu if _LAUNCH.match(e.name())]
    op_threads = {e.correlation_id(): e.device_resource_id() for e in cpu
                  if e.device_resource_id() and not _LAUNCH.match(e.name())}
    launches = {e.correlation_id(): (e.start_ns(), e.device_resource_id(),
                                     op_threads.get(e.linked_correlation_id())
                                     if e.linked_correlation_id() else None)
                for e in calls}
    device = [(k.start_ns(), k.start_ns() + k.duration_ns(), k.correlation_id())
              for k in raw if k.device_type() == DeviceType.CUDA and k.name() not in cpu_names]
    return device, launches


def by_span(prof, spans: List, phases: Dict[str, Tuple[int, int]],
            dispatch_thread: int) -> Dict[str, Dict[str, Dict[str, float]]]:
    """:func:`attribute` over a finished ``torch.profiler`` run."""
    return attribute(*join(prof), spans, phases, dispatch_thread)


def notes(attributed: Dict[str, Dict[str, Dict[str, float]]], top: int = 8) -> List[str]:
    """``traced <phase>: device by program span ...; idle by program span ...``"""
    def most(d):
        return ", ".join(f"{k} {v:.4f} s" for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top])
    return [f"traced {phase}: device by program span {most(a['device'])}; "
            f"idle by program span {most(a['idle'])}" for phase, a in attributed.items()]


# -- readers: None where the record holds nothing to read ----------------------


def _per(record: dict, key: str, phase: str, name: str, count) -> Optional[float]:
    by_name = (record.get(key) or {}).get(phase)
    if not by_name or name not in by_name or not count:
        return None
    return 1e3 * by_name[name] / count


def dispatch_wait_ms_per_img(record: dict, phase: str) -> Optional[float]:
    """ms an image the dispatching thread waited for the oldest batch
    (``pipeline/wait``) over the window's ``phase`` calls."""
    return _per(record, "span_s", phase, "pipeline/wait",
                record.get("window_images", {}).get(phase))


def device_wait_ms_per_img(record: dict, phase: str) -> Optional[float]:
    """ms an image the host stages waited on their batch's device event
    (``wait/device``) over the window's ``phase`` calls."""
    return _per(record, "span_s", phase, "wait/device",
                record.get("window_images", {}).get(phase))


def train_span_ms(record: dict, name: str) -> Optional[float]:
    """ms a step in ``train/<name>`` over the window's steps."""
    return _per(record, "span_s", "train", f"train/{name}", record.get("train_steps"))


def channel_norm_ms_per_img(record: dict, phase: str) -> Optional[float]:
    """Device ms an image attributed to ``hific/channel_norm`` in the traced
    ``phase``."""
    t = record.get("traffic", {})
    return _per(record, "span_device_s", phase, "hific/channel_norm",
                t.get("round_batches", 0) * t.get("batch", 0))
