"""What the per-layer metrics' readers share: the reductions from a run's
record (the traced phases, the window's host totals) to a number. A reader
that finds nothing to read returns None and its metric is left out of the
line; a roofline share is never made up as 0.

Shares are in percent. A traced codec phase runs ``round_batches`` batches
of ``batch`` images at ``height`` x ``width``; a traced training phase
``traced_steps`` steps of ``batch`` crops of ``patch`` x ``patch``.
"""

from __future__ import annotations

from typing import Optional

from benchmark.roofline import conv, k1, models, peaks, rans


def _phase(record: dict, phase: str):
    """The traced phase, if the device ran anything in it."""
    p = record.get("phases", {}).get(phase)
    return p if p is not None and p.activities else None


def _shape(record: dict, phase: str):
    """(images a call, height, width, calls in the traced phase)."""
    t = record["traffic"]
    if phase == "train":
        return t["batch"], t["patch"], t["patch"], record["phase_steps"]["train"]
    return t["batch"], t["height"], t["width"], t["round_batches"]


def _share(bound_s: float, time_s: float) -> Optional[float]:
    return 100.0 * bound_s / time_s if time_s > 0 and bound_s > 0 else None


def idle_share(record: dict, phase: str) -> Optional[float]:
    p = _phase(record, phase)
    return None if p is None else 100.0 * (1.0 - p.busy_s / p.wall_s)


def mfu(record: dict, phase: str) -> Optional[float]:
    p = _phase(record, phase)
    if p is None:
        return None
    n, h, w, calls = _shape(record, phase)
    flops = calls * models.model_flops(record["cfg"], phase, n, h, w)
    return 100.0 * flops / p.wall_s / peaks.FP32_FLOPS


def conv_roofline(record: dict, phase: str) -> Optional[float]:
    p = _phase(record, phase)
    if p is None:
        return None
    n, h, w, calls = _shape(record, phase)
    bound = calls * sum(conv.conv_bound_s(layer.flops(), layer.bytes())
                        for layer in models.phase_layers(record["cfg"], phase, n, h, w)
                        if layer.kind == "conv")
    return _share(bound, p.by_kind_s["conv_forward"])


def k1_roofline(record: dict, phase: str) -> Optional[float]:
    p = _phase(record, phase)
    if p is None:
        return None
    n, h, w, calls = _shape(record, phase)
    bound = calls * sum(k1.bound_s(layer.n * layer.h * layer.w, layer.cin)
                        for layer in models.phase_layers(record["cfg"], phase, n, h, w)
                        if layer.kind == "gdn")
    return _share(bound, p.by_kind_s["K1"])


def rans_roofline(record: dict, phase: str, decode: bool) -> Optional[float]:
    p = _phase(record, phase)
    if p is None or record.get("y_words") is None:
        return None
    n, h, w, calls = _shape(record, phase)
    elements = (h // 16) * (w // 16) * record["cfg"]["widths"]["num_latents"]
    bound = rans.bound_s(n * calls, elements, record["y_words"], decode)
    return _share(bound, p.by_kind_s["K2" if decode else "K3"])


def host_ms_per_img(record: dict, phase: str) -> Optional[float]:
    images = record.get("window_images", {}).get(phase)
    return 1e3 * record["host_s"][phase] / images if images else None


def host_enqueue_ms(record: dict) -> Optional[float]:
    steps = record.get("train_steps")
    return 1e3 * record["train_enqueue_s"] / steps if steps else None
