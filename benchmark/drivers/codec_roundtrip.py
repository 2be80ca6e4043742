"""codec_roundtrip: a closed loop of one client that compresses and then
decompresses rounds of image batches through the codec's pipelined
iterators.

Each round compresses ``round_batches`` batches of ``batch`` images through
``compress_iter(depth, coder)``, then decodes those blobs through
``decompress_iter(depth)``; the batches cycle through a pool of ``pool``
images drawn from the seed. Rounds start until ``--seconds`` have passed.
``compress_img_s`` is every image compressed over the summed wall time of
the compress phases, ``decompress_img_s`` likewise, and ``decode_p95_ms``
the 95th percentile over every decode batch of the time from when the
pipeline takes its blobs to when it yields its images (also in the record,
for a cell that reports it per layer).

Correctness: every batch must come back decoded, at its shape, without an
error; a sample of the decoded batches drawn from the seed is then held
against the reference (:mod:`benchmark.judge`). With ``--trace 1`` the
port's spans are recorded over the window's calls (their totals by name and
phase, ``span_s``), and one more round runs under the profiler after the
window, the device time of each phase by the port's span that launched it
(``span_device_s``); with ``--trace 0`` nothing is recorded.
"""

from __future__ import annotations

import contextlib
import statistics
import sys
import threading
import time

import numpy as np
import torch

from benchmark import harness, judge, program, spans, trace, weights
from benchmark.harness import Context, Outcome
from benchmark.reference import models
from benchmark.traffic import images


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class _Reservoir:
    """A uniform sample of ``size`` items of a stream, from ``rng``."""

    def __init__(self, size, rng):
        self.size, self.rng, self.seen, self.items = size, rng, 0, []

    def offer(self, item_fn):
        if self.seen < self.size:
            self.items.append(item_fn())
        else:
            j = int(self.rng.integers(self.seen + 1))
            if j < self.size:
                self.items[j] = item_fn()
        self.seen += 1


def _plant(codec, faults, rows):
    """Faults the harness's own tests plant in the timed path. ``rows``
    names the codec's method that gives (..., CDF rows) to both its encoder
    and its decoder: the family adapter's ``ROWS``."""
    if "half_batch" in faults:
        iterate = codec.compress_iter

        def half(batches, depth=2, coder="host"):
            for blobs in iterate(batches, depth, coder):
                yield blobs[: len(blobs) // 2]
        codec.compress_iter = half
    if "altered_answer" in faults:
        iterate = codec.compress_iter

        def altered(batches, depth=2, coder="host"):
            for blobs in iterate(batches, depth, coder):
                b = bytearray(blobs[0])
                b[len(b) // 3] ^= 0x5A
                yield [bytes(b)] + blobs[1:]
        codec.compress_iter = altered
    if "sigma_doubled" in faults:
        # Each y element's CDF row six levels of the log table up (sigma
        # about doubled), on both sides, so the round trip still holds.
        rows_of = getattr(codec, rows)

        def shifted(*args, **kwargs):
            *rest, r = rows_of(*args, **kwargs)
            return (*rest, torch.clamp(r.to(torch.int32) + 6, max=63).to(r.dtype))
        setattr(codec, rows, shifted)


@contextlib.contextmanager
def _stage_spans(codec, rec):
    """Host spans around each of the codec's timed stages."""
    stage = codec.timer.stage

    @contextlib.contextmanager
    def traced(name):
        with rec.span(name), stage(name):
            yield
    codec.timer.stage = traced
    try:
        yield
    finally:
        codec.timer.stage = stage


def run(ctx: Context) -> Outcome:
    t = ctx.workload["traffic"]
    batch, height, width = t["batch"], t["height"], t["width"]
    depth, coder, per_round = t["depth"], t["coder"], t["round_batches"]
    dev = ctx.device

    flat = weights.load(ctx.config, ctx.seed, dev)
    codec = program.build_codec(ctx.config, program.build_model(ctx.config, flat), dev)
    pool = images.structured_pool(t["pool"], height, width, ctx.seed, dev)

    # The batches of one cycle through the pool, made once: batch i takes
    # images i * batch ... i * batch + batch - 1 of the pool, modulo its size.
    cycle = np.lcm(len(pool), batch) // batch
    made = [pool[[(i * batch + j) % len(pool) for j in range(batch)]] for i in range(cycle)]

    def batches(first, count):
        return [made[i % cycle] for i in range(first, first + count)]

    # Warm-up: the cell's one shape through both pipelines, deep enough to
    # fill them.
    warm = list(codec.compress_iter(batches(0, t["warmup_batches"]), depth, coder))
    for _ in codec.decompress_iter(warm, depth):
        pass
    _sync(dev)
    setup_s = time.perf_counter() - ctx.t_start
    launches0 = program.launches()
    codec.timer.reset()
    _plant(codec, ctx.faults, getattr(program.family(ctx.config), "ROWS", "_mu_rows"))

    recording = program.spans if ctx.trace else contextlib.nullcontext
    closed = {"compress": [], "decompress": []}  # the port's spans of the window's calls
    rng = np.random.default_rng([ctx.seed, 1])
    sample = _Reservoir(ctx.workload["correct"]["sample_batches"], rng)
    attempted = failed = rounds = 0
    comp_s = dec_s = 0.0
    comp_images = dec_images = 0
    latencies, round_rates = [], {"compress": [], "decompress": []}
    probe0 = harness.host_probe_ms()
    start = time.perf_counter()
    while time.perf_counter() - start < ctx.seconds:
        first = rounds * per_round
        work = batches(first, per_round)
        attempted += per_round
        t0 = time.perf_counter()
        with recording() as port_spans:
            blobs = list(codec.compress_iter(work, depth, coder))
        comp_s += time.perf_counter() - t0
        closed["compress"].append(port_spans)
        round_rates["compress"].append(per_round * batch / (time.perf_counter() - t0))
        comp_images += sum(len(b) for b in blobs)
        taken = []

        def feed():
            for b in blobs:
                taken.append(time.perf_counter())
                yield b

        got = 0
        t0 = time.perf_counter()
        with recording() as port_spans:
            try:
                for i, out in enumerate(codec.decompress_iter(feed(), depth)):
                    latencies.append(time.perf_counter() - taken[i])
                    got += 1
                    if out.shape != work[i].shape or out.dtype != np.uint8:
                        failed += 1
                        continue
                    dec_images += len(out)
                    sample.offer(lambda i=i, out=out: (work[i], blobs[i], out))
            except Exception as e:  # a decode that fails: its batch and the rest never come
                print(f"round {rounds}: decode failed after {got} batches: {e!r}",
                      file=sys.stderr)
        dec_s += time.perf_counter() - t0
        closed["decompress"].append(port_spans)
        round_rates["decompress"].append(per_round * batch / (time.perf_counter() - t0))
        failed += per_round - got
        rounds += 1
    window_s = time.perf_counter() - start
    _sync(dev)
    end_to_end = {"setup_s": setup_s,
                  "compress_img_s": comp_images / comp_s,
                  "decompress_img_s": dec_images / dec_s if dec_images else float("nan")}
    if len(latencies) >= 2:
        end_to_end["decode_p95_ms"] = 1e3 * statistics.quantiles(latencies, n=100)[94]
    host = codec.timer.totals
    launches = {k: v - launches0[k] for k, v in program.launches().items()}
    notes = [
        f"window {window_s:.3f} s: {rounds} rounds of {per_round} batches of {batch}; "
        f"compress {comp_images} images in {comp_s:.4f} s, decompress {dec_images} in "
        f"{dec_s:.4f} s; {len(latencies)} decode batches, median "
        f"{1e3 * statistics.median(latencies) if latencies else float('nan'):.3f} ms",
        "launches in the window: " + ", ".join(f"{k} {v}" for k, v in launches.items()),
        "img/s by round, " + "; ".join(harness.spread_note(k, v) for k, v in round_rates.items())
        + f"; host probe {probe0:.2f} ms before, {harness.host_probe_ms():.2f} after",
    ]
    record = {
        "cfg": ctx.config, "traffic": t,
        "host_s": {"compress": sum(v for k, v in host.items() if k.startswith("enc/")),
                   "decompress": sum(v for k, v in host.items() if k.startswith("dec/"))},
        "window_images": {"compress": comp_images, "decompress": dec_images},
        "decode_p95_ms": end_to_end.get("decode_p95_ms"),
    }
    busy_s = traced_s = breakdown = None
    if ctx.trace:
        # Every name, so that a span a family adds is read by a metric file alone.
        record["span_s"] = {phase: spans.totals(s for lst in lists for s in lst)
                            for phase, lists in closed.items()}
        rec = trace.Recorder(dev)
        work = batches(rounds * per_round, per_round)
        with program.spans() as port_spans, _stage_spans(codec, rec), rec.record():
            with rec.span("phase:compress"):
                blobs = list(codec.compress_iter(work, depth, coder))
            with rec.span("phase:decompress"):
                for _ in codec.decompress_iter(blobs, depth):
                    pass
        phases = rec.phases()
        attributed = spans.by_span(rec.prof, port_spans, rec.bounds(), threading.get_native_id())
        record["span_device_s"] = {phase: a["device"] for phase, a in attributed.items()}
        record["phases"] = phases
        streams = models.y_streams(ctx.config)
        record["y_words"] = (sum(judge.y_words(b, streams) for bl in blobs for b in bl)
                             if coder == "device" else None)
        busy_s = sum(p.busy_s for p in phases.values())
        traced_s = sum(p.wall_s for p in phases.values())
        breakdown = trace.breakdown(phases)
        for p in phases.values():
            notes.append(f"traced {p.name}: wall {p.wall_s:.4f} s, busy {p.busy_s:.4f} s, "
                         f"{p.activities} device activities; " + ", ".join(
                             f"{k} {v:.4f} s" for k, v in p.by_kind_s.items() if v))
        notes.extend(spans.notes(attributed))
    peak = torch.cuda.max_memory_allocated(dev) if torch.device(dev).type == "cuda" else 0

    # The program's state goes before the reference runs.
    items = sample.items
    del codec, pool, made, blobs, warm
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    checks, judged = judge.codec(ctx.config, flat, dev, items, ctx.workload)
    notes.extend(judged)
    return Outcome(attempted=attempted, failed=failed, end_to_end=end_to_end, checks=checks,
                   record=record, memory_peak_bytes=peak, busy_s=busy_s,
                   window_s=traced_s, breakdown=breakdown, notes=notes)
