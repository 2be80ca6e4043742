"""train_step: the port's training step, driven as its own training loop
drives it, on crops of a pool of seeded images.

Set-up builds one training state (the model from the configuration's
weights, Adam, the loss, a noise generator seeded from ``--seed``) and
drives it through its first ``warmup_steps`` steps with the window's own
call and feed; the window then takes the same state on. Each step draws
``batch`` random ``patch`` x ``patch`` crops (with a random dihedral
transform) of the pool on the host, copies them to the card through pinned
memory and calls the port's ``train_step``. ``train_img_s`` is ``batch``
times the steps the window enqueued, over the time from the first step's
feed to the device finishing the last step.

Correctness: the reference runs the first three steps from the same
parameters, batches and noise; each step's loss, the first gradient (as
Adam's first moment holds it after one step) and the parameters' change
over the three steps are compared (:func:`benchmark.judge.training_numbers`).
One step of the window, drawn from the seed among its first
``check_window_steps``, is checked too: the parameters, Adam's moments and
count, the batch and the noise generator's state are copied before it and
the parameters after it, and the reference takes that one step from the
copy (the program's own state: the first three steps check how it starts);
its loss and the parameters' change are compared
(:func:`benchmark.judge.window_numbers`).

With ``--trace 1`` the port's spans are recorded over the window's steps
(their totals by name, ``span_s``), and ``traced_steps`` more steps run
under the profiler after the window, their device time by the port's span
that launched it (``span_device_s``); with ``--trace 0`` nothing is
recorded.
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch

from benchmark import harness, judge, program, spans, trace, weights
from benchmark.harness import Context, Outcome
from benchmark.reference import train as reference
from benchmark.traffic import images

CHECK_STEPS = 3


def flax_name(name: str) -> str:
    """A port parameter's name -> the weights dict's (a kernel's layout
    differs; its norm does not)."""
    parts = name.split(".")
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return "/".join(parts)


def flax_layout(value: torch.Tensor) -> torch.Tensor:
    """A port tensor in the weights dict's layout: a kernel
    ``(cout, cin, kh, kw)`` as ``(kh, kw, cin, cout)``."""
    return value.permute(2, 3, 1, 0) if value.ndim == 4 else value


def _moment(opt_state, key, p):
    value = opt_state[key]
    return torch.zeros_like(p) if value is None else value.clone()


class _Snapshot:
    """The training state around one window step, copied on the device (no
    host sync): parameters, Adam's moments and count, the batch and the
    noise generator's state before; parameters and loss after."""

    def __init__(self, state, params, batch):
        opt = state.optimizer.state
        zeros = {"exp_avg": None, "exp_avg_sq": None, "step": 0}  # Adam has not stepped
        self.before = {k: p.detach().clone() for k, p in params.items()}
        self.m = {k: _moment(opt.get(p, zeros), "exp_avg", p) for k, p in params.items()}
        self.v = {k: _moment(opt.get(p, zeros), "exp_avg_sq", p) for k, p in params.items()}
        count = opt.get(next(iter(params.values())), zeros)["step"]
        self.count = count.clone() if torch.is_tensor(count) else count
        self.batch = batch
        self.noise = state.generator.get_state()
        self.after = self.loss = None

    def close(self, params, loss):
        self.after = {k: p.detach().clone() for k, p in params.items()}
        self.loss = loss.detach()


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _plant(state, faults):
    if "state_unchanged" in faults:
        state.optimizer.step = lambda *a, **k: None
    if "half_batch" in faults:
        upload = state.upload
        state.upload = lambda batch: upload(batch[: len(batch) // 2])


def run(ctx: Context) -> Outcome:
    t = ctx.workload["traffic"]
    dev = ctx.device
    cfg = ctx.config
    if t["warmup_steps"] < CHECK_STEPS:
        raise ValueError(f"warmup_steps must be at least {CHECK_STEPS}")

    flat = weights.load(cfg, ctx.seed, dev)
    noise = torch.Generator(dev).manual_seed(int(ctx.seed))
    state = program.Training(cfg, program.build_model(cfg, flat), dev, noise)
    params = dict(state.model.named_parameters())
    for name in params:
        if flax_name(name) not in flat:
            raise KeyError(f"the port's parameter {name} has no weight {flax_name(name)}")
    pool = images.structured_pool(t["pool"], t["height"], t["width"], ctx.seed, dev)
    crops = images.Crops(pool, t["batch"], t["patch"], ctx.seed, t["augment"])
    _plant(state, ctx.faults)

    before = {k: p.detach().clone() for k, p in params.items()}
    check_batches, losses, first_grads, after = [], [], None, None
    b1 = state.optimizer.param_groups[0]["betas"][0]
    for i in range(t["warmup_steps"]):
        batch = crops.next()
        loss, _metrics = state.step(batch)
        if i < CHECK_STEPS:
            check_batches.append(batch)
            losses.append(loss.detach())
        if i == 0:
            first_grads = {k: (state.optimizer.state[p]["exp_avg"] / (1 - b1)).clone()
                           if p in state.optimizer.state else torch.zeros_like(p)
                           for k, p in params.items()}
        if i == CHECK_STEPS - 1:
            after = {k: p.detach().clone() for k, p in params.items()}
    _sync(dev)
    setup_s = time.perf_counter() - ctx.t_start
    launches0 = program.launches()

    if "window_state_unchanged" in ctx.faults:  # a step that fails only once warm
        state.optimizer.step = lambda *a, **k: None
    check_at = int(np.random.default_rng([ctx.seed, 2]).integers(t["check_window_steps"]))
    snap = None
    steps, enqueue_s = 0, 0.0
    chunk_rates = []
    recording = program.spans if ctx.trace else contextlib.nullcontext
    probe0 = harness.host_probe_ms()
    start = time.perf_counter()
    chunk_t = start
    with recording() as window_spans:
        while time.perf_counter() - start < ctx.seconds or steps <= check_at:
            batch = crops.next()
            t0 = time.perf_counter()
            if steps == check_at:
                snap = _Snapshot(state, params, batch)
            loss, _metrics = state.step(batch)
            if steps == check_at:
                snap.close(params, loss)
            enqueue_s += time.perf_counter() - t0
            steps += 1
            if steps % 100 == 0:  # images a second over each 100 steps, as enqueued
                now = time.perf_counter()
                chunk_rates.append(100 * t["batch"] / (now - chunk_t))
                chunk_t = now
    _sync(dev)
    window_s = time.perf_counter() - start
    launches = {k: v - launches0[k] for k, v in program.launches().items()}
    end_to_end = {"setup_s": setup_s, "train_img_s": t["batch"] * steps / window_s}
    notes = [f"window {window_s:.3f} s: {steps} steps of {t['batch']} crops of "
             f"{t['patch']}x{t['patch']}; host enqueue {1e3 * enqueue_s / steps:.3f} ms a step",
             "launches in the window: " + ", ".join(f"{k} {v}" for k, v in launches.items()),
             harness.spread_note("img/s by 100 steps enqueued", chunk_rates)
             + f"; host probe {probe0:.2f} ms before, {harness.host_probe_ms():.2f} after"]
    record = {"cfg": cfg, "traffic": t, "train_enqueue_s": enqueue_s, "train_steps": steps}
    busy_s = traced_s = breakdown = None
    if ctx.trace:
        record["span_s"] = {"train": spans.totals(window_spans)}
        rec = trace.Recorder(dev)
        with program.spans() as port_spans, rec.record(), rec.span("phase:train"):
            for _ in range(t["traced_steps"]):
                with rec.span("feed"):
                    batch = crops.next()
                with rec.span("train_step"):
                    state.step(batch)
            _sync(dev)
        phases = rec.phases()
        attributed = spans.by_span(rec.prof, port_spans, rec.bounds(), threading.get_native_id())
        record["span_device_s"] = {phase: a["device"] for phase, a in attributed.items()}
        record["phases"] = phases
        record["phase_steps"] = {"train": t["traced_steps"]}
        busy_s = sum(p.busy_s for p in phases.values())
        traced_s = sum(p.wall_s for p in phases.values())
        breakdown = trace.breakdown(phases)
        for p in phases.values():
            notes.append(f"traced {p.name}: wall {p.wall_s:.4f} s, busy {p.busy_s:.4f} s, "
                         f"{p.activities} device activities; " + ", ".join(
                             f"{k} {v:.4f} s" for k, v in p.by_kind_s.items() if v))
        notes.extend(spans.notes(attributed))
    peak = torch.cuda.max_memory_allocated(dev) if torch.device(dev).type == "cuda" else 0

    prog = {"losses": [float(v) for v in losses],
            "grads": {flax_name(k): v for k, v in first_grads.items()},
            "change": {flax_name(k): after[k] - before[k] for k in after}}
    win = {"losses": [float(snap.loss)],
           "change": {flax_name(k): snap.after[k] - snap.before[k] for k in snap.after}}
    start_state = {flax_name(k): flax_layout(v) for k, v in snap.before.items()}
    adam_state = {"m": {flax_name(k): flax_layout(v) for k, v in snap.m.items()},
                  "v": {flax_name(k): flax_layout(v) for k, v in snap.v.items()},
                  "count": int(snap.count)}
    win_batch, win_noise = snap.batch, snap.noise
    del state, params, before, after, first_grads, pool, snap
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    ref_batches = [torch.as_tensor(b, device=dev) for b in check_batches]
    ref_losses, ref_grads, ref_params, _adam = reference.run_steps(
        cfg, flat, ref_batches, torch.Generator(dev).manual_seed(int(ctx.seed)), CHECK_STEPS)
    ref = {"losses": ref_losses, "grads": ref_grads,
           "change": {k: ref_params[k] - flat[k] for k in ref_params}}
    numbers, judged = judge.training_numbers(prog, ref)
    win_gen = torch.Generator(dev)
    win_gen.set_state(win_noise)
    win_losses, win_grads, win_params, _adam = reference.run_steps(
        cfg, start_state, [torch.as_tensor(win_batch, device=dev)], win_gen, 1,
        adam_state=adam_state)
    win_ref = {"losses": win_losses, "grads": win_grads,
               "change": {k: win_params[k] - start_state[k] for k in win_params}}
    win_numbers, win_judged = judge.window_numbers(win, win_ref)
    numbers.update(win_numbers)
    notes.append("judged: " + ", ".join(f"{k} {v:.6g}" for k, v in numbers.items()))
    notes.extend(judged)
    notes.append(f"window step {check_at}: " + win_judged)
    return Outcome(attempted=steps, failed=0, end_to_end=end_to_end,
                   checks=judge.training(numbers, ctx.workload), record=record,
                   memory_peak_bytes=peak, busy_s=busy_s, window_s=traced_s,
                   breakdown=breakdown, notes=notes)
