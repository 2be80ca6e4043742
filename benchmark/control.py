"""The control of ``correct``, and the readings of planted faults, at a
cell's own size on the card:

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

The control is the reference put in the program's place and computed in
the precision below the one the configuration states: TF32 for float32
with TF32 off. It is judged by the cell's own comparison against the
reference in float32, and each run prints the numbers the cell compares;
a limit has to lie below every control reading. A codec cell judges as
many images as a run samples; a training cell its three steps, and also
reads the fault of half the batch left out (the reference on half of
each batch, in float32); a codec cell also reads the fault of sigma about
doubled. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def codec_readings(cfg, wl, seed, device):
    """The control's numbers, and ``y_rate_gap`` of the fault of sigma
    about doubled (each row six levels up), planted in the reference put
    in the program's place: its y costed at the shifted rows against the
    reference's at its own. Both in the cell's format with the flush at
    its mean for each y stream (a rANS lane 24 bits, a range-coded stream
    36)."""
    import torch

    from benchmark import judge, weights
    from benchmark.reference import entropy
    from benchmark.reference.codec import ReferenceCodec
    from benchmark.traffic import images

    t = wl["traffic"]
    n = wl["correct"]["sample_batches"] * t["batch"]
    pool = images.structured_pool(t["pool"], t["height"], t["width"], seed, device)
    ref = ReferenceCodec(cfg, weights.load(cfg, seed, device), device)
    want = ref.expected(pool[:n])
    got = ref.expected(pool[:n], tf32=True)
    streams = n * len(want.streams)
    if t["coder"] == "device":
        escape, fixed = entropy.rans_escape_bits, streams * 24.0 * 128
    else:
        escape, fixed = entropy.range_escape_bits, streams * judge.RANGE_FLUSH_BITS

    def bits(exp, shift=0):
        rows = torch.clamp(entropy.scale_rows(exp.sigma) + shift, max=entropy.SCALES_LEVELS - 1)
        return float(entropy.y_coded_bits(ref.y_tables, exp.y_symbols, rows, escape).sum()) + fixed

    expected = bits(want)
    control = judge.codec_numbers(
        got.images.cpu().numpy(), got.z_symbols.cpu().numpy(),
        want.images.cpu().numpy(), want.z_symbols.cpu().numpy())
    control["y_rate_gap"] = abs(bits(got) - expected) / expected
    return {"control": control,
            "sigma_doubled": {"y_rate_gap": abs(bits(want, 6) - expected) / expected}}


def training_readings(cfg, wl, seed, device):
    import torch

    from benchmark import judge, weights
    from benchmark.reference import train
    from benchmark.traffic import images

    t = wl["traffic"]
    flat = weights.load(cfg, seed, device)
    pool = images.structured_pool(t["pool"], t["height"], t["width"], seed, device)
    crops = images.Crops(pool, t["batch"], t["patch"], seed, t["augment"])
    batches = [torch.as_tensor(crops.next(), device=device) for _ in range(3)]

    def steps(batch_list, tf32=False):
        losses, grads, params, _adam = train.run_steps(
            cfg, flat, batch_list, torch.Generator(device).manual_seed(seed), 3, tf32)
        return {"losses": losses, "grads": grads,
                "change": {k: params[k] - flat[k] for k in params}}

    # A window step: one more step from the reference's state after three,
    # on a fourth batch with noise from its own generator.
    _l, _g, start, adam = train.run_steps(
        cfg, flat, batches, torch.Generator(device).manual_seed(seed), 3)
    fourth = torch.as_tensor(crops.next(), device=device)

    def window_step(batch, tf32=False):
        losses, grads, params, _adam = train.run_steps(
            cfg, start, [batch], torch.Generator(device).manual_seed(seed + 1), 1, tf32,
            adam_state=adam)
        return {"losses": losses, "grads": grads,
                "change": {k: params[k] - start[k] for k in params}}

    ref = steps(batches)
    win_ref = window_step(fourth)
    out = {}
    for name, prog, win in (
            ("control", steps(batches, tf32=True), window_step(fourth, tf32=True)),
            ("half_batch", steps([b[: len(b) // 2] for b in batches]),
             window_step(fourth[: len(fourth) // 2]))):
        out[name] = judge.training_numbers(prog, ref)[0]
        out[name].update(judge.window_numbers(win, win_ref)[0])
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    man = harness.manifest()
    entry = next(w for w in man["workloads"] if w["name"] == args.workload)
    wl = harness.load_json(harness.HERE / "workloads" / f"{entry['name']}.json")
    cfg = harness.load_json(harness.HERE / "configs" / f"{entry['config']}.json")
    readings = training_readings if wl["driver"] == "train_step" else codec_readings
    for seed in args.seeds:
        out = readings(cfg, wl, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
