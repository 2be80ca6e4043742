"""On-card smoke run of the PyTorch/CUDA port: bmshj2018 at full width.

    python3 chip_smoke.py [--batches N] [--reps N]

Needs one NVIDIA GPU (sm_90a: H100/H200), nvcc and g++; run from the root
of a checkout. Phases, each fatal on failure:

1. environment: card name and power limit, torch/CUDA versions; float32
   math pinned (no TF32, deterministic cuDNN);
2. build: the CUDA kernel (nvcc) and the range coder (g++), in parallel;
3. kernels: K1 (fused GDN) against its plain twin at the six shapes the
   main path gives it (batch 8 of 768x512: 384x256, 192x128 and 96x64
   rows of C=192, forward and inverse), tolerance 2e-5, with kernel, twin,
   matmul-based yardstick and bound times;
4. codec: ckpt/bmshj2018.msgpack through the weight bridge; compress_batch
   then decompress_batch of 8 structured 768x512 images on the card, with
   the kernel launch counts taken over exactly that run (6 for K1), byte-
   identical re-compression, batch-1 decode equal to the batch-8 decode,
   PSNR and bpp, and a small input checked against the CPU path;
5. throughput: compress_iter / decompress_iter over a few batches;
6. profile: device time by kernel, and the device's idle share, over one
   compress + decompress and over the pipelined iterators (torch.profiler).

Then one JSON line with every kernel's numbers, the card line, and the
last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# H100 SXM data-sheet peaks (dense): fp32 on the CUDA cores, HBM3 rate.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
BATCH, HEIGHT, WIDTH = 8, 512, 768
GDN_TOL = 2e-5  # tests/test_pallas_gdn.py's tolerance for the TPU kernel


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0]


def structured_image(h: int, w: int) -> np.ndarray:
    """Gradients + texture + edges + mild noise (bench.py's generator)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    image = np.stack(
        [xx / w * 255, yy / h * 255,
         (np.sin(xx / 17) * np.cos(yy / 23) * 0.5 + 0.5) * 255], -1)
    image[128:256, 192:448] = [255, 64, 32]
    return np.clip(
        image + np.random.RandomState(0).randn(h, w, 3) * 4, 0, 255
    ).astype(np.uint8)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_environment() -> str:
    from compression_tpu_torch.util.device import strict_fp32

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    strict_fp32()
    log("fp32: cudnn.allow_tf32=%s matmul.allow_tf32=%s cudnn.deterministic=%s "
        "cudnn.benchmark=%s" % (
            torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark,
        ))
    return card


def phase_build() -> None:
    from compression_tpu_torch.codec import binding
    from compression_tpu_torch.layers import gdn_kernel

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    with cf.ThreadPoolExecutor(2) as pool:
        nvcc = pool.submit(timed, gdn_kernel.build)
        gxx = pool.submit(timed, binding.get_lib)
        log(f"build: nvcc gdn.cu {nvcc.result():.1f} s, "
            f"g++ tpc_codec.cc {gxx.result():.1f} s")
    for line in gdn_kernel.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


def gdn_shapes():
    """(label, rows, inverse, checkpoint layer) of the main path's 6 calls."""
    shapes = []
    for i, div in enumerate((2, 4, 8)):
        rows = BATCH * (HEIGHT // div) * (WIDTH // div)
        shapes.append((f"gdn{i} {HEIGHT // div}x{WIDTH // div}", rows, False,
                       ("analysis", f"gdn{i}")))
    for i, div in enumerate((8, 4, 2)):
        rows = BATCH * (HEIGHT // div) * (WIDTH // div)
        shapes.append((f"igdn{i} {HEIGHT // div}x{WIDTH // div}", rows, True,
                       ("synthesis", f"igdn{i}")))
    return shapes


def phase_kernels(model, reps: int) -> dict:
    from compression_tpu_torch.layers import parameters
    from compression_tpu_torch.layers.gdn_kernel import fused_gdn, fused_gdn_reference

    def library(x, beta, gamma, inverse):
        # Yardstick only (never called by the port): cuBLAS fp32 GEMM with
        # the bias fused, then the elementwise ops.
        norm = torch.addmm(beta, x * x, gamma)
        return x * (norm.sqrt_() if inverse else norm.rsqrt_())

    gen = torch.Generator(device="cuda").manual_seed(0)
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    max_err = 0.0
    for label, rows, inverse, (tname, lname) in gdn_shapes():
        layer = getattr(getattr(model, tname), lname)
        with torch.no_grad():
            beta = parameters.nonneg_apply(layer.beta, layer.beta_min).cuda()
            gamma = parameters.nonneg_apply(layer.gamma, 0.0).cuda()
        c = gamma.shape[0]
        x = torch.randn(rows, c, device="cuda", generator=gen)
        with torch.inference_mode():
            got = fused_gdn(x, beta, gamma, inverse)
            want = fused_gdn_reference(x, beta, gamma, inverse)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            torch.testing.assert_close(got, want, rtol=GDN_TOL, atol=GDN_TOL)
            # In turns: twin, kernel, yardstick, kernel, twin.
            runs = {"plain_ms": [], "ms": [], "library_ms": []}
            for key, fn in (("plain_ms", fused_gdn_reference), ("ms", fused_gdn),
                            ("library_ms", library), ("ms", fused_gdn),
                            ("plain_ms", fused_gdn_reference)):
                runs[key].append(cuda_ms(lambda: fn(x, beta, gamma, inverse), reps))
        times = {k: sum(v) / len(v) for k, v in runs.items()}
        nbytes = 2 * rows * c * 4 + (c * c + c) * 4
        flops = 2 * rows * c * c + 3 * rows * c
        bound = 1e3 * max(nbytes / PEAK_HBM_BYTES, flops / PEAK_FP32_FLOPS)
        max_err = max(max_err, err)
        for k in ("ms", "plain_ms", "library_ms"):
            totals[k] += times[k]
        totals["bound_ms"] += bound
        log(f"  {label:18s} rows {rows:7d}  max_abs_err {err:.3e}  kernel "
            f"{times['ms']:.4f} ms  twin {times['plain_ms']:.4f} ms  matmul "
            f"{times['library_ms']:.4f} ms  bound {bound:.4f} ms (ops)  "
            f"{flops / times['ms'] / 1e9:.1f} TFLOP/s")
        del x, got, want
    log(f"kernels: K1 over the 6 main-path calls: kernel {totals['ms']:.4f} ms, "
        f"twin {totals['plain_ms']:.4f} ms, matmul {totals['library_ms']:.4f} ms, "
        f"bound {totals['bound_ms']:.4f} ms; max_abs_err {max_err:.3e}")
    return dict(max_abs_err=max_err, **totals)


def check_small_against_cpu(model) -> None:
    """A small input through the card's codec and the CPU codec (same
    weights, same tables): latents agree to 1e-4, reconstructions to one
    level."""
    from compression_tpu_torch.models import bmshj2018

    images = np.stack([structured_image(HEIGHT, WIDTH)[:128, :192]] * 2)
    cpu_model = bmshj2018.BMSHJ2018Model(model.config)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu = bmshj2018.Codec(cpu_model, device="cpu")
    gpu = bmshj2018.Codec(model, device="cuda",
                          tables={"side": cpu.side_em.tables, "main": cpu.em.tables})
    x = torch.from_numpy(images).float() / 255.0
    with torch.inference_mode():
        y_cpu, _ = cpu.model.encode_latents(x)
        y_gpu, _ = gpu.model.encode_latents(x.cuda())
    torch.testing.assert_close(y_gpu.cpu(), y_cpu, rtol=1e-4, atol=1e-4)
    out_gpu = gpu.decompress_batch(gpu.compress_batch(images))
    out_cpu = cpu.decompress_batch(cpu.compress_batch(images))
    diff = np.abs(out_gpu.astype(np.int16) - out_cpu.astype(np.int16))
    log(f"  small input vs CPU path: max |diff| {diff.max()} levels, "
        f"{100 * np.mean(diff == 0):.3f}% equal")
    if diff.max() > 1 or np.mean(diff == 0) < 0.99:
        raise AssertionError("card and CPU reconstructions disagree")


def phase_codec(model) -> tuple:
    from compression_tpu_torch.layers.gdn_kernel import fused_gdn
    from compression_tpu_torch.models import bmshj2018
    from compression_tpu_torch.util.image import psnr_np

    images = np.stack([structured_image(HEIGHT, WIDTH)] * BATCH)
    codec = bmshj2018.Codec(model, device="cuda")
    codec.compress_batch(images[:1])  # warm-up: cuDNN handles, kernel load

    # The main path's run: the counts cover exactly compress + decompress.
    fused_gdn.launches = 0
    t0 = time.perf_counter()
    blobs = codec.compress_batch(images)
    t1 = time.perf_counter()
    out = codec.decompress_batch(blobs)
    t2 = time.perf_counter()
    launches = {"gdn": fused_gdn.launches}
    log(f"codec: batch {BATCH} {HEIGHT}x{WIDTH}: compress {1e3 * (t1 - t0):.1f} ms, "
        f"decompress {1e3 * (t2 - t1):.1f} ms; K1 launches {launches['gdn']}")
    if launches["gdn"] != 6:
        raise AssertionError(f"expected 6 K1 launches, saw {launches['gdn']}")
    if out.shape != images.shape or out.dtype != np.uint8:
        raise AssertionError(f"bad output {out.shape} {out.dtype}")

    if codec.compress_batch(images) != blobs:
        raise AssertionError("re-compression is not byte-identical")
    single = codec.decompress(blobs[0])
    if not np.array_equal(single, out[0]):
        raise AssertionError("batch-1 decode differs from the batch-8 decode")
    psnr = float(np.mean(psnr_np(out, images)))
    bpp = 8.0 * sum(len(b) for b in blobs) / (BATCH * HEIGHT * WIDTH)
    log(f"  re-compress byte-identical; batch-1 decode == batch-8 row 0; "
        f"PSNR {psnr:.3f} dB, {bpp:.4f} bpp")
    if not (psnr > 25.0 and 0.0 < bpp < 8.0):
        raise AssertionError("implausible rate/distortion for the trained model")
    check_small_against_cpu(model)
    return codec, images, launches


def phase_profile(label: str, run, top: int = 0) -> None:
    """Device time by kernel over ``run()`` (torch.profiler), grouped, and
    the device's idle share of the wall time (busy = the sum of the kernel
    and copy durations; one stream, so they barely overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    per_kernel: dict = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            ms, calls = per_kernel.get(evt.name, (0.0, 0))
            per_kernel[evt.name] = (ms + evt.time_range.elapsed_us() / 1e3, calls + 1)
    if not per_kernel:
        log(f"profile ({label}): the profiler saw no device activity; not measured")
        return
    busy = sum(ms for ms, _ in per_kernel.values())
    groups = {"K1 gdn": 0.0, "convolution": 0.0, "memcpy": 0.0, "other": 0.0}
    for name, (ms, _) in per_kernel.items():
        low = name.lower()
        key = ("K1 gdn" if "gdn_kernel" in low else
               "memcpy" if "memcpy" in low else
               "convolution" if any(s in low for s in ("conv", "cudnn", "xmma", "gemm", "fprop"))
               else "other")
        groups[key] += ms
    log(f"profile ({label}): wall {wall_ms:.1f} ms, device busy {busy:.1f} ms, "
        f"idle {100 * (1 - busy / wall_ms):.1f}%; "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in groups.items()))
    for name, (ms, calls) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"  {ms:8.2f} ms {calls:5d}x  {name[:110]}")


def phase_throughput(codec, images, batches: int, card: str) -> None:
    batch_list = [images] * batches
    list(codec.compress_iter(batch_list[:1]))  # warm the pipeline
    codec.timer.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blob_batches = list(codec.compress_iter(batch_list))
    t1 = time.perf_counter()
    decoded = list(codec.decompress_iter(blob_batches))
    t2 = time.perf_counter()
    if len(decoded) != batches or any(d.shape != images.shape for d in decoded):
        raise AssertionError("pipelined decode returned the wrong batches")
    n = batches * BATCH
    log(f"throughput ({card}): compress_iter {n / (t1 - t0):.3f} img/s, "
        f"decompress_iter {n / (t2 - t1):.3f} img/s, round trip "
        f"{n / (t2 - t0):.3f} img/s over {batches} batches of {BATCH}")
    log(codec.timer.report())


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batches", type=int, default=16)
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs the card",
              file=sys.stderr)
        return 2

    from compression_tpu_torch.models import bmshj2018

    t_start = time.perf_counter()
    card = phase_environment()
    phase_build()
    model = bmshj2018.load_model(ROOT / "ckpt" / "bmshj2018.msgpack")
    k1 = phase_kernels(model, args.reps)
    codec, images, launches = phase_codec(model)
    phase_throughput(codec, images, args.batches, card)
    phase_profile(f"compress_batch + decompress_batch of {BATCH}",
                  lambda: codec.decompress_batch(codec.compress_batch(images)),
                  top=10)
    batch_list = [images] * args.batches
    phase_profile(f"compress_iter then decompress_iter, {args.batches} batches",
                  lambda: list(codec.decompress_iter(list(codec.compress_iter(batch_list)))))

    kernels = [{
        "name": "gdn",
        "route": "cuda",
        "source": "compression_tpu_torch/csrc/gdn.cu",
        "replaces": "compression_tpu/layers/pallas/gdn_kernel.py:41",
        "launches": launches["gdn"],
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": "operations",
        "library_ms": k1["library_ms"],
    }]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
