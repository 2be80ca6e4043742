"""On-card smoke run of the PyTorch/CUDA port: bmshj2018 at full width, with
the host coder and with the device (rANS) coder, its training, and the
other families at full width (bls2017, bmshj2018-factorized, mbt2018-mean,
b2018, ms2020-cc10, HiFiC).

    python3 chip_smoke.py [--batches N] [--reps N]

Needs one NVIDIA GPU (sm_90a: H100/H200), nvcc and g++; run from the root
of a checkout. Phases, each fatal on failure:

1. environment: card name and power limit, torch/CUDA versions; float32
   math pinned (no TF32, deterministic cuDNN);
2. build: the CUDA kernels gdn.cu and rans.cu (nvcc, one process each)
   and the range coder (g++), all in parallel;
3. kernels: K1 (fused GDN, 3xTF32 on the tensor cores) against its plain
   twin at the six shapes the main path gives it (batch 8 of 768x512:
   384x256, 192x128 and 96x64 rows of C=192, forward and inverse) and on
   x spread over 1e-3..1e3 at 384x256, tolerance 2e-5; K3 (rANS encode)
   and K2 (rANS decode) against their twins on the real symbols and rows
   of the 8 images (B=8, N=294,912, K=128, cap=885,056), on a synthetic
   case (random tables with a full-mass row, 25% escapes, ragged N) and on
   a corrupt stream, identical (integers: no tolerance); K2's variant
   (tables in shared memory, "on_chip", on the main path); kernel, twin,
   yardstick and bound times, and each rANS kernel's serial floor (T
   steps of its dependent chain as csrc/rans.cu counts it, at the card's
   clock);
4. codec (host coder): ckpt/bmshj2018.msgpack through the weight bridge;
   compress_batch then decompress_batch of 8 structured 768x512 images,
   with the launch counts taken over exactly that run (6 for K1), byte-
   identical re-compression, batch-1 decode equal to the batch-8 decode,
   PSNR and bpp, and a small input checked against the CPU path;
5. codec (device coder): the same images through compress_batch(coder=
   "device") then decompress_batch, with launches over exactly that run
   (K3 2: fields then lanes; K2 1 in its on-chip variant; K1 6),
   5-field blobs with K=128 (no overflow fall-back),
   a reconstruction bit-equal to the host coder's, byte-identical
   re-compression, batch-1 decode equal to the batch-8 decode, and each y
   stream within 1.1x the host coder's y string + 4K + 16 bytes;
6. throughput: compress_iter / decompress_iter with each coder (8 batches
   of 8 by default);
7. profile: device time by kind and by kernel, and the device's idle
   share, over one compress + decompress and over the pipelined iterators
   (torch.profiler, ``profile_device``: each activity's time not covered
   by an earlier one, so the kinds add up to busy), with each coder; K3
   and K2 inside the device codec next to their standalone times of
   phase 3;
8. training, bmshj2018 at full width on batches of 8 crops of 256x256
   (crop_dataset's synthetic fallback: the card machine has no images and
   no PIL), all under the fp32 settings of phase 1:
   a. K1 under autograd (FusedGDN: the kernel's forward, a plain-op
      backward) against autograd through the twin, dx/dbeta/dgamma at the
      six training shapes (8x128x128, 8x64x64, 8x32x32 rows of C=192,
      forward and inverse), within 1e-4 relative and 1e-4 of each one's
      largest entry; the backward's ops timed;
   b. one quantized (training=False, deterministic) step of 2 crops from
      ckpt/bmshj2018.msgpack: loss and every gradient against the CPU
      (loss 1e-4 relative, gradients 1e-3 of each one's largest entry);
   c. launches over exactly one training step (train_step): K1 6, K3 0,
      K2 0;
   d. 50 steps of train_model from the checkpoint at lr 1e-4, every loss
      finite, bpp and MSE at steps 1, 10 and 50;
   e. 100 steps from the seeded init on one fixed batch: the mean of the
      last 10 losses below the mean of the first 10;
   f. save after 3 steps, resume in a fresh model and optimizer: params and
      Adam moments bit-equal to the run that saved them; train_model then
      numbers its one step 4 (as in the JAX package, the noise generator
      and the data stream restart from the seed on resume);
   g. 3 steps with distortion="msssim", every loss finite;
   h. steps/s and img/s of train_model over 50 steps after 5 warm-up
      steps, and a profile of 10 steps: device busy time, idle share, and
      device ms by kind (convolutions forward and backward, K1, the GDN
      backward's ops, Adam, copies, other);
9. factorized-prior codecs: bls2017 at 128 filters and bmshj2018-factorized
   at 192/192, each trained 100 steps from its seeded init on one fixed
   batch (the loss must fall), then compress and decompress of 8 structured
   768x512 images one by one: K1 launches over exactly one round trip (4 and
   6), 3-field blobs, byte-identical re-compression, PSNR and bpp, K1 against
   its twin on the round trip's own GDN inputs, a 96x130 input within one
   level of the CPU path; and an 8-filter bls2017's round trip (K1 at C = 8,
   padded to 32) against the CPU;
10. mbt2018-mean at 192/320/192: a. 200 steps of train_model from the seed
    on fresh synthetic crops (every loss finite, the loss falling; steps/s,
    img/s), the quantization-offset root-find's time and host syncs, and the
    launches of one training step (K1 6, K3 0, K2 0); b. a quantized step of
    a C = 32 model on the card against the CPU (8b's tolerances); c. the codec
    over 8 structured 768x512 images with each coder (launches K1 6 host; K1
    6, K3 2, K2 1 on chip device; 5-field blobs with K=128, reconstruction
    equal to the host coder's, byte-identical re-compression, batch-1 decode
    equal to the batch-8 decode); d. K3 and K2 against their twins on its
    symbols and rows (N=491,520, T=3,840), with times, bounds and serial
    floors; e. compress_iter / decompress_iter throughput with each coder;
    f. a profile of one round trip with each coder;
11. b2018 at full width, b2018-gdn at 192 filters and b2018-leaky_relu at
    128, 4 rate points each: 100 steps of train_model from the seed (the
    rate-point parameters at 10x the learning rate; the loss falling), the
    launches of one training step (K1 4 / 0), then the one-image codec
    over the 8 images at each quality: K1 launches over exactly one round
    trip (4 / 0), 3-field blobs carrying their quality, byte-identical
    re-compression, bpp and PSNR at each quality with bpp at q4 above q1,
    K1 against its twin on the path's own GDN inputs, a 96x130 input
    within one level of the CPU;
12. ms2020-cc10 at 192/320/192, 10 slices of 32: a. 100 steps of
    train_model from the seed (steps/s, img/s), the quantization-offset
    root-find's share of a step, and the launches of one step (K1 6, K3 0,
    K2 0); b. the codec over the 8 images with each coder (launches K1 6
    host; K1 6, K3 20, K2 10 on chip device; 13- and 14-field blobs, the
    device reconstruction equal to the host coder's, byte-identical
    re-compression, batch-1 decode equal to the batch-8 decode, each
    slice's device stream within 1.1x the host string + 4K + 16 bytes);
    c. K3 and K2 against their twins on slice 0's real symbols and rows
    (N = 49,152, T = 384) with times, bounds and serial floors; d.
    compress_iter / decompress_iter throughput with each coder; e. the
    encode chain's cost (the front alone, then with the per-image slice
    chain: host enqueue ms, device activities and busy ms); f. a profile
    of one round trip with each coder;
13. HiFiC hific-mi at full width (220 latents, 320 hyperlatents, 9 residual
    blocks, the fixed 60-960 widths): a. one joint G/D step of 2 crops of
    256x256 on the card against the CPU from the same seeded weights, with
    the noise drawn once on the CPU and fed to both, LPIPS on synthetic
    weights (a seeded NumPy draw in tools/convert_lpips.py's torch layout),
    with the CPU's float64 step as the reference: in float64 the card's
    losses (1e-10 relative) and every G and D gradient and u and sigma
    (1e-8 of the largest entry); in float32 the G and D losses (1e-4
    relative of the CPU's float32) and D's u and sigma (1e-3 of the
    largest entry), and the gradients no further from float64 on the card
    than 3x the CPU's float32 distance, for the worst tensor and the median
    one (a ReLU flipped by an ulp at 16x16 latents moves a gradient by
    ~1/512 of its sum; the flips on each device are counted);
    b. 100 joint steps of ``hific.train`` from the seed at batch 8
    of 256x256 (LPIPS's random-feature fallback: no weights file), every
    metric finite, the mean MSE of the first 10 steps above the last 10's,
    bpp, lambda and hinge_on at steps 1, 10 and 100, ms a step and img/s,
    the launches of exactly one step (K1 0, K3 0, K2 0) and a profile of 3
    steps by kind; c. the codec of the trained model over the 8 structured
    images with each coder
    (launches K1 0 host; K1 0, K3 2, K2 1 on chip device; 4- and 5-field
    blobs with K=128, the device reconstruction equal to the host coder's,
    byte-identical re-compression, batch-1 decode equal to the batch-8
    decode, each y stream within phase 5's gate, a 128x192 input within one
    level of the CPU), and ``coded_bpp`` of the 8 images beside the host
    coder's bpp (printed, not held: the model is barely trained); d. K3 and
    K2 against their twins on its symbols and rows (N = 337,920, T =
    2,640), with times, bounds and serial floors; e. compress_iter /
    decompress_iter throughput with each coder; f. a profile of one round
    trip with each coder: device ms by kind (convolutions, ChannelNorm's
    forward ops, K3, K2, copies, other) and the idle share.

Then one JSON line with every kernel's numbers (and its launches on every
path), the training numbers and the families' numbers, the card line, and
the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import contextlib
import dataclasses
import io
import json
import os
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# H100 SXM data-sheet peaks (dense): fp32 on the CUDA cores, TF32 on the
# tensor cores, HBM3 rate, and int32 on the CUDA cores: 132 SMs x 64 INT32
# lanes x 1.98 GHz (the boost clock that gives the 67 TFLOP/s fp32 figure:
# 132 x 128 x 2 x 1.98 GHz).
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12
PEAK_INT32_OPS = 132 * 64 * 1.98e9
BATCH, HEIGHT, WIDTH = 8, 512, 768
GDN_TOL = 2e-5  # tests/test_pallas_gdn.py's tolerance for the TPU kernel
RANS_K = 128    # the lanes rans_for picks at every codec's 768x512 shapes
# Integer operations a symbol, counted from the scan bodies (rans.py
# step(); the kernels do the same work): the encoder's field mapping,
# fc gather, pushes, renorm test and state update (u32 divide and modulo
# counted as one each); the decoder's slot, two gathers, state update and
# renorm; each escape's two bypass pops and payload decode.
RANS_ENC_OPS, RANS_DEC_OPS, RANS_ESC_OPS = 28, 19, 9
# Cycles of one step's dependent chain, as csrc/rans.cu's designs count it
# (integer ops at 4 cycles, a shared-memory load at 30, a ballot with its
# popcount at 20, a named barrier at 30). K3's lane pass: the escape
# substitution (2 ops), the renorm test and shift (3), the divide's
# quotient and remainder fix-up (6; the divisor's reciprocal is off the
# chain) and the new state (2): 13 ops. K2: slot and bucket address (2
# ops), the bucket load, the f|c address (1), the f|c load, the search
# test (2), the state update (3) and renorm test (1), ballot and popcount,
# the count's store, the barrier and the counts' load, the prefix (2), the
# ring address (2), the ring load, the merge (1): 14 ops, four loads, a
# ballot and a barrier.
RANS_ENC_CHAIN_CYCLES = 13 * 4
RANS_DEC_CHAIN_CYCLES = 14 * 4 + 4 * 30 + 20 + 30
# Training: TrainConfig's default batch of 8 crops of 256x256.
TRAIN_BATCH, TRAIN_PATCH = 8, 256
TRAIN_GDN_TOL = 1e-4  # K1's Function against the twin's autograd (8a)
TRAIN_CPU_TOL = 1e-3  # card against CPU gradients, of each one's largest entry (8b)
DEVICE = "cuda"  # phases 8-10's device (a CPU rehearsal of their control flow sets "cpu")


def sync() -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def log(msg: str) -> None:
    print(msg, flush=True)


def sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi), in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return float(out[0]) * 1e6


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0]


def structured_image(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Gradients + texture + edges + mild noise (bench.py's generator); the
    noise drawn from ``seed``."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    image = np.stack(
        [xx / w * 255, yy / h * 255,
         (np.sin(xx / 17) * np.cos(yy / 23) * 0.5 + 0.5) * 255], -1)
    image[128:256, 192:448] = [255, 64, 32]
    return np.clip(
        image + np.random.RandomState(seed).randn(h, w, 3) * 4, 0, 255
    ).astype(np.uint8)


def structured_images() -> np.ndarray:
    """BATCH structured images, each with its own noise (phases 9-10)."""
    return np.stack([structured_image(HEIGHT, WIDTH, seed) for seed in range(BATCH)])


def cuda_ms(fn, reps: int, warmup: bool = True) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` back-to-back calls."""
    if warmup:
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
    from compression_tpu_torch.util import cuda_build

    def timed(fn, *args):
        t0 = time.perf_counter()
        fn(*args)
        return time.perf_counter() - t0

    with cf.ThreadPoolExecutor(3) as pool:
        nvcc = {src: pool.submit(timed, cuda_build.build, src)
                for src in ("gdn.cu", "rans.cu")}
        gxx = pool.submit(timed, binding.get_lib)
        log("build: " + ", ".join(f"nvcc {src} {fut.result():.1f} s"
                                  for src, fut in nvcc.items())
            + f", g++ tpc_codec.cc {gxx.result():.1f} s")
    from compression_tpu_torch.layers import gdn_kernel

    for src in nvcc:
        for line in ptxas_summary(cuda_build.build_logs.get(src, "")):
            log(f"  ptxas {src} {line}")
    log(f"  gdn.cu at C=192: {gdn_kernel._smem_bytes(192)} bytes of dynamic shared "
        "memory a CTA (gamma slice hi+lo, two x stages)")


def ptxas_summary(build_log: str) -> list:
    """One line a kernel from nvcc's ``-Xptxas -v`` report: the kernel (name
    and template arguments, from its mangled name), registers, spills."""
    lines, name, spills = [], None, ""
    for line in build_log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            mangled = entry.group(1)
            base = re.search(r"\d([a-z][a-z_]*_kernel)[IE]", mangled)
            args = re.findall(r"L[ib](\d+)E", mangled)
            name = (base.group(1) if base else mangled) + (f"<{','.join(args)}>" if args else "")
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line and name:
            used = line.split(":", 1)[-1].strip()
            lines.append(f"{name}: {used}; {spills}")
            name = None
    return lines


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


def gdn_bounds_ms(rows: int, c: int) -> dict:
    """Least times of one K1 call: each input read once and each output
    written once over the HBM rate; the three TF32 products of 3xTF32 over
    the tensor cores' TF32 rate; and the fp32 CUDA-core bound of a kernel
    that does the product in fp32."""
    nbytes = 2 * rows * c * 4 + (c * c + c) * 4
    flops = 2 * rows * c * c
    return {"bytes": 1e3 * nbytes / PEAK_HBM_BYTES,
            "tf32": 1e3 * 3 * flops / PEAK_TF32_FLOPS,
            "fp32": 1e3 * (flops + 3 * rows * c) / PEAK_FP32_FLOPS}


def phase_kernels(model, reps: int) -> dict:
    from compression_tpu_torch.layers import parameters
    from compression_tpu_torch.layers.gdn_kernel import fused_gdn, fused_gdn_reference

    def library(x, beta, gamma, inverse):
        # Yardstick only (never called by the port): cuBLAS fp32 GEMM with
        # the bias fused, then the elementwise ops.
        norm = torch.addmm(beta, x * x, gamma)
        return x * (norm.sqrt_() if inverse else norm.rsqrt_())

    gen = torch.Generator(device="cuda").manual_seed(0)
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                  bytes_ms=0.0, tf32_ms=0.0, fp32_ms=0.0, flops=0.0)
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
        bounds = gdn_bounds_ms(rows, c)
        bound = max(bounds["bytes"], bounds["tf32"])
        flops = 2 * rows * c * c
        max_err = max(max_err, err)
        for k in ("ms", "plain_ms", "library_ms"):
            totals[k] += times[k]
        totals["bound_ms"] += bound
        totals["bytes_ms"] += bounds["bytes"]
        totals["tf32_ms"] += bounds["tf32"]
        totals["fp32_ms"] += bounds["fp32"]
        totals["flops"] += flops
        log(f"  {label:18s} rows {rows:7d}  max_abs_err {err:.3e}  kernel "
            f"{times['ms']:.4f} ms  twin {times['plain_ms']:.4f} ms  matmul "
            f"{times['library_ms']:.4f} ms  bound {bounds['bytes']:.4f} ms (bytes), "
            f"{bounds['tf32']:.4f} (3xTF32 ops), {bounds['fp32']:.4f} (fp32 ops); "
            f"{100 * bound / times['ms']:.1f}% of bound, tensor cores "
            f"{100 * 3 * flops / (times['ms'] * 1e-3) / PEAK_TF32_FLOPS:.1f}%")
        del x, got, want
    wide_err = check_gdn_wide_range(model)
    log(f"kernels: K1 over the 6 main-path calls: kernel {totals['ms']:.4f} ms, "
        f"twin {totals['plain_ms']:.4f} ms, matmul {totals['library_ms']:.4f} ms; "
        f"bound {totals['bound_ms']:.4f} ms (bytes {totals['bytes_ms']:.4f} ms, 3xTF32 ops "
        f"{totals['tf32_ms']:.4f} ms, "
        f"fp32 CUDA-core ops {totals['fp32_ms']:.4f} ms), {100 * totals['bound_ms'] / totals['ms']:.1f}% "
        f"of bound; tensor cores {100 * 3 * totals['flops'] / (totals['ms'] * 1e-3) / PEAK_TF32_FLOPS:.1f}% "
        f"busy (3 TF32 products over the TF32 peak); max_abs_err {max_err:.3e} "
        f"(wide-range input {wide_err:.3e})")
    bound_by = "bytes" if totals["bytes_ms"] >= totals["tf32_ms"] else "operations"
    return dict(max_abs_err=max_err, bound_by=bound_by, **{
        k: totals[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")})


def check_gdn_wide_range(model) -> float:
    """K1 against its twin, both directions, at 384x256 of the batch with x
    of magnitude spread log-uniformly over 1e-3..1e3, random signs, on the
    checkpoint's first GDN and last IGDN."""
    from compression_tpu_torch.layers import parameters
    from compression_tpu_torch.layers.gdn_kernel import fused_gdn, fused_gdn_reference

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = BATCH * (HEIGHT // 2) * (WIDTH // 2)
    sign = torch.randint(0, 2, (rows, 192), device="cuda", generator=gen) * 2.0 - 1.0
    x = sign * 10.0 ** (torch.rand(rows, 192, device="cuda", generator=gen) * 6 - 3)
    worst = 0.0
    for layer, inverse in ((model.analysis.gdn0, False), (model.synthesis.igdn2, True)):
        with torch.no_grad():
            beta = parameters.nonneg_apply(layer.beta, layer.beta_min).cuda()
            gamma = parameters.nonneg_apply(layer.gamma, 0.0).cuda()
        with torch.inference_mode():
            got = fused_gdn(x, beta, gamma, inverse)
            want = fused_gdn_reference(x, beta, gamma, inverse)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            rel = ((got - want).abs() / want.abs()).max().item()
            torch.testing.assert_close(got, want, rtol=GDN_TOL, atol=GDN_TOL)
        worst = max(worst, err)
        log(f"  wide-range x (1e-3..1e3), rows {rows}, "
            f"{'inverse' if inverse else 'forward'}: max_abs_err {err:.3e}, "
            f"max_rel_err {rel:.3e} (|y| up to {want.abs().max().item():.3e})")
    return worst


def count_escapes(values, rows, tables) -> int:
    """Elements coded as escapes (outside their row's symbol range)."""
    t = tables.on(values.device)
    r = rows.long()
    s = values.long() - t.cdf_offset.long()[r]
    return int((~((s >= 0) & (s < t.escape.long()[r]))).sum())


def rans_bound_ms(values, rows, word_count, tables, decode: bool) -> tuple:
    """(bound ms, "bytes" or "operations") of one rANS call on this data:
    each input read once and each output written once over the HBM rate
    (the stream's words as this run's streams need them, the tables once),
    against its integer operations over the int32 rate."""
    B, N = values.shape
    escapes = count_escapes(values, rows, tables)
    table_bytes = tables.table_bytes if decode else 4 * tables.bucket_words  # K3: row info, f|c
    nbytes = (4 * B * N + rows.element_size() * B * N + 2 * word_count
              + table_bytes + (B if decode else 5 * B))
    ops = (RANS_DEC_OPS if decode else RANS_ENC_OPS) * B * N + RANS_ESC_OPS * escapes
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES, ops / PEAK_INT32_OPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def synthetic_rans_tables(rng, num_rows=16, precision=12, max_syms=60):
    """Random quantized CDF rows (escape symbol last, as the entropy models
    build them); row 0 is degenerate: its one symbol owns all 2^P slots."""
    from compression_tpu_torch.codec import pmf_to_quantized_cdf
    from compression_tpu_torch.entropy_models.continuous_base import CdfTables

    cdfs, lengths = [], []
    for _ in range(num_rows):
        n = rng.randint(2, max_syms)
        cdfs.append(pmf_to_quantized_cdf(rng.rand(n) ** 2 + 1e-3, [n], precision)[0])
        lengths.append(n + 1)
    cdfs[0], lengths[0] = np.array([0, 1 << precision, 1 << precision]), 3
    cdf = np.zeros((num_rows, max(len(c) for c in cdfs)), np.int32)
    for i, c in enumerate(cdfs):
        cdf[i, : len(c)] = c
    return CdfTables(cdf=cdf, cdf_length=np.array(lengths, np.int32),
                     cdf_offset=rng.randint(-30, 30, num_rows).astype(np.int32),
                     offset=np.zeros(num_rows), precision=precision)


def check_rans_synthetic() -> None:
    """K3/K2 against their twins on random tables (a full-mass row), 25%
    escapes (two at the int32 limits) and a ragged N, B=8, K=128."""
    from compression_tpu_torch.codec import rans

    rng = np.random.RandomState(0)
    tables = rans.RansTables(synthetic_rans_tables(rng))
    B, N, K = BATCH, 100_003, 128
    rows = rng.randint(0, tables.num_rows, (B, N))
    lo = tables.cdf_offset.numpy()[rows].astype(np.int64)
    n_sym = np.maximum(tables.escape.numpy()[rows], 1)
    wide = rng.randint(-40_000, 40_000, (B, N)).astype(np.int64)
    values = np.where(rng.rand(B, N) < 0.75,
                      lo + (rng.rand(B, N) * n_sym).astype(np.int64), wide)
    values = np.where(rows == 0, lo, values)
    rows[-1, :2] = tables.num_rows - 1
    values[-1, :2] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max]
    values = torch.from_numpy(values.astype(np.int32)).cuda()
    rows = torch.from_numpy(rows.astype(np.uint8)).cuda()
    cap = 3 * N + 2 * K + 64
    got = rans.rans_encode(tables, values, rows, K, cap)
    want = rans.rans_encode_reference(tables, values, rows, K, cap)
    torch.cuda.synchronize()
    for name, g, w in zip(("words", "lengths", "overflow"), got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"K3 synthetic: {name} differ from the twin")
    out, ok = rans.rans_decode(tables, got[0], rows, K, N)
    want_out, want_ok = rans.rans_decode_reference(tables, got[0], rows, K, N)
    torch.cuda.synchronize()
    if not (torch.equal(out, want_out) and torch.equal(ok, want_ok)
            and bool(ok.all()) and torch.equal(out, values)):
        raise AssertionError("K2 synthetic: decode differs from the twin or the input")
    log(f"  synthetic: B={B} N={N} (ragged) K={K}, 16 random rows incl. a "
        f"full-mass row, 25% escapes: K3 == twin, K2 == twin == input "
        f"({int(want[1].sum())} words)")


def phase_rans_kernels(codec, images, reps: int, main_path: bool = True) -> dict:
    """K3 and K2 against their twins at a codec's shapes, on the real
    symbols and rows of the 8 images (``round(y - mu)`` for a mean-scale
    codec); timed in turns with the twins. On the main path also a corrupt
    stream, the synthetic case and K2's lookup designs."""
    from compression_tpu_torch.codec import rans
    from compression_tpu_torch.models.device_coding import (
        encode_symbols, fetch_streams, pad_words, rans_for)

    with codec._on_device():
        if num_streams(codec) > 1:  # ms2020: slice 0's symbols and rows
            syms, _, slice_rows, _ = codec._encode_slices(images)
            values, rows = syms[0], slice_rows[0]
        else:
            values, _, rows, _ = encode_symbols(codec, images)
        values, rows = values.reshape(BATCH, -1), rows.reshape(BATCH, -1)
    torch.cuda.synchronize()
    N = values.shape[1]
    _enc, _dec, K, cap = rans_for(codec, N)
    tables = codec._rans_tables
    # 294,912 (bmshj2018), 491,520 (mbt2018) or 49,152 (an ms2020 slice) at 768x512
    want_n = HEIGHT * WIDTH // 256 * codec.cfg.num_latents // num_streams(codec)
    if (N, K, cap) != (want_n, RANS_K, 3 * want_n + 2 * RANS_K + 64):
        raise AssertionError(f"unexpected shapes N={N} K={K} cap={cap}")
    variant = rans.decode_variant(tables)
    log(f"  K2 variant: {variant} (table blob {tables.table_bytes} bytes in shared memory)")
    if variant != "on_chip":
        raise AssertionError("the codec's tables do not fit K2's shared memory")

    with torch.inference_mode():
        got = rans.rans_encode(tables, values, rows, K, cap)
        want = rans.rans_encode_reference(tables, values, rows, K, cap)
        torch.cuda.synchronize()
        for name, g, w in zip(("words", "lengths", "overflow"), got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"K3: {name} differ from the twin")
        if bool(got[2].any()):
            raise AssertionError("K3: the streams overflowed")
        lengths = got[1].cpu().numpy()
        # K2's input as the decoder builds it: the blobs' words, padded.
        stream = torch.from_numpy(pad_words([
            np.frombuffer(w, np.uint16) for w in fetch_streams(got[0], lengths)
        ])).cuda()
        out, ok = rans.rans_decode(tables, stream, rows, K, N)
        want_out, want_ok = rans.rans_decode_reference(tables, stream, rows, K, N)
        torch.cuda.synchronize()
        if not (torch.equal(out, want_out) and torch.equal(ok, want_ok)):
            raise AssertionError("K2: decode differs from the twin")
        if not (bool(ok.all()) and torch.equal(out, values)):
            raise AssertionError("K2: decode does not give back the symbols")
        escapes = count_escapes(values, rows, tables)
        log(f"  B={BATCH} N={N} K={K} T={-(-N // K)} cap={cap} (B*cap {BATCH * cap} words), "
            f"stream {stream.shape[1]} words wide; y words per image "
            f"{lengths.min()}..{lengths.max()}; {escapes} escapes "
            f"({100 * escapes / values.numel():.3f}%); K3 == twin (words, lengths, "
            f"overflow), K2 == twin == symbols")

        bad = stream.cpu()  # (no uint16 xor on CUDA)
        bad[3, int(lengths[3]) // 2] ^= 0x5A5A
        bad = bad.cuda()
        c_out, c_ok = rans.rans_decode(tables, bad, rows, K, N)
        w_out, w_ok = rans.rans_decode_reference(tables, bad, rows, K, N)
        torch.cuda.synchronize()
        if not (torch.equal(c_ok, w_ok) and torch.equal(c_out, w_out)):
            raise AssertionError("K2: corrupt stream decodes differently from the twin")
        if c_ok.tolist() != [b != 3 for b in range(BATCH)]:
            raise AssertionError(f"K2: corrupt stream gave ok {c_ok.tolist()}")
        log("  corrupt stream (image 3, one word flipped): ok = "
            f"{c_ok.tolist()} from kernel and twin alike")
        if main_path:
            check_rans_synthetic()

        word_count = int(lengths.sum())
        T = -(-N // K)
        clock = sm_clock_hz()
        results = {}
        for name, kernel, twin, args in (
            ("rans_encode", rans.rans_encode, rans.rans_encode_reference,
             (tables, values, rows, K, cap)),
            ("rans_decode", rans.rans_decode, rans.rans_decode_reference,
             (tables, stream, rows, K, N)),
        ):
            runs = {"plain_ms": [], "ms": []}
            for key, fn, n in (("plain_ms", twin, 1), ("ms", kernel, reps),
                               ("ms", kernel, reps), ("plain_ms", twin, 1)):
                runs[key].append(cuda_ms(lambda: fn(*args), n, warmup=key == "ms"))
            times = {k: sum(v) / len(v) for k, v in runs.items()}
            bound, bound_by = rans_bound_ms(values, rows, word_count, tables,
                                            decode=name == "rans_decode")
            chain = RANS_DEC_CHAIN_CYCLES if name == "rans_decode" else RANS_ENC_CHAIN_CYCLES
            floor = 1e3 * T * chain / clock
            log(f"  {name}: kernel {times['ms']:.4f} ms  twin {times['plain_ms']:.2f} ms  "
                f"bound {bound:.4f} ms ({bound_by})  serial floor {floor:.4f} ms "
                f"({T} steps x {chain} cycles at {clock / 1e6:.0f} MHz)  "
                f"{1e3 * times['ms'] / T:.3f} us per step, {times['ms'] * 1e-3 * clock / T:.0f} "
                f"cycles (kernel runs {[round(v, 4) for v in runs['ms']]})")
            results[name] = dict(max_abs_err=0.0, bound_ms=bound, bound_by=bound_by,
                                 floor_ms=floor, steps=T, **times)
        if main_path:
            check_decode_designs(codec, tables, stream, rows, values, K, reps)
    return results


def check_decode_designs(codec, tables, stream, rows, values, K, reps) -> None:
    """K2's lookup designs on the main path's stream, each checked against
    the symbols: the shipped tables on chip (8-slot buckets), 16-slot
    buckets on chip, and the shipped tables read through L1 (the variant
    for tables over the shared-memory budget)."""
    from compression_tpu_torch.codec import rans

    N = values.shape[1]
    wide = rans.RansTables(codec.em.tables, bucket_bits=4)
    times = {}
    for label, t, on_chip in (("on chip, 8-slot buckets", tables, True),
                              ("on chip, 16-slot buckets", wide, True),
                              ("through L1", tables, False)):
        out, ok = rans._decode_launch(t, stream, rows, K, N, on_chip)
        torch.cuda.synchronize()
        if not (bool(ok.all()) and torch.equal(out, values)):
            raise AssertionError(f"K2 ({label}) does not give back the symbols")
        times[label] = cuda_ms(
            lambda t=t, on_chip=on_chip: rans._decode_launch(t, stream, rows, K, N, on_chip),
            reps)
    log("  K2 lookup designs on the main path's stream: " + ", ".join(
        f"{label} {ms:.4f} ms" for label, ms in times.items()))


def check_small_against_cpu(module, model, hw=(128, 192), **compress_kw) -> int:
    """A small input through the card's codec and the CPU codec of the
    family ``module`` (same weights, same tables; ``compress_kw`` for a
    one-image codec's compress, b2018's quality): latents agree to 1e-4,
    reconstructions to one level. Returns the K1 launches of the card's
    round trip."""
    from compression_tpu_torch.layers.gdn_kernel import fused_gdn

    images = np.stack([structured_image(HEIGHT, WIDTH)[: hw[0], : hw[1]]] * 2)
    cpu_model = type(model)(model.config)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu = module.Codec(cpu_model, device="cpu")
    batched = hasattr(cpu, "side_em")  # the hyperprior codecs' batch API
    tables = ({"side": cpu.side_em.tables, "main": cpu.em.tables} if batched
              else getattr(cpu, "tables", None) or cpu.em.tables)
    gpu = module.Codec(model, device=DEVICE, tables=tables)
    x = torch.from_numpy(images).float() / 255.0
    with torch.inference_mode():
        y_cpu, y_gpu = cpu.model.analysis(x), gpu.model.analysis(x.to(DEVICE))
    torch.testing.assert_close(y_gpu.cpu(), y_cpu, rtol=1e-4, atol=1e-4)

    def round_trip(codec):
        if batched:
            return codec.decompress_batch(codec.compress_batch(images))
        return np.stack([codec.decompress(codec.compress(im, **compress_kw))
                         for im in images[:1]])

    round_trip(gpu)  # warm-up
    fused_gdn.launches = 0
    out_gpu = round_trip(gpu)
    launches = fused_gdn.launches
    out_cpu = round_trip(cpu)
    diff = np.abs(out_gpu.astype(np.int16) - out_cpu.astype(np.int16))
    log(f"  {hw[0]}x{hw[1]} input vs CPU path ({type(model).__name__}): max |diff| "
        f"{diff.max()} levels, "
        f"{100 * np.mean(diff == 0):.3f}% equal; K1 launches {launches}")
    if diff.max() > 1 or np.mean(diff == 0) < 0.99:
        raise AssertionError("card and CPU reconstructions disagree")
    return launches


def num_streams(codec) -> int:
    """y streams a blob: one a slice for ms2020, else one."""
    return getattr(codec.cfg, "num_slices", 1)


def phase_codec(codec, images, module, label: str = "codec", min_psnr=25.0,
                cpu_check: bool = True, gdn: int = 6) -> tuple:
    """A hyperprior codec's host-coded path: launches over exactly
    compress_batch + decompress_batch (``gdn`` for K1), byte-identical
    re-compression, batch-1 decode equal to the batch-8 decode, PSNR and
    bpp (PSNR held to ``min_psnr`` where the weights are trained ones), and
    with ``cpu_check`` a small input against the CPU path of ``module``.
    Returns (blobs, reconstruction, launches)."""
    from compression_tpu_torch.models.device_coding import num_fields

    from compression_tpu_torch.layers.gdn_kernel import fused_gdn
    from compression_tpu_torch.util.image import psnr_np

    codec.compress_batch(images[:1])  # warm-up: cuDNN handles, kernel load

    # The path's run: the counts cover exactly compress + decompress.
    fused_gdn.launches = 0
    t0 = time.perf_counter()
    blobs = codec.compress_batch(images)
    t1 = time.perf_counter()
    out = codec.decompress_batch(blobs)
    t2 = time.perf_counter()
    launches = {"gdn": fused_gdn.launches}
    log(f"{label}: batch {BATCH} {HEIGHT}x{WIDTH}: compress {1e3 * (t1 - t0):.1f} ms, "
        f"decompress {1e3 * (t2 - t1):.1f} ms; K1 launches {launches['gdn']}")
    if launches["gdn"] != gdn:
        raise AssertionError(f"expected {gdn} K1 launches, saw {launches['gdn']}")
    if out.shape != images.shape or out.dtype != np.uint8:
        raise AssertionError(f"bad output {out.shape} {out.dtype}")
    fields = num_streams(codec) + 3
    if any(num_fields(b) != fields for b in blobs):
        raise AssertionError(f"expected {fields}-field blobs")

    if codec.compress_batch(images) != blobs:
        raise AssertionError("re-compression is not byte-identical")
    single = codec.decompress(blobs[0])
    if not np.array_equal(single, out[0]):
        raise AssertionError("batch-1 decode differs from the batch-8 decode")
    psnr = float(np.mean(psnr_np(out, images)))
    bpp = 8.0 * sum(len(b) for b in blobs) / (BATCH * HEIGHT * WIDTH)
    log(f"  {fields}-field blobs; re-compress byte-identical; batch-1 decode == batch-8 "
        f"row 0; PSNR {psnr:.3f} dB, {bpp:.4f} bpp")
    if not (np.isfinite(psnr) and 0.0 < bpp) or (
            min_psnr is not None and not (psnr > min_psnr and bpp < 8.0)):
        raise AssertionError("implausible rate/distortion")
    if cpu_check:
        check_small_against_cpu(module, codec.model)
    return blobs, out, launches


def phase_codec_device(codec, images, host_blobs, host_out,
                       label: str = "codec (device coder)", gdn: int = 6) -> dict:
    """A device-coded path: launches over exactly compress_batch +
    decompress_batch (K3 2 and K2 1 a y stream, K1 ``gdn``), and its outputs
    against the host coder's; each y stream within 1.1x the host coder's
    string for it plus the lane states."""
    from compression_tpu_torch.codec import rans
    from compression_tpu_torch.layers.gdn_kernel import fused_gdn
    from compression_tpu_torch.util import PackedTensors
    from compression_tpu_torch.util.image import psnr_np

    codec.decompress_batch(codec.compress_batch(images[:1], coder="device"))  # warm-up
    rans.rans_encode.launches = rans.rans_decode.launches = fused_gdn.launches = 0
    rans.rans_decode.variant_launches.update({"on_chip": 0, "global": 0})
    t0 = time.perf_counter()
    blobs = codec.compress_batch(images, coder="device")
    t1 = time.perf_counter()
    out = codec.decompress_batch(blobs)
    t2 = time.perf_counter()
    launches = {"rans_encode": rans.rans_encode.launches,
                "rans_decode": rans.rans_decode.launches, "gdn": fused_gdn.launches}
    log(f"{label}: batch {BATCH} {HEIGHT}x{WIDTH}: compress "
        f"{1e3 * (t1 - t0):.1f} ms, decompress {1e3 * (t2 - t1):.1f} ms; launches {launches}")
    S = num_streams(codec)
    if launches != {"rans_encode": 2 * S, "rans_decode": S, "gdn": gdn}:
        raise AssertionError(f"expected K3 {2 * S} (fields, lanes a stream), K2 {S}, "
                             f"K1 {gdn} launches, saw {launches}")
    variants = dict(rans.rans_decode.variant_launches)
    if variants != {"on_chip": S, "global": 0}:
        raise AssertionError(f"expected K2's on-chip variant {S} times, saw {variants}")
    y_dev, y_host = [], []
    for blob, host in zip(blobs, host_blobs):
        packed = PackedTensors(blob)
        fields = packed.unpack([object] * (S + 1) + [np.int32] * 3)
        if int(fields[S + 3][0]) != RANS_K:
            raise AssertionError(f"blob K = {int(fields[S + 3][0])}, expected {RANS_K}")
        for i in range(S):
            y_dev.append(len(bytes(fields[i][0])))
            y_host.append(len(bytes(PackedTensors(host).unpack_one(i, object)[0])))
            if y_dev[-1] > 1.1 * y_host[-1] + 4 * RANS_K + 16:
                raise AssertionError(f"y stream {i}: {y_dev[-1]} B vs host string "
                                     f"{y_host[-1]} B")
    if not np.array_equal(out, host_out):
        raise AssertionError("device-coded reconstruction differs from the host coder's")
    if codec.compress_batch(images, coder="device") != blobs:
        raise AssertionError("device-coded re-compression is not byte-identical")
    if not np.array_equal(codec.decompress(blobs[0]), out[0]):
        raise AssertionError("batch-1 decode differs from the batch-8 decode")
    bpp = 8.0 * sum(len(b) for b in blobs) / (BATCH * HEIGHT * WIDTH)
    log(f"  {S + 4}-field blobs, K={RANS_K} (no overflow fall-back); reconstruction == host "
        f"coder's (PSNR {float(np.mean(psnr_np(out, images))):.3f} dB); {bpp:.4f} bpp; "
        f"{S} y stream(s) an image, {sum(y_dev)} B vs host y strings {sum(y_host)} B "
        f"({sum(y_dev) / sum(y_host):.4f}x); re-compress byte-identical; "
        f"batch-1 decode == batch-8 row 0")
    return launches


def kind_of(kernel: str, ops: list) -> str:
    """The kind of a device activity, from its name (K1, K3, K2, copies) or
    from the CPU ops it was launched under, innermost first (ChannelNorm's
    forward, traced by a ``record_function``; Adam; K1's backward;
    convolutions backward and forward)."""
    low, chain = kernel.lower(), " ".join(ops)
    for kind, parts in (("K1", ("gdn_kernel",)), ("K3", ("rans_fields", "rans_encode")),
                        ("K2", ("rans_decode",)), ("copies", ("memcpy", "memset"))):
        if any(part in low for part in parts):
            return kind
    for kind, parts in (("channelnorm", ("hific.ChannelNorm",)), ("adam", ("Optimizer.step",)),
                        ("gdn_backward", ("FusedGDNBackward",)),
                        ("conv_backward", ("convolution_backward",)),
                        ("conv_forward", ("aten::convolution", "aten::conv2d"))):
        if any(part in chain for part in parts):
            return kind
    return "other"


def profile_device(label: str, run, steps: int = 1, top: int = 0) -> dict:
    """Device time over ``run()`` (``steps`` steps of it) with torch.profiler:
    device activities are the kernels, copies and fills (the GPU ranges of
    ``record_function`` annotations are not activities); busy is the union
    of their intervals, idle the rest of the wall time. Each activity
    counts only its time not already covered by an earlier one, so the kinds
    (``kind_of``, through the CPU op that launched it: its linked
    correlation id) add up to busy; the summed durations and the overlap
    they hide are printed beside it, with the streams and the kernels that
    overlap most. The forward convolutions' FLOPs are torch.profiler's
    count of the ``aten::conv2d`` ops (from their shapes), over their own
    device time. ChannelNorm's forward is traced by a ``record_function``
    for the run. ``top`` kernels are listed by their own time. Returns
    wall_ms, busy_ms, activity_ms, idle, device_activities, by_kind_ms and
    conv_forward_tflop."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from compression_tpu_torch.models.hific import archs

    forward = archs.ChannelNorm.forward

    def traced(self, x):
        with record_function("hific.ChannelNorm"):
            return forward(self, x)

    archs.ChannelNorm.forward = traced
    try:
        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     with_flops=True) as prof:
            t0 = time.perf_counter()
            run()
            sync()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        archs.ChannelNorm.forward = forward
    events = prof.events()
    cpu_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    ops = {e.id: e for e in events if e.device_type == DeviceType.CPU and e.kernels}
    device = sorted((k.start_ns(), k.start_ns() + k.duration_ns(), k.name(),
                     k.linked_correlation_id(), k.device_resource_id())
                    for k in prof.profiler.kineto_results.events()
                    if k.device_type() == DeviceType.CUDA and k.name() not in cpu_names)
    if not device:
        log(f"profile ({label}): the profiler saw no device activity; not measured")
        return {}
    kinds = dict.fromkeys(("conv_forward", "conv_backward", "channelnorm", "K1",
                           "gdn_backward", "adam", "K3", "K2", "copies", "other"), 0.0)
    per_kernel, overlap, end, end_stream, same_stream = {}, {}, float("-inf"), None, 0.0
    for start, stop, name, linked, stream in device:
        own = max(0, stop - max(start, end)) / 1e6
        if start < end and stream == end_stream:
            same_stream += (stop - start) / 1e6 - own
        if stop > end:
            end, end_stream = stop, stream
        chain, parent = [], ops.get(linked)
        while parent is not None:
            chain.append(parent.name)
            parent = parent.cpu_parent
        kinds[kind_of(name, chain)] += own
        ms, calls = per_kernel.get(name, (0.0, 0))
        per_kernel[name] = (ms + own, calls + 1)
        overlap[name] = overlap.get(name, 0.0) + (stop - start) / 1e6 - own
    busy = sum(kinds.values())
    total = sum(stop - start for start, stop, *_ in device) / 1e6
    tflop = sum(e.flops for e in events if e.name == "aten::conv2d" and e.flops) / 1e12
    log(f"profile ({label}): wall {wall_ms:.1f} ms, device busy {busy:.1f} ms, idle "
        f"{100 * (1 - busy / wall_ms):.1f}%, {len(device)} device activities (their "
        f"durations sum to {total:.1f} ms); by kind: "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in kinds.items() if v))
    if steps > 1:
        log(f"  a step: wall {wall_ms / steps:.2f} ms, device busy {busy / steps:.2f} ms, "
            f"{len(device) / steps:.0f} device activities; " + ", ".join(
                f"{k} {v / steps:.2f} ms ({100 * v / busy:.1f}%)" for k, v in kinds.items() if v))
    if kinds["conv_forward"]:
        log(f"  forward convolutions: {tflop:.4f} TFLOP, "
            f"{tflop / kinds['conv_forward'] * 1e3:.2f} TFLOP/s over their own device time")
    if total - busy > 0.01 * busy:
        log(f"  overlapped time {total - busy:.1f} ms ({same_stream:.1f} ms of it on the "
            f"stream of the activity it overlaps; {len({d[4] for d in device})} streams), "
            "in the activities that start before the one ahead of them ends: " + "; ".join(
                f"{ms:.1f} ms {name[:80]}"
                for name, ms in sorted(overlap.items(), key=lambda kv: -kv[1])[:3]))
    for name, (ms, calls) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"  {ms:8.2f} ms {calls:5d}x  {name[:110]}")
    return dict(wall_ms=wall_ms, busy_ms=busy, activity_ms=total, idle=1 - busy / wall_ms,
                device_activities=len(device), by_kind_ms=kinds, conv_forward_tflop=tflop)


def phase_throughput(codec, images, batches: int, card: str, coder: str,
                     label: str = "throughput") -> dict:
    batch_list = [images] * batches
    list(codec.compress_iter(batch_list[:1], coder=coder))  # warm the pipeline
    codec.timer.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blob_batches = list(codec.compress_iter(batch_list, coder=coder))
    t1 = time.perf_counter()
    decoded = list(codec.decompress_iter(blob_batches))
    t2 = time.perf_counter()
    if len(decoded) != batches or any(d.shape != images.shape for d in decoded):
        raise AssertionError("pipelined decode returned the wrong batches")
    n = batches * BATCH
    rates = {"compress_iter": n / (t1 - t0), "decompress_iter": n / (t2 - t1),
             "round_trip": n / (t2 - t0)}
    log(f"{label}, {coder} coder ({card}): compress_iter {rates['compress_iter']:.3f} img/s, "
        f"decompress_iter {rates['decompress_iter']:.3f} img/s, round trip "
        f"{rates['round_trip']:.3f} img/s over {batches} batches of {BATCH}")
    log(codec.timer.report())
    return rates


def train_gdn_shapes():
    """(label, rows, inverse, checkpoint layer) of a training step's 6 K1
    calls on TRAIN_BATCH crops of TRAIN_PATCH."""
    shapes = []
    for i, div in enumerate((2, 4, 8)):
        side = TRAIN_PATCH // div
        shapes.append((f"gdn{i} {side}x{side}", TRAIN_BATCH * side * side, False,
                       ("analysis", f"gdn{i}")))
    for i, div in enumerate((8, 4, 2)):
        side = TRAIN_PATCH // div
        shapes.append((f"igdn{i} {side}x{side}", TRAIN_BATCH * side * side, True,
                       ("synthesis", f"igdn{i}")))
    return shapes


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| over the largest |want|."""
    return (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)


def gdn_backward_bounds_ms(rows: int, c: int) -> dict:
    """Least times of one GDN backward (dx, dbeta, dgamma from x, the output
    gradient, beta and gamma): x and the gradient read once and dx written
    once over the HBM rate; its three (rows x C x C) products over the
    tensor cores' TF32 rate in 3xTF32, or over the fp32 CUDA-core rate."""
    nbytes = 3 * rows * c * 4 + 2 * (c * c + c) * 4
    flops = 3 * 2 * rows * c * c
    return {"bound_bytes_ms": 1e3 * nbytes / PEAK_HBM_BYTES,
            "bound_tf32_ms": 1e3 * 3 * flops / PEAK_TF32_FLOPS,
            "bound_fp32_ms": 1e3 * flops / PEAK_FP32_FLOPS}


def check_gdn_backward(model, reps: int) -> dict:
    """8a: FusedGDN's gradients against autograd through the twin at the six
    training shapes, on the checkpoint's effective beta and gamma; the
    backward's plain ops timed alone, and forward+backward of the Function
    and of the twin under autograd."""
    from compression_tpu_torch.layers import parameters
    from compression_tpu_torch.layers.gdn_kernel import (
        FusedGDN, fused_gdn_backward, fused_gdn_reference)

    gen = torch.Generator(device=DEVICE).manual_seed(2)
    totals = dict(backward_ms=0.0, fwd_bwd_ms=0.0, twin_fwd_bwd_ms=0.0)
    worst = 0.0
    for label, rows, inverse, (tname, lname) in train_gdn_shapes():
        layer = getattr(getattr(model, tname), lname)
        with torch.no_grad():
            beta = parameters.nonneg_apply(layer.beta, layer.beta_min).to(DEVICE)
            gamma = parameters.nonneg_apply(layer.gamma, 0.0).to(DEVICE)
        c = gamma.shape[0]
        x = torch.randn(rows, c, device=DEVICE, generator=gen)
        gy = torch.randn(rows, c, device=DEVICE, generator=gen)
        leaves = {}

        def fwd_bwd(fn, key):
            leaves[key] = [t.clone().requires_grad_() for t in (x, beta, gamma)]
            return torch.autograd.grad(fn(*leaves[key], inverse), leaves[key], gy)

        got = fwd_bwd(FusedGDN.apply, "fn")
        want = fwd_bwd(fused_gdn_reference, "twin")
        sync()
        errs = []
        for name, g, w in zip(("dx", "dbeta", "dgamma"), got, want):
            torch.testing.assert_close(g, w, rtol=TRAIN_GDN_TOL,
                                       atol=TRAIN_GDN_TOL * w.abs().max().item(),
                                       msg=lambda m, name=name: f"8a {label} {name}: {m}")
            errs.append(rel_err(g, w))
        worst = max(worst, *errs)
        times = {
            "backward_ms": cuda_ms(lambda: fused_gdn_backward(gy, x, beta, gamma, inverse), reps),
            "fwd_bwd_ms": cuda_ms(lambda: fwd_bwd(FusedGDN.apply, "fn"), reps),
            "twin_fwd_bwd_ms": cuda_ms(lambda: fwd_bwd(fused_gdn_reference, "twin"), reps),
        }
        for k, v in times.items():
            totals[k] += v
        for k, v in gdn_backward_bounds_ms(rows, c).items():
            totals[k] = totals.get(k, 0.0) + v
        log(f"  8a {label:14s} rows {rows:7d}  dx/dbeta/dgamma vs twin autograd "
            f"{errs[0]:.2e}/{errs[1]:.2e}/{errs[2]:.2e} of the largest entry; "
            f"backward ops {times['backward_ms']:.4f} ms, Function fwd+bwd "
            f"{times['fwd_bwd_ms']:.4f} ms, twin fwd+bwd {times['twin_fwd_bwd_ms']:.4f} ms")
        del x, gy, got, want, leaves
    log(f"  8a over the 6 training calls: backward ops {totals['backward_ms']:.4f} ms, "
        f"Function fwd+bwd {totals['fwd_bwd_ms']:.4f} ms, twin fwd+bwd "
        f"{totals['twin_fwd_bwd_ms']:.4f} ms; the backward's bound {totals['bound_bytes_ms']:.4f} "
        f"ms (bytes), {totals['bound_tf32_ms']:.4f} ms (3xTF32 ops), "
        f"{totals['bound_fp32_ms']:.4f} ms (fp32 ops); worst gradient error {worst:.2e} "
        f"(tolerance {TRAIN_GDN_TOL})")
    return dict(max_rel_err=worst, **totals)


def ckpt_model(distortion: str = "mse"):
    """bmshj2018 at full width with the committed checkpoint's weights (on
    the CPU)."""
    from compression_tpu_torch.models import bmshj2018

    return bmshj2018.load_model(ROOT / "ckpt" / "bmshj2018.msgpack",
                                bmshj2018.Config(distortion=distortion))


def train_batches(batch: int, seed: int = 0):
    from compression_tpu_torch.models import common

    return common.crop_dataset(common.TrainConfig(batch_size=batch, patch_size=TRAIN_PATCH,
                                                  seed=seed))


def check_step_against_cpu(make_model, make_loss_fn, label: str) -> float:
    """One quantized (training=False) step of 2 crops, card against CPU:
    the loss and every gradient of ``make_model()``'s weights."""
    x = torch.from_numpy(next(train_batches(2)))
    out = {}
    for device in (DEVICE, "cpu"):
        model = make_model().to(device)
        loss, metrics = make_loss_fn(model, training=False)(x.to(device))
        loss.backward()
        out[device] = (loss.item(), {k: v.item() for k, v in metrics.items()},
                       {n: p.grad.cpu() for n, p in model.named_parameters()})
    (loss_gpu, m_gpu, g_gpu), (loss_cpu, m_cpu, g_cpu) = out[DEVICE], out["cpu"]
    np.testing.assert_allclose(loss_gpu, loss_cpu, rtol=1e-4)
    errs = {n: rel_err(g_gpu[n], g_cpu[n]) for n in g_cpu}
    worst = max(errs, key=errs.get)
    log(f"  {label} quantized step, 2 crops: loss card {loss_gpu:.6f} cpu {loss_cpu:.6f} "
        f"(bpp {m_gpu['bpp']:.5f}/{m_cpu['bpp']:.5f}, mse {m_gpu['mse']:.4f}/{m_cpu['mse']:.4f}); "
        f"{len(errs)} gradients, worst {errs[worst]:.2e} of its largest entry ({worst}), "
        f"median {float(np.median(list(errs.values()))):.2e}")
    bad = {n: e for n, e in errs.items() if e > TRAIN_CPU_TOL}
    if bad:
        raise AssertionError(f"{label}: gradients off the CPU's by more than {TRAIN_CPU_TOL}: {bad}")
    return errs[worst]


def count_step_launches(model, make_loss_fn, label: str, gdn: int = 6,
                        tcfg=None) -> dict:
    """A training main path's run: one train_step of a batch of 8 of
    ``model`` (Adam as ``tcfg`` sets it), the counts set to 0 just before
    and read just after; ``gdn`` K1 launches expected."""
    from compression_tpu_torch.codec import rans
    from compression_tpu_torch.layers.gdn_kernel import fused_gdn
    from compression_tpu_torch.models import common

    tcfg = tcfg or common.TrainConfig()
    model = model.to(DEVICE)
    optimizer = common.make_optimizer(model, tcfg)
    loss_fn = make_loss_fn(model)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    x = torch.from_numpy(next(train_batches(TRAIN_BATCH))).to(DEVICE)
    common.train_step(model, optimizer, loss_fn, x, gen, common.lr_schedule(tcfg))  # warm-up
    sync()
    fused_gdn.launches = rans.rans_encode.launches = rans.rans_decode.launches = 0
    loss, _ = common.train_step(model, optimizer, loss_fn, x, gen, common.lr_schedule(tcfg))
    sync()
    launches = {"gdn": fused_gdn.launches, "rans_encode": rans.rans_encode.launches,
                "rans_decode": rans.rans_decode.launches}
    log(f"  {label} one training step of {TRAIN_BATCH}x{TRAIN_PATCH}x{TRAIN_PATCH}: launches "
        f"{launches} (loss {loss.item():.4f})")
    if launches != {"gdn": gdn, "rans_encode": 0, "rans_decode": 0}:
        raise AssertionError(f"{label}: expected K1 {gdn}, K3 0, K2 0 launches, "
                             f"saw {launches}")
    return launches


def train_from_checkpoint(steps: int = 50) -> None:
    """8d: train_model from the checkpoint at lr 1e-4."""
    from compression_tpu_torch.models import bmshj2018, common

    seen = {}
    model = ckpt_model()
    common.train_model(model, bmshj2018.make_loss_fn(model),
                       common.TrainConfig(steps=steps, log_every=1, seed=0, learning_rate=1e-4),
                       hooks=lambda step, m: seen.setdefault(step, m), device=DEVICE)
    if sorted(seen) != list(range(1, steps + 1)) or not all(
            np.isfinite(list(m.values())).all() for m in seen.values()):
        raise AssertionError("8d: missing or non-finite training metrics")
    log("  8d train_model from the checkpoint, lr 1e-4: " + "; ".join(
        f"step {k}: loss {seen[k]['loss']:.4f} bpp {seen[k]['bpp']:.4f} mse {seen[k]['mse']:.3f}"
        for k in (1, 10, steps)))


def train_fixed_batch(model, loss_fn, steps: int, label: str) -> dict:
    """``steps`` training steps of ``model`` (seeded init) on one fixed
    batch of TRAIN_BATCH crops: every loss finite, and the mean of the last
    10 losses below the mean of the first 10."""
    from compression_tpu_torch.models import common

    tcfg = common.TrainConfig()
    model.to(DEVICE).train()
    optimizer = common.make_optimizer(model, tcfg)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    x = torch.from_numpy(next(train_batches(TRAIN_BATCH))).to(DEVICE)
    schedule = common.lr_schedule(tcfg)
    sync()
    t0 = time.perf_counter()
    losses = torch.stack([common.train_step(model, optimizer, loss_fn, x, gen, schedule)[0]
                          .detach() for _ in range(steps)]).cpu().numpy()
    seconds = time.perf_counter() - t0
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    log(f"  {label}: {steps} steps from the seeded init on one batch of {TRAIN_BATCH}x"
        f"{TRAIN_PATCH}x{TRAIN_PATCH}: mean loss of the first 10 {first:.4f}, of the last "
        f"10 {last:.4f} (step 1 {losses[0]:.4f}, step {steps} {losses[-1]:.4f}); "
        f"{1e3 * seconds / steps:.2f} ms a step")
    if not (np.isfinite(losses).all() and last < first):
        raise AssertionError(f"{label}: the loss did not fall")
    return dict(first=first, last=last, step_ms=1e3 * seconds / steps)


def check_resume(k: int = 3) -> None:
    """8f: save after k steps, restore into a fresh model and optimizer, then
    resume through train_model."""
    import tempfile

    from compression_tpu_torch.models import bmshj2018, common

    with tempfile.TemporaryDirectory() as tmp:
        tcfg = common.TrainConfig(steps=k, log_every=1, checkpoint_dir=tmp,
                                  checkpoint_name="bmshj2018.train.msgpack", seed=0)
        path = os.path.join(tmp, tcfg.checkpoint_name)
        model = ckpt_model().to(DEVICE)
        optimizer = common.make_optimizer(model, tcfg)
        loss_fn = bmshj2018.make_loss_fn(model)
        gen = torch.Generator(device=DEVICE).manual_seed(tcfg.seed)
        data = train_batches(TRAIN_BATCH, tcfg.seed)
        next(data)
        for _ in range(k):
            common.train_step(model, optimizer, loss_fn, torch.from_numpy(next(data)).to(DEVICE),
                              gen, common.lr_schedule(tcfg))
        common.save_checkpoint(path, model, k, optimizer, tcfg)
        fresh = bmshj2018.BMSHJ2018Model(bmshj2018.Config(), seed=1).to(DEVICE)
        fresh_opt = common.make_optimizer(fresh, tcfg)
        step, with_moments = common.restore_checkpoint(path, fresh, fresh_opt)
        live = dict(model.named_parameters())
        same = step == k and with_moments and common._updates_done(fresh_opt) == k
        for name, p in fresh.named_parameters():
            saved, restored = optimizer.state[live[name]], fresh_opt.state[p]
            same &= torch.equal(p, live[name]) and all(
                torch.equal(saved[key], restored[key]) for key in ("exp_avg", "exp_avg_sq"))
        if not same:
            raise AssertionError("8f: restored params or moments differ from the saved run")
        seen = []
        common.train_model(fresh, bmshj2018.make_loss_fn(fresh),
                           dataclasses.replace(tcfg, steps=k + 1),
                           hooks=lambda s, m: seen.append((s, m["loss"])), device=DEVICE)
        final_step = common.load_checkpoint(path)[1]
    if [s for s, _ in seen] != [k + 1] or final_step != k + 1 or not np.isfinite(seen[0][1]):
        raise AssertionError(f"8f: resumed run logged {seen}, saved step {final_step}")
    log(f"  8f saved at step {k}, restored into a fresh model and Adam: params and moments "
        f"bit-equal; train_model resumed and took step {k + 1} (loss {seen[0][1]:.4f}); "
        f"noise and data restart from the seed, as in the JAX package")


def train_msssim(steps: int = 3) -> None:
    """8g: MS-SSIM as the distortion."""
    from compression_tpu_torch.models import bmshj2018, common

    seen = []
    model = ckpt_model("msssim")
    common.train_model(model, bmshj2018.make_loss_fn(model),
                       common.TrainConfig(steps=steps, log_every=1, seed=0),
                       hooks=lambda s, m: seen.append(m), device=DEVICE)
    if len(seen) != steps or not all(np.isfinite(list(m.values())).all() for m in seen):
        raise AssertionError(f"8g: msssim training gave {seen}")
    log(f"  8g distortion msssim, {TRAIN_PATCH}x{TRAIN_PATCH} crops: " + "; ".join(
        f"step {i + 1}: loss {m['loss']:.5f} bpp {m['bpp']:.4f} msssim {m['msssim']:.5f}"
        for i, m in enumerate(seen)))


def time_training(card: str) -> dict:
    """8h: train_model's rate over 50 steps after 5 warm-up steps, then a
    profile of 10 steps of its loop body."""
    from compression_tpu_torch.models import bmshj2018, common

    marks = {}

    def hook(step, m):
        marks[step] = time.perf_counter()  # m was read with .item(): synced

    model = ckpt_model()
    common.train_model(model, bmshj2018.make_loss_fn(model),
                       common.TrainConfig(steps=55, log_every=5, seed=0), hooks=hook,
                       device=DEVICE)
    step_ms = 1e3 * (marks[55] - marks[5]) / 50
    rate = dict(step_ms=step_ms, steps_per_s=1e3 / step_ms,
                img_per_s=TRAIN_BATCH * 1e3 / step_ms)
    log(f"  8h train_model ({card}): {rate['step_ms']:.2f} ms a step, "
        f"{rate['steps_per_s']:.3f} steps/s, {rate['img_per_s']:.2f} img/s over 50 steps of "
        f"{TRAIN_BATCH}x{TRAIN_PATCH}x{TRAIN_PATCH} after 5 warm-up steps; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    tcfg = common.TrainConfig()
    optimizer = common.make_optimizer(model, tcfg)
    loss_fn = bmshj2018.make_loss_fn(model)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    data = train_batches(TRAIN_BATCH)
    schedule = common.lr_schedule(tcfg)

    def steps(n):
        for _ in range(n):
            x = torch.from_numpy(next(data)).pin_memory().to(DEVICE, non_blocking=True)
            common.train_step(model, optimizer, loss_fn, x, gen, schedule)

    steps(2)  # Adam's state exists before the profiled window
    prof = profile_device(f"8h 10 training steps, {card}", lambda: steps(10), steps=10,
                          top=12)
    # Host time a step, without the profiler: making a batch, and enqueuing
    # a step on a batch already on the card (the device runs behind it).
    t0 = time.perf_counter()
    batches = [next(data) for _ in range(10)]
    data_ms = 1e2 * (time.perf_counter() - t0)
    x = torch.from_numpy(batches[0]).to(DEVICE)
    sync()
    t0 = time.perf_counter()
    for _ in range(10):
        common.train_step(model, optimizer, loss_fn, x, gen, schedule)
    dispatch_ms = 1e2 * (time.perf_counter() - t0)
    sync()
    device_ms = 1e2 * (time.perf_counter() - t0)
    log(f"  8h host a step: synthetic batch {data_ms:.2f} ms, enqueue of train_step "
        f"{dispatch_ms:.2f} ms (10 steps done on the card after {device_ms:.2f} ms a step)")
    return dict(rate, **prof, host_data_ms=data_ms, host_dispatch_ms=dispatch_ms)


def phase_training(model, card: str, reps: int) -> dict:
    from compression_tpu_torch.models import bmshj2018

    log("training (phase 8):")
    gdn_bwd = check_gdn_backward(model, reps)
    cpu_err = check_step_against_cpu(ckpt_model, bmshj2018.make_loss_fn, "8b")
    launches = count_step_launches(ckpt_model(), bmshj2018.make_loss_fn, "8c")
    train_from_checkpoint()
    scratch = bmshj2018.BMSHJ2018Model(bmshj2018.Config(), seed=0)
    train_fixed_batch(scratch, bmshj2018.make_loss_fn(scratch), 100, "8e")
    check_resume()
    train_msssim()
    timing = time_training(card)
    return dict(launches=launches, gdn_backward=gdn_bwd, cpu_max_rel_err=cpu_err, **timing)


# -- phases 9-10: the other families at full width -----------------------------
#
# The JAX package's registry (compression_tpu/cli/registry.py) serves them at
# these widths; no trained checkpoint of theirs is in the repository, so each
# trains from its seeded init on crop_dataset's synthetic fallback first.

FAMILY_STEPS = 100  # phase 9: steps from the seed on one fixed batch
MBT_STEPS = 200     # phase 10: steps of train_model on fresh synthetic crops


def factorized_configs() -> dict:
    """Phase 9's models: bls2017 at 128 filters, bmshj2018-factorized at
    192 filters and 192 latents (registry.py:57, 137)."""
    from compression_tpu_torch.models import bls2017

    return {"bls2017": bls2017.Config(),
            "bmshj2018-factorized": bls2017.Config(
                num_filters=192, num_latents=192, arch="bmshj2018",
                model_name="bmshj2018-factorized")}


def mbt2018_config():
    """Phase 10's model: mbt2018-mean at 192/320/192 (registry.py:97)."""
    from compression_tpu_torch.models import mbt2018

    return mbt2018.Config()


def check_k1_on_path(model, run, label: str) -> float:
    """K1 against its twin on exactly the inputs ``model``'s GDN layers get
    in ``run()`` (captured by forward hooks), at the kernel tolerance."""
    from compression_tpu_torch.layers import GDN, parameters
    from compression_tpu_torch.layers.gdn_kernel import fused_gdn, fused_gdn_reference

    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out: seen.append((mod, args[0].detach().contiguous())))
        for m in model.modules() if isinstance(m, GDN)]
    try:
        run()
    finally:
        for hook in hooks:
            hook.remove()
    worst = 0.0
    with torch.inference_mode():
        for mod, x in seen:
            beta = parameters.nonneg_apply(mod.beta, mod.beta_min)
            gamma = parameters.nonneg_apply(mod.gamma, 0.0)
            got = fused_gdn(x, beta, gamma, mod.inverse)
            want = fused_gdn_reference(x, beta, gamma, mod.inverse)
            sync()
            worst = max(worst, (got - want).abs().max().item())
            torch.testing.assert_close(got, want, rtol=GDN_TOL, atol=GDN_TOL)
    shapes = ", ".join(f"{'IGDN' if mod.inverse else 'GDN'} {x.numel() // x.shape[-1]}x"
                       f"{x.shape[-1]}" for mod, x in seen)
    log(f"  {label}: K1 == twin on the {len(seen)} GDN inputs of one round trip "
        f"(rows x C: {shapes}); max_abs_err {worst:.3e}")
    return worst


def phase_factorized(card: str) -> dict:
    """Phase 9: bls2017 and bmshj2018-factorized at full width: training
    from the seed, then the one-image codec over the 8 images; and an
    8-filter model's round trip (K1 at C = 8, padded to 32)."""
    from compression_tpu_torch.layers.gdn_kernel import fused_gdn
    from compression_tpu_torch.models import bls2017
    from compression_tpu_torch.util import PackedTensors
    from compression_tpu_torch.util.image import psnr_np

    log(f"factorized-prior codecs (phase 9; {card}):")
    images = structured_images()
    results = {}
    for name, cfg in factorized_configs().items():
        model = bls2017.BLS2017Model(cfg, seed=0)
        train = train_fixed_batch(model, bls2017.make_loss_fn(model), FAMILY_STEPS,
                                  f"9 {name}")
        codec = bls2017.Codec(model, device=DEVICE)
        codec.decompress(codec.compress(images[0]))  # warm-up
        # The path's run: the counts cover exactly one compress + decompress.
        fused_gdn.launches = 0
        blob = codec.compress(images[0])
        first = codec.decompress(blob)
        launches = {"gdn": fused_gdn.launches}
        want = 4 if cfg.arch == "bls2017" else 6
        if launches["gdn"] != want:
            raise AssertionError(f"9 {name}: expected {want} K1 launches, saw {launches}")
        t0 = time.perf_counter()
        blobs = [codec.compress(image) for image in images]
        t1 = time.perf_counter()
        out = np.stack([codec.decompress(b) for b in blobs])
        t2 = time.perf_counter()
        if blobs[0] != blob or not np.array_equal(out[0], first):
            raise AssertionError(f"9 {name}: a second round trip differs from the first")
        if [codec.compress(image) for image in images] != blobs:
            raise AssertionError(f"9 {name}: re-compression is not byte-identical")
        if out.shape != images.shape or any(
                len([k for k, *_ in PackedTensors(b).describe() if k != "MD"]) != 3
                for b in blobs):
            raise AssertionError(f"9 {name}: bad output or blob format")
        psnr = float(np.mean(psnr_np(out, images)))
        bpp = 8.0 * sum(len(b) for b in blobs) / (BATCH * HEIGHT * WIDTH)
        rates = {"compress_img_per_s": BATCH / (t1 - t0),
                 "decompress_img_per_s": BATCH / (t2 - t1)}
        log(f"  9 {name} codec ({card}), {BATCH} images of {HEIGHT}x{WIDTH} one by one: "
            f"K1 launches {launches['gdn']} a round trip; 3-field blobs, re-compress "
            f"byte-identical; PSNR {psnr:.3f} dB, {bpp:.4f} bpp; compress "
            f"{rates['compress_img_per_s']:.3f} img/s, decompress "
            f"{rates['decompress_img_per_s']:.3f} img/s")
        if not (np.isfinite(psnr) and 0.0 < bpp):
            raise AssertionError(f"9 {name}: implausible rate/distortion")
        k1_err = check_k1_on_path(codec.model, lambda: codec.decompress(codec.compress(images[0])),
                                  f"9 {name}")
        check_small_against_cpu(bls2017, codec.model, hw=(96, 130))
        results[name] = dict(launches=launches, psnr=psnr, bpp=bpp, k1_max_abs_err=k1_err,
                             train=train, **rates)
        del codec, model
    # Any GDN width through K1 end to end: an 8-filter model's round trip.
    tiny = bls2017.BLS2017Model(bls2017.Config(num_filters=8), seed=0)
    tiny_launches = check_small_against_cpu(bls2017, tiny, hw=(96, 130))
    if tiny_launches != 4:
        raise AssertionError(f"9 8 filters: expected 4 K1 launches, saw {tiny_launches}")
    codec = bls2017.Codec(tiny, device=DEVICE)
    image = structured_image(HEIGHT, WIDTH)[:96, :130]
    results["bls2017 8 filters"] = dict(
        launches={"gdn": tiny_launches},
        k1_max_abs_err=check_k1_on_path(tiny, lambda: codec.decompress(codec.compress(image)),
                                        "9 bls2017 8 filters"))
    return results


def time_quantization_offset(model, label: str, reps: int = 20) -> dict:
    """10a, 12a: the quantization-offset root-find ``side_em.quantize(z)`` runs
    every training step (plain torch ops on the prior's device): the host
    syncs it makes, its wall time, and its offsets against the same
    root-find on the CPU."""
    import warnings

    from compression_tpu_torch.entropy_models import ContinuousBatchedEntropyModel

    side_em = ContinuousBatchedEntropyModel(model.hyperprior(), coding_rank=3)
    side_em.quantization_offset()
    syncs = None
    if DEVICE == "cuda":
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                side_em.quantization_offset()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        syncs = sum("synchroniz" in str(w.message) for w in caught)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        offset = side_em.quantization_offset()
    sync()
    ms = 1e3 * (time.perf_counter() - t0) / reps
    cpu = ContinuousBatchedEntropyModel(model.hyperprior(device="cpu"), coding_rank=3)
    diff = (offset.cpu() - cpu.quantization_offset()).abs().max().item()
    log(f"  {label} quantization offset (the root-find of side_em.quantize, "
        f"{model.config.num_hyperlatents} channels): {ms:.3f} ms a call, {syncs} host syncs "
        f"a call; offsets within {diff:.2e} of the CPU's")
    return dict(ms=ms, syncs=syncs, max_abs_diff_vs_cpu=diff)


def train_from_seed(model, loss_fn, steps: int, label: str, card: str, **tcfg_kw) -> dict:
    """``steps`` of train_model from ``model``'s seeded init on fresh
    synthetic crops (``TrainConfig`` fields from ``tcfg_kw``): every loss
    finite and the mean of the last 10 below the mean of the first 10; ms a
    step, steps/s and img/s over steps 21 on (the hook reads every loss:
    one sync a step)."""
    from compression_tpu_torch.models import common

    seen, marks = {}, {}

    def hook(step, m):
        seen[step] = m["loss"]  # read with .item(): synced each step
        marks[step] = time.perf_counter()

    with contextlib.redirect_stdout(io.StringIO()):  # its line a step
        common.train_model(model, loss_fn,
                           common.TrainConfig(steps=steps, log_every=1, seed=0, **tcfg_kw),
                           hooks=hook, device=DEVICE)
    losses = np.array([seen[k] for k in sorted(seen)])
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    step_ms = 1e3 * (marks[steps] - marks[20]) / (steps - 20)
    train = dict(first=first, last=last, step_ms=step_ms, steps_per_s=1e3 / step_ms,
                 img_per_s=TRAIN_BATCH * 1e3 / step_ms)
    log(f"  {label} train_model, {steps} steps from the seed on fresh {TRAIN_BATCH}x"
        f"{TRAIN_PATCH}x{TRAIN_PATCH} synthetic crops ({card}): mean loss of the first 10 "
        f"{first:.4f}, of the last 10 {last:.4f} (step 1 {losses[0]:.4f}, step {steps} "
        f"{losses[-1]:.4f}); {step_ms:.2f} ms a step, {train['steps_per_s']:.3f} steps/s, "
        f"{train['img_per_s']:.2f} img/s over steps 21-{steps} (the hook reads every "
        f"loss: one sync a step)")
    if len(losses) != steps or not np.isfinite(losses).all() or not last < first:
        raise AssertionError(f"{label}: missing or non-finite losses, or the loss did not fall")
    return train


def phase_mbt2018(card: str, reps: int, batches: int) -> dict:
    """Phase 10: mbt2018-mean at full width: train_model from the seed, a
    card-against-CPU step, the codec with both coders over the 8 images, K3
    and K2 on its symbols and rows, throughput and a profile."""
    from compression_tpu_torch.models import mbt2018

    log(f"mbt2018-mean at full width (phase 10; {card}):")
    cfg = mbt2018_config()
    model = mbt2018.MBT2018Model(cfg, seed=0)
    train = train_from_seed(model, mbt2018.make_loss_fn(model), MBT_STEPS, "10a", card)
    train["quantization_offset"] = time_quantization_offset(model, "10a")
    train["launches"] = count_step_launches(mbt2018.MBT2018Model(cfg, seed=1),
                                            mbt2018.make_loss_fn, "10a")
    small = mbt2018.Config(num_filters=32, num_latents=32, num_hyperlatents=32)
    train["cpu_max_rel_err"] = check_step_against_cpu(
        lambda: mbt2018.MBT2018Model(small, seed=3), mbt2018.make_loss_fn, "10b C=32")

    codec = mbt2018.Codec(model, device=DEVICE)
    images = structured_images()
    host_blobs, host_out, host_launches = phase_codec(
        codec, images, mbt2018, label="10c mbt2018 codec", min_psnr=None)
    launches = phase_codec_device(codec, images, host_blobs, host_out,
                                  label="10c mbt2018 codec (device coder)")
    k1_err = check_k1_on_path(
        codec.model, lambda: codec.decompress_batch(codec.compress_batch(images, coder="device")),
        "10c mbt2018")
    log("10d K3/K2 on mbt2018's symbols and rows:")
    rans_k = phase_rans_kernels(codec, images, reps, main_path=False)
    rates = {coder: phase_throughput(codec, images, batches, card, coder,
                                     label="10e mbt2018 throughput")
             for coder in ("host", "device")}
    for coder in ("host", "device"):
        profile_device(
            f"10f mbt2018, {coder} coder, compress_batch + decompress_batch of {BATCH}",
            lambda: codec.decompress_batch(codec.compress_batch(images, coder=coder)), top=10)
    return dict(train=train, host_launches=host_launches, launches=launches,
                k1_max_abs_err=k1_err, rans=rans_k, throughput=rates)


# -- phases 11-12: b2018 and ms2020 at full width --------------------------------

B2018_STEPS = 100   # phase 11: steps of train_model from the seed
MS2020_STEPS = 100  # phase 12: the same


def b2018_configs() -> dict:
    """Phase 11's models: b2018-gdn at 192 filters and b2018-leaky_relu at
    128 (registry.py:245-249), 4 rate points each."""
    from compression_tpu_torch.models import b2018

    return {"b2018-gdn-192": b2018.Config(num_filters=192, model_name="b2018-gdn-192"),
            "b2018-leaky_relu-128": b2018.Config(activation="leaky_relu",
                                                 model_name="b2018-leaky_relu-128")}


def phase_b2018(card: str) -> dict:
    """Phase 11: the two b2018 models at full width: train_model from the
    seed, the launches of a training step, then the one-image codec over
    the 8 images at each quality."""
    from compression_tpu_torch.layers.gdn_kernel import fused_gdn
    from compression_tpu_torch.models import b2018, common
    from compression_tpu_torch.models.device_coding import num_fields
    from compression_tpu_torch.util import PackedTensors
    from compression_tpu_torch.util.image import psnr_np

    log(f"b2018 variable-rate codecs (phase 11; {card}):")
    images = structured_images()
    results = {}
    for name, cfg in b2018_configs().items():
        gdn = 4 if cfg.activation == "gdn" else 0
        model = b2018.B2018Model(cfg, seed=0)
        train = train_from_seed(model, b2018.make_loss_fn(model), B2018_STEPS, f"11 {name}",
                                card, lr_scales=b2018.LR_SCALES)
        train["launches"] = count_step_launches(
            b2018.B2018Model(cfg, seed=1), b2018.make_loss_fn, f"11 {name}", gdn=gdn,
            tcfg=common.TrainConfig(lr_scales=b2018.LR_SCALES))
        codec = b2018.Codec(model, device=DEVICE)
        codec.decompress(codec.compress(images[0], quality=1))  # warm-up
        # The path's run: the counts cover exactly one compress + decompress.
        fused_gdn.launches = 0
        blob = codec.compress(images[0], quality=cfg.num_qualities)
        first = codec.decompress(blob)
        launches = {"gdn": fused_gdn.launches}
        if launches["gdn"] != gdn:
            raise AssertionError(f"11 {name}: expected {gdn} K1 launches, saw {launches}")
        per_q = {}
        for quality in range(1, cfg.num_qualities + 1):
            t0 = time.perf_counter()
            blobs = [codec.compress(image, quality=quality) for image in images]
            t1 = time.perf_counter()
            out = np.stack([codec.decompress(b) for b in blobs])
            t2 = time.perf_counter()
            if [codec.compress(image, quality=quality) for image in images] != blobs:
                raise AssertionError(f"11 {name} q{quality}: re-compression is not "
                                     "byte-identical")
            if out.shape != images.shape or any(
                    num_fields(b) != 3 or PackedTensors(b).model != cfg.model_name
                    or int(PackedTensors(b).unpack_one(2, np.int32)[2]) != quality - 1
                    for b in blobs):
                raise AssertionError(f"11 {name} q{quality}: bad output or blob format")
            per_q[quality] = dict(
                psnr=float(np.mean(psnr_np(out, images))),
                bpp=8.0 * sum(len(b) for b in blobs) / (BATCH * HEIGHT * WIDTH),
                compress_img_per_s=BATCH / (t1 - t0), decompress_img_per_s=BATCH / (t2 - t1))
        if blobs[0] != blob or not np.array_equal(out[0], first):
            raise AssertionError(f"11 {name}: a second round trip differs from the first")
        log(f"  11 {name} codec ({card}), {BATCH} images of {HEIGHT}x{WIDTH} one by one at "
            f"each quality: K1 launches {launches['gdn']} a round trip; 3-field blobs "
            f"carrying q, re-compress byte-identical; " + "; ".join(
                f"q{q} {r['bpp']:.4f} bpp {r['psnr']:.3f} dB ({r['compress_img_per_s']:.3f} / "
                f"{r['decompress_img_per_s']:.3f} img/s)" for q, r in per_q.items()))
        if not (per_q[cfg.num_qualities]["bpp"] > per_q[1]["bpp"]
                and all(np.isfinite(r["psnr"]) for r in per_q.values())):
            raise AssertionError(f"11 {name}: bpp at q4 not above bpp at q1")
        k1_err = (check_k1_on_path(codec.model, lambda: codec.decompress(
            codec.compress(images[0], quality=2)), f"11 {name}") if gdn else None)
        small = check_small_against_cpu(b2018, codec.model, hw=(96, 130), quality=2)
        if small != gdn:
            raise AssertionError(f"11 {name}: the small round trip launched K1 {small} times")
        results[name] = dict(launches=launches, train=train, qualities=per_q,
                             k1_max_abs_err=k1_err)
        del codec, model
    return results


def ms2020_config():
    """Phase 12's model: ms2020-cc10 at 192/320/192, 10 slices of 32
    (registry.py:238)."""
    from compression_tpu_torch.models import ms2020

    return ms2020.Config()


def time_slice_chain(codec, images) -> dict:
    """12e: an encode's device chain over the batch: the front (analysis,
    hyper-analysis, z symbols) alone and the whole chain with the per-image
    slice chain (the supports, then each slice's mean, scale and LRP
    transforms, image by image): the host's enqueue ms, the ms until the
    device is done, and the device activities and busy ms of
    ``profile_device``."""
    from compression_tpu_torch.util.image import pad_to_multiple_np

    x = pad_to_multiple_np(images, codec.cfg.downscale)[0]
    runs = {"front": lambda: codec._front(codec._to_device(x)),
            "chain": lambda: codec._encode_slices(images)}
    out = {}
    for name, run in runs.items():
        with codec._on_device():
            run()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            prof = profile_device(f"12e ms2020 encode, {name}", run)
        out[name] = dict(enqueue_ms=1e3 * (t1 - t0), done_ms=1e3 * (t2 - t0),
                         device_activities=prof["device_activities"], busy_ms=prof["busy_ms"])
    per_image = {k: (out["chain"][k] - out["front"][k]) / BATCH
                 for k in ("enqueue_ms", "done_ms", "device_activities", "busy_ms")}
    log(f"  12e encode chain of {BATCH}x{HEIGHT}x{WIDTH}: front {out['front']['enqueue_ms']:.2f} ms "
        f"to enqueue, {out['front']['device_activities']} device activities, busy "
        f"{out['front']['busy_ms']:.2f} ms; with the slice chain {out['chain']['enqueue_ms']:.2f} "
        f"ms to enqueue, done after {out['chain']['done_ms']:.2f} ms, "
        f"{out['chain']['device_activities']} device activities, busy "
        f"{out['chain']['busy_ms']:.2f} ms; the slice chain an image: "
        f"{per_image['device_activities']:.1f} device activities, "
        f"{per_image['enqueue_ms']:.3f} ms of host enqueue, {per_image['busy_ms']:.3f} ms "
        f"of device work")
    return dict(out, per_image=per_image)


def phase_ms2020(card: str, reps: int, batches: int) -> dict:
    """Phase 12: ms2020-cc10 at full width: train_model from the seed, the
    codec with both coders over the 8 images, K3 and K2 on slice 0's
    symbols and rows, throughput, the slice chain's cost and a profile."""
    from compression_tpu_torch.models import ms2020

    log(f"ms2020-cc10 at full width (phase 12; {card}):")
    cfg = ms2020_config()
    model = ms2020.MS2020Model(cfg, seed=0)
    train = train_from_seed(model, ms2020.make_loss_fn(model), MS2020_STEPS, "12a", card)
    offset = train["quantization_offset"] = time_quantization_offset(model, "12a")
    log(f"  12a the root-find's share of a step: {100 * offset['ms'] / train['step_ms']:.1f}%")
    train["launches"] = count_step_launches(ms2020.MS2020Model(cfg, seed=1),
                                            ms2020.make_loss_fn, "12a")

    codec = ms2020.Codec(model, device=DEVICE)
    images = structured_images()
    # No CPU check of the reconstruction here: a latent at a rounding tie
    # may round the other way on the card and then steers every later
    # slice (tests/test_torch_cuda.py holds each slice's transforms to the
    # CPU on the same inputs instead).
    host_blobs, host_out, host_launches = phase_codec(
        codec, images, ms2020, label="12b ms2020 codec", min_psnr=None, cpu_check=False)
    launches = phase_codec_device(codec, images, host_blobs, host_out,
                                  label="12b ms2020 codec (device coder)")
    k1_err = check_k1_on_path(
        codec.model, lambda: codec.decompress_batch(codec.compress_batch(images, coder="device")),
        "12b ms2020")
    log("12c K3/K2 on ms2020's slice 0 (symbols and rows):")
    rans_k = phase_rans_kernels(codec, images, reps, main_path=False)
    rates = {coder: phase_throughput(codec, images, batches, card, coder,
                                     label="12d ms2020 throughput")
             for coder in ("host", "device")}
    chain = time_slice_chain(codec, images)
    for coder in ("host", "device"):
        profile_device(
            f"12f ms2020, {coder} coder, compress_batch + decompress_batch of {BATCH}",
            lambda: codec.decompress_batch(codec.compress_batch(images, coder=coder)), top=10)
    return dict(train=train, host_launches=host_launches, launches=launches,
                k1_max_abs_err=k1_err, rans=rans_k, throughput=rates, chain=chain)


# -- phase 13: HiFiC at full width -----------------------------------------------

HIFIC_STEPS = 100  # phase 13b: joint steps of hific.train from the seed


def hific_config():
    """Phase 13's model: hific-mi (registry.py:252): 220 latents, 320
    hyperlatents, 9 residual blocks."""
    from compression_tpu_torch.models import hific

    return hific.get_config("hific-mi")


def synthetic_lpips(seed: int = 0):
    """LPIPS on synthetic weights: a seeded NumPy draw in the torch layout
    that tools/convert_lpips.py reads (torchvision VGG16 ``features.N``, the
    heads ``lin{i}.model.1``), He-scaled so that the features stay of order
    one through the 13 convolutions, as a trained VGG16's do; then mapped
    onto the port's names as that tool maps them (``features.N`` of the
    13 convolutions in order -> ``vgg.conv{b}_{c}``, ``lin{i}.model.1``
    -> ``lin{i}``)."""
    from compression_tpu_torch.models.hific import lpips

    torch_conv_idx = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
    rng = np.random.RandomState(seed)
    vgg, cin = {}, 3
    for w, ti in zip([w for block in lpips._BLOCKS for w in block], torch_conv_idx):
        vgg[f"features.{ti}.weight"] = (rng.randn(w, cin, 3, 3)
                                        * np.sqrt(2.0 / (9 * cin))).astype(np.float32)
        vgg[f"features.{ti}.bias"] = (rng.randn(w) * 0.01).astype(np.float32)
        cin = w
    lins = {f"lin{i}.model.1.weight": (np.abs(rng.randn(1, block[-1], 1, 1)) / block[-1])
            .astype(np.float32) for i, block in enumerate(lpips._BLOCKS)}
    names = [f"vgg.conv{b}_{c}" for b, block in enumerate(lpips._BLOCKS)
             for c in range(len(block))]
    state = {f"{name}.{leaf}": torch.from_numpy(vgg[f"features.{ti}.{leaf}"])
             for name, ti in zip(names, torch_conv_idx) for leaf in ("weight", "bias")}
    state.update({f"lin{i}": torch.from_numpy(lins[f"lin{i}.model.1.weight"].reshape(-1))
                  for i in range(len(lpips._BLOCKS))})
    model = lpips.LPIPS()
    model.load_state_dict(state)
    return model.requires_grad_(False)


@contextlib.contextmanager
def pinned_noise(noise):
    """The entropy models' training noise taken from ``noise`` (CPU tensors
    in the order the model draws them: z's, y's, the interior's), each moved
    to its draw's device and dtype."""
    from compression_tpu_torch.entropy_models import continuous_batched, continuous_indexed

    queue = list(noise)

    def draw(t, generator):
        n = queue.pop(0)
        if tuple(n.shape) != tuple(t.shape):
            raise AssertionError(f"noise of shape {tuple(n.shape)} for {tuple(t.shape)}")
        return n.to(t.device, t.dtype)

    saved = continuous_batched.uniform_noise, continuous_indexed.uniform_noise
    continuous_batched.uniform_noise = continuous_indexed.uniform_noise = draw
    try:
        yield
    finally:
        continuous_batched.uniform_noise, continuous_indexed.uniform_noise = saved
    if queue:
        raise AssertionError(f"{len(queue)} noise draws unused")


# The ChannelNorms whose output goes through a ReLU.
RELU_NORMS = re.compile(r"(encoder\.norm\d+|generator\.res\d+\.norm0|generator\.upnorm\d+)")


def hific_step(cfg, lpips, x, noise, device, dtype) -> tuple:
    """One joint step (past any warm-up) of a seeded G and D in ``dtype`` on
    ``device`` with pinned noise: the metrics; the G and D gradients and
    D's spectral-norm buffers after the step; and the signs (> 0) of the
    ReLU inputs after each ChannelNorm of G's forward; all on the CPU."""
    import copy

    from compression_tpu_torch.models import hific

    model = hific.HificModel(cfg, seed=0).to(device, dtype)
    disc = hific.Discriminator(cfg.num_latents, seed=1).to(device, dtype)
    step, _, _ = hific.make_train_steps(model, disc, copy.deepcopy(lpips).to(device, dtype),
                                        cfg)
    signs = {}

    def record(name):
        def hook(module, args, out):
            signs.setdefault(name, (out > 0).cpu())
        return hook

    hooks = [m.register_forward_hook(record(name))
             for name, m in model.named_modules() if RELU_NORMS.fullmatch(name)]
    with pinned_noise(noise):
        metrics = step(x.to(device, dtype), None)
    for h in hooks:
        h.remove()
    return ({k: v.item() for k, v in metrics.items()},
            {**{f"G {n}": q.grad.cpu() for n, q in model.named_parameters()},
             **{f"D {n}": q.grad.cpu() for n, q in disc.named_parameters()},
             **{f"D {n}": b.cpu() for n, b in disc.named_buffers()}},
            signs)


def check_hific_step_against_cpu(cfg) -> dict:
    """13a: one joint step of 2 crops of TRAIN_PATCH from the same seeded G
    and D and the same noise: on the CPU in float64 (the reference), on the
    card in float64 and float32, and on the CPU in float32.

    float64, card against CPU (the same function on both devices): the
    losses within 1e-10 relative, every G and D gradient and spectral-norm
    buffer within 1e-8 of its largest entry.
    float32, as the card trains: the losses within 1e-4 relative of the
    CPU's and D's spectral-norm state within 1e-3 of its largest entry; the
    gradients, each measured against the float64 reference, no further from
    it on the card than 3x the CPU's distance, for the worst tensor and for
    the median one. The count of ReLU inputs whose sign differs from the
    float64 run is printed for each device: one flipped element at 16 x 16
    latents moves a residual block's conv0 gradient by ~1/512 of its sum,
    which is why the card is not held to the CPU float32 run itself."""
    x = torch.from_numpy(next(train_batches(2)))
    p, ring = TRAIN_PATCH, cfg.hinge_boundary_ring
    gen = torch.Generator().manual_seed(4)
    noise = [torch.rand(shape, generator=gen) - 0.5 for shape in (
        (2, p // 64, p // 64, cfg.num_hyperlatents), (2, p // 16, p // 16, cfg.num_latents),
        (2, p // 16 - 2 * ring, p // 16 - 2 * ring, cfg.num_latents))]
    lpips = synthetic_lpips()
    runs, seconds = {}, {}
    for device, dtype in (("cpu", torch.float64), (DEVICE, torch.float64),
                          (DEVICE, torch.float32), ("cpu", torch.float32)):
        t0 = time.perf_counter()
        runs[device, dtype] = hific_step(cfg, lpips, x, noise, device, dtype)
        seconds[device, dtype] = time.perf_counter() - t0
    m_ref, t_ref, s_ref = runs["cpu", torch.float64]

    def loss_errs(m, want):
        return {k: abs(m[k] - want[k]) / abs(want[k]) for k in ("g_loss", "d_loss")}

    def is_state(n):
        return n.endswith((".u", ".sigma"))

    def flips(signs):
        return sum(int((signs[n] != s_ref[n]).sum()) for n in s_ref)

    # float64: the card computes the CPU's function.
    m64, t64, _ = runs[DEVICE, torch.float64]
    errs64 = {n: rel_err(t64[n], want) for n, want in t_ref.items()}
    losses64 = loss_errs(m64, m_ref)
    worst64 = max(errs64, key=errs64.get)
    log(f"  13a float64, one joint step of 2 crops of {p}x{p}, card "
        f"({seconds[DEVICE, torch.float64]:.1f} s) against CPU "
        f"({seconds['cpu', torch.float64]:.1f} s): g_loss {m64['g_loss']:.6f} / "
        f"{m_ref['g_loss']:.6f}, d_loss {m64['d_loss']:.6f} / {m_ref['d_loss']:.6f}; "
        + ", ".join(f"{k} rel err {v:.2e}" for k, v in losses64.items())
        + f"; {len(errs64)} gradients and buffers: worst {errs64[worst64]:.2e} of its "
        f"largest entry ({worst64})")
    bad = {n: e for n, e in errs64.items() if e > 1e-8}
    if bad or max(losses64.values()) > 1e-10:
        raise AssertionError(f"13a float64: card off the CPU: losses {losses64}, tensors {bad}")

    # float32: the card's training precision, both devices against float64.
    (m_gpu, t_gpu, s_gpu), (m_cpu, t_cpu, s_cpu) = (runs[DEVICE, torch.float32],
                                                      runs["cpu", torch.float32])
    grads = [n for n in t_ref if not is_state(n)]
    card = {n: rel_err(t_gpu[n], t_ref[n]) for n in grads}
    cpu = {n: rel_err(t_cpu[n], t_ref[n]) for n in grads}
    state = {n: rel_err(t_gpu[n], t_cpu[n]) for n in t_ref if is_state(n)}
    losses = loss_errs(m_gpu, m_cpu)
    worst = {k: max(d, key=d.get) for k, d in (("card", card), ("cpu", cpu))}
    median = {k: float(np.median(list(d.values()))) for k, d in (("card", card), ("cpu", cpu))}
    over = [n for n in grads if card[n] > 3 * cpu[n]]
    n_signs = sum(v.numel() for v in s_ref.values())
    log(f"  13a float32, card ({seconds[DEVICE, torch.float32]:.1f} s) and CPU "
        f"({seconds['cpu', torch.float32]:.1f} s): g_loss {m_gpu['g_loss']:.6f} / "
        f"{m_cpu['g_loss']:.6f}, d_loss {m_gpu['d_loss']:.6f} / {m_cpu['d_loss']:.6f} "
        f"(bpp {m_gpu['bpp']:.5f}, mse {m_gpu['mse']:.4f}, lpips {m_gpu['lpips']:.6f}); "
        + ", ".join(f"{k} rel err {v:.2e}" for k, v in losses.items())
        + f"; {len(grads)} G and D gradients against float64: card worst "
        f"{card[worst['card']]:.2e} ({worst['card']}), median {median['card']:.2e}; CPU worst "
        f"{cpu[worst['cpu']]:.2e} ({worst['cpu']}), median {median['cpu']:.2e}; "
        f"{len(over)} tensors with the card over 3x the CPU; card against CPU worst "
        f"{max(rel_err(t_gpu[n], t_cpu[n]) for n in grads):.2e}; ReLU inputs whose sign "
        f"differs from float64's: card {flips(s_gpu)}, CPU {flips(s_cpu)} of {n_signs}; "
        f"spectral-norm state worst {max(state.values()):.2e}")
    bad = {n: e for n, e in state.items() if e > TRAIN_CPU_TOL}
    if (bad or max(losses.values()) > 1e-4 or card[worst["card"]] > 3 * cpu[worst["cpu"]]
            or median["card"] > 3 * median["cpu"]):
        raise AssertionError(f"13a float32: card's gradients further from float64 than 3x "
                             f"the CPU's, or losses {losses} or state {bad} off the CPU")
    return dict(float64_max_rel_err=errs64[worst64], float64_loss_rel_err=losses64,
                card_max_rel_err=card[worst["card"]], card_worst=worst["card"],
                card_median_rel_err=median["card"], cpu_max_rel_err=cpu[worst["cpu"]],
                cpu_worst=worst["cpu"], cpu_median_rel_err=median["cpu"],
                tensors_over_3x=over, loss_rel_err=losses, state_rel_err=max(state.values()),
                sign_flips={"card": flips(s_gpu), "cpu": flips(s_cpu), "of": n_signs})


def count_hific_step_launches(cfg) -> dict:
    """13b: the training path's run: one joint step of a batch of
    TRAIN_BATCH crops, the counts set to 0 just before and read just after;
    then a profile of 3 steps by kind."""
    from compression_tpu_torch.codec import rans
    from compression_tpu_torch.layers.gdn_kernel import fused_gdn
    from compression_tpu_torch.models import hific

    model = hific.HificModel(cfg, seed=1).to(DEVICE)
    disc = hific.Discriminator(cfg.num_latents, seed=2).to(DEVICE)
    step, _, _ = hific.make_train_steps(model, disc, synthetic_lpips().to(DEVICE), cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    x = torch.from_numpy(next(train_batches(TRAIN_BATCH))).to(DEVICE)
    step(x, gen)  # warm-up
    sync()
    fused_gdn.launches = rans.rans_encode.launches = rans.rans_decode.launches = 0
    metrics = step(x, gen)
    sync()
    launches = {"gdn": fused_gdn.launches, "rans_encode": rans.rans_encode.launches,
                "rans_decode": rans.rans_decode.launches}
    log(f"  13b one joint step of {TRAIN_BATCH}x{TRAIN_PATCH}x{TRAIN_PATCH}: launches "
        f"{launches} (g_loss {metrics['g_loss'].item():.4f})")
    if launches != {"gdn": 0, "rans_encode": 0, "rans_decode": 0}:
        raise AssertionError(f"13b: expected K1 0, K3 0, K2 0 launches, saw {launches}")
    prof = profile_device(f"13b 3 joint steps of {TRAIN_BATCH}x{TRAIN_PATCH}x{TRAIN_PATCH}",
                          lambda: [step(x, gen) for _ in range(3)], steps=3, top=8)
    return launches, prof


def train_hific(cfg, card: str):
    """13b: HIFIC_STEPS joint steps of hific.train from the seed on fresh
    synthetic crops: every metric finite, the mean MSE of the last 10 steps
    below the first 10's; ms a step and img/s over steps 21 on (the hook
    reads every metric: one sync a step). Returns (model, numbers)."""
    from compression_tpu_torch.models import common, hific

    seen, marks = {}, {}

    def hook(step, m):
        seen[step] = m
        marks[step] = time.perf_counter()

    tcfg = common.TrainConfig(batch_size=TRAIN_BATCH, patch_size=TRAIN_PATCH,
                              steps=HIFIC_STEPS, log_every=1, seed=0)
    with contextlib.redirect_stdout(io.StringIO()):  # its line a step
        model, _ = hific.train(cfg, tcfg, hooks=hook, device=DEVICE)
    steps = sorted(seen)
    mse = np.array([seen[k]["mse"] for k in steps])
    first, last = float(mse[:10].mean()), float(mse[-10:].mean())
    step_ms = 1e3 * (marks[HIFIC_STEPS] - marks[20]) / (HIFIC_STEPS - 20)
    numbers = dict(mse_first=first, mse_last=last, step_ms=step_ms,
                   steps_per_s=1e3 / step_ms, img_per_s=TRAIN_BATCH * 1e3 / step_ms,
                   at={k: {n: seen[k][n] for n in ("bpp", "lam", "hinge_on", "mse", "lpips",
                                                  "g_loss", "d_loss")}
                       for k in (1, 10, HIFIC_STEPS)})
    log(f"  13b hific.train, {HIFIC_STEPS} joint steps from the seed on fresh {TRAIN_BATCH}x"
        f"{TRAIN_PATCH}x{TRAIN_PATCH} synthetic crops ({card}): mse mean of the first 10 "
        f"{first:.3f}, of the last 10 {last:.3f}; " + "; ".join(
            f"step {k}: bpp {v['bpp']:.4f} lam {v['lam']:.4f} hinge_on {v['hinge_on']:.0f} "
            f"lpips {v['lpips']:.5f} g_loss {v['g_loss']:.4f} d_loss {v['d_loss']:.4f}"
            for k, v in numbers["at"].items())
        + f"; {step_ms:.2f} ms a step, {numbers['img_per_s']:.2f} img/s over steps "
        f"21-{HIFIC_STEPS}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    finite = all(np.isfinite(list(seen[k].values())).all() for k in steps)
    if steps != list(range(1, HIFIC_STEPS + 1)) or not finite or not last < first:
        raise AssertionError("13b: missing or non-finite metrics, or the MSE did not fall")
    return model, numbers


def phase_hific(card: str, reps: int, batches: int) -> dict:
    """Phase 13: HiFiC hific-mi at full width: one joint step against the
    CPU, training from the seed and a step's launches, the codec of the
    trained model with both coders, K3 and K2 on its symbols and rows,
    throughput and a profile by kind."""
    from compression_tpu_torch.models import hific
    from compression_tpu_torch.util.image import pad_to_multiple_np

    log(f"HiFiC hific-mi at full width (phase 13; {card}):")
    cfg = hific_config()
    step_check = check_hific_step_against_cpu(cfg)
    train_launches, train_profile = count_hific_step_launches(cfg)
    model, train = train_hific(cfg, card)
    train.update(cpu=step_check, launches=train_launches, profile=train_profile)

    codec = hific.Codec(model, device=DEVICE)
    images = structured_images()
    host_blobs, host_out, host_launches = phase_codec(
        codec, images, hific, label="13c hific codec", min_psnr=None, gdn=0)
    launches = phase_codec_device(codec, images, host_blobs, host_out,
                                  label="13c hific codec (device coder)", gdn=0)
    x = torch.from_numpy(pad_to_multiple_np(images, 64)[0]).to(DEVICE).float() / 255.0
    with torch.no_grad():
        coded = float(codec.model.coded_bpp(x))
    host_bpp = 8.0 * sum(len(b) for b in host_blobs) / (BATCH * HEIGHT * WIDTH)
    log(f"  13c coded_bpp of the {BATCH} images {coded:.4f} against the host coder's "
        f"{host_bpp:.4f} bpp (blob framing included; not held: the model is barely trained)")
    log("13d K3/K2 on HiFiC's symbols and rows:")
    rans_k = phase_rans_kernels(codec, images, reps, main_path=False)
    rates = {coder: phase_throughput(codec, images, batches, card, coder,
                                     label="13e hific throughput")
             for coder in ("host", "device")}
    profiles = {coder: profile_device(
        f"13f hific, {coder} coder, compress_batch + decompress_batch of {BATCH}",
        lambda: codec.decompress_batch(codec.compress_batch(images, coder=coder)), top=8)
        for coder in ("host", "device")}
    return dict(train=train, host_launches=host_launches, launches=launches, rans=rans_k,
                throughput=rates, profile=profiles, coded_bpp=coded, host_bpp=host_bpp)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batches", type=int, default=8)
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
    images = np.stack([structured_image(HEIGHT, WIDTH)] * BATCH)
    codec = bmshj2018.Codec(model, device="cuda")
    rans_k = phase_rans_kernels(codec, images, args.reps)
    host_blobs, host_out, host_launches = phase_codec(codec, images, bmshj2018)
    launches = phase_codec_device(codec, images, host_blobs, host_out)
    for coder in ("host", "device"):
        phase_throughput(codec, images, args.batches, card, coder)
    for coder in ("host", "device"):
        prof = profile_device(
            f"{coder} coder, compress_batch + decompress_batch of {BATCH}",
            lambda: codec.decompress_batch(codec.compress_batch(images, coder=coder)),
            top=10)
        if coder == "device" and prof:
            # K3 is its fields and lanes kernels (its output's zero fill is
            # a PyTorch fill kernel, not told apart here).
            log("  inside the codec: " + ", ".join(
                f"{kind} {prof['by_kind_ms'][kind]:.4f} ms (standalone "
                f"{rans_k[name]['ms']:.4f} ms)"
                for kind, name in (("K3", "rans_encode"), ("K2", "rans_decode"))))
        batch_list = [images] * args.batches
        profile_device(f"{coder} coder, compress_iter then decompress_iter, "
                       f"{args.batches} batches",
                       lambda: list(codec.decompress_iter(
                           list(codec.compress_iter(batch_list, coder=coder)))))
    del codec
    training = phase_training(model, card, args.reps)
    factorized = phase_factorized(card)
    mbt = phase_mbt2018(card, args.reps, args.batches)
    b2018s = phase_b2018(card)
    ms = phase_ms2020(card, args.reps, args.batches)
    hi = phase_hific(card, args.reps, args.batches)

    # Each kernel's launches on every path, each path counted on its own.
    paths = {
        "bmshj2018 codec, host coder": host_launches,
        "bmshj2018 codec, device coder": launches,
        "bmshj2018 train step": training["launches"],
        **{f"{name} codec (one image)": r["launches"] for name, r in factorized.items()},
        "mbt2018 codec, host coder": mbt["host_launches"],
        "mbt2018 codec, device coder": mbt["launches"],
        "mbt2018 train step": mbt["train"]["launches"],
        **{f"{name} codec (one image)": r["launches"] for name, r in b2018s.items()},
        **{f"{name} train step": r["train"]["launches"] for name, r in b2018s.items()},
        "ms2020 codec, host coder": ms["host_launches"],
        "ms2020 codec, device coder": ms["launches"],
        "ms2020 train step": ms["train"]["launches"],
        "hific codec, host coder": hi["host_launches"],
        "hific codec, device coder": hi["launches"],
        "hific train step": hi["train"]["launches"],
    }

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
        "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"],
        "train_launches": training["launches"]["gdn"],
        "paths": {path: counts.get("gdn", 0) for path, counts in paths.items()},
    }]
    for name, replaces in (("rans_encode", "compression_tpu/codec/rans.py:178"),
                           ("rans_decode", "compression_tpu/codec/rans.py:257")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "compression_tpu_torch/csrc/rans.cu",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": rans_k[name]["max_abs_err"],
            "ms": rans_k[name]["ms"],
            "plain_ms": rans_k[name]["plain_ms"],
            "bound_ms": rans_k[name]["bound_ms"],
            "bound_by": rans_k[name]["bound_by"],
            "library_ms": None,  # no single PyTorch call computes rANS
            "train_launches": training["launches"][name],
            "paths": {path: counts.get(name, 0) for path, counts in paths.items()},
            **{family: {k: r["rans"][name][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "floor_ms", "steps")}
               for family, r in (("mbt2018", mbt), ("ms2020", ms), ("hific", hi))},
        })
    train_line = {
        "batch": TRAIN_BATCH, "patch": TRAIN_PATCH,
        **{k: training.get(k) for k in ("step_ms", "steps_per_s", "img_per_s", "busy_ms",
                                        "wall_ms", "idle", "by_kind_ms", "device_activities",
                                        "host_data_ms", "host_dispatch_ms", "cpu_max_rel_err")},
        "gdn_backward": training["gdn_backward"],
    }
    families = {
        **{name: {k: r[k] for k in r if k != "launches"} for name, r in factorized.items()},
        "mbt2018-mean": {"train": {k: v for k, v in mbt["train"].items() if k != "launches"},
                         "throughput": mbt["throughput"],
                         "k1_max_abs_err": mbt["k1_max_abs_err"]},
        **{name: {k: ({kk: vv for kk, vv in v.items() if kk != "launches"} if k == "train"
                      else v) for k, v in r.items() if k != "launches"}
           for name, r in b2018s.items()},
        "ms2020-cc10": {"train": {k: v for k, v in ms["train"].items() if k != "launches"},
                        "throughput": ms["throughput"], "chain": ms["chain"],
                        "k1_max_abs_err": ms["k1_max_abs_err"]},
        "hific-mi": {"train": {k: v for k, v in hi["train"].items() if k != "launches"},
                     **{k: hi[k] for k in ("throughput", "profile", "coded_bpp", "host_bpp")}},
    }
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels, "training": train_line, "families": families}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
