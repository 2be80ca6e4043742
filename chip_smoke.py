"""On-card smoke run of the PyTorch/CUDA port: bmshj2018 at full width, with
the host coder and with the device (rANS) coder, its training, the other
families at full width (bls2017, bmshj2018-factorized, mbt2018-mean, b2018,
ms2020-cc10, HiFiC), the tfci CLI, the rest of the library, the
single-program decode, GDN at any width and dtype, and the multi-device
layer on shards of the one card.

    python3 chip_smoke.py [--batches N] [--reps N]

Needs one NVIDIA GPU (sm_90a: H100/H200), nvcc and g++; run from the root
of a checkout. Phases, each fatal on failure:

1. environment: card name and power limit, torch/CUDA versions; float32
   math pinned (no TF32, deterministic cuDNN);
2. build: the CUDA kernels gdn.cu (K1 and the general GDN kernel) and
   rans.cu (nvcc, one process each) and the range coder (g++), all in
   parallel; each kernel's registers and spills (ptxas), and the built
   gdn.cu's SASS (cuobjdump): K1's instantiations must hold HGMMA, the
   general kernel's HMMA (float32, float16, bfloat16) or DMMA (float64);
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
    forward ops, K3, K2, copies, other) and the idle share; g. the fused
    ChannelNorm kernel (``csrc/channel_norm.cu``) at every call of an
    encoded and a decoded batch (5 and 24 calls, with their bias, ReLU or
    residual add) against its twin, timed beside its bytes bound (x, the
    residual and out once each over 3.35 TB/s), the twin and
    ``F.layer_norm`` with the same bias, ReLU and add (the yardstick only);
    h. the 3x3 convolution kernel (``csrc/conv3x3.cu``) at the generator's
    conv_in and residual calls of a decoded batch (1 and 18), its largest
    error against float64 within 2x of its twin's (cuDNN in float32), timed
    beside its 3xTF32 bound (495 TFLOP/s), the float32 CUDA-core bound (67
    TFLOP/s), the twin and ``F.conv2d`` on NCHW tensors (the yardstick
    only); its launches (0 a compressed and 19 a decoded HiFiC batch) held
    on every path of the run, none off HiFiC's; i. the stride-2 3x3
    up-convolution kernel (``csrc/conv_up3x3.cu``) at the generator's
    up0-up3 calls of a decoded batch, its largest error against float64 no
    larger than cuDNN float32's through ``signal_conv`` (its phase
    convolution and depth-to-space copy, which these calls ran before),
    timed beside its 3xTF32 and float32 bounds, the twin, that
    ``signal_conv`` call and ``F.conv_transpose2d`` on NCHW tensors (the
    yardstick only); its launches (0 a compressed and 4 a decoded HiFiC
    batch) held on every path of the run, on those where the 3x3 kernel
    launches and no others;
14. the tfci CLI (``compression_tpu_torch.cli.tfci``) in a model directory
    of its own that holds ckpt/bmshj2018.msgpack as
    bmshj2018-hyperprior.msgpack, on a structured 768x512 PNG written by the
    port's PNG codec: ``models``; ``compress`` with the host coder (it
    builds and writes the table file ``<ckpt>.<mtime_ns>.<size>.tables.npz``);
    ``compress --device-coder`` in a second process (``python -X importtime
    -m``), which loads that file and leaves it as it was, and again here,
    to the same bytes; ``decompress`` of both files here and in two more
    processes (one reports its start-up to the first device call), all
    equal, the two coders' decodes equal; the host-coded file byte-identical
    to ``bmshj2018.Codec.compress`` on the same tables (the device-coded one
    too), PSNR above 25 dB; the card's file decoded on the CPU (equal share
    printed, not held); the CLI's img/s against the Codec API's on the same
    image; ``dump --output``; ``eval`` over 3 images (the MS-SSIM column);
    ``train bmshj2018`` 20 steps of 8x256x256, then on to 30, resuming at
    step 20, the loss falling over the 30 steps, and its checkpoint through
    ``compress``/``decompress``; launches per verb (the counts set to 0
    before each and read after: K1 3 a compress and 3 a decompress, K3 2
    with the device coder, K2 1 on the device-coded decode; K1 6 a training
    step and an evaluated image), and the same counts in ``profile_device``'s
    trace; every registry family through the CLI: at TPC_TINY_MODELS=1,
    bls2017, bmshj2018-factorized, mbt2018, ms2020 and b2018-gdn-128
    (``--rd_parameter 2``) trained 3 steps, then compressed and
    decompressed with each coder the family has, and hific-lo at full width
    with ``--allow-random``, both coders; no verb, here or in the other
    processes, imports PIL;
15. the rest of the library at the full width of ckpt/bmshj2018.msgpack on
    the 8 structured 768x512 images, each step's ms printed beside the card:
    a. y (8x48x32x192) from the analysis (K1 3, counted over exactly that
       call) coded by a UniversalIndexedEntropyModel (NoisyNormal, 64 scales
       x 15 noise levels = 960 rows) with the scale indexes of the
       hyper-synthesis; its training call with expected gradients on the
       card against the CPU on the same noise (bits 1e-5, the y-gradient
       1e-4 of its largest entry); compress and decompress: |y_hat - y| <=
       1/2, the eval path within 1e-5 of the codec's grid, strings
       byte-identical to the CPU port's;
    b. z (8x12x8x128) through a UniversalBatchedEntropyModel over the
       checkpoint's hyperprior: a round trip within 1/2, dither offsets that
       differ across channels, strings byte-identical to the CPU port's (its
       decoded z feeds 15a's hyper-synthesis);
    c. the power-law model on y: decompress gives exactly round(y), the
       penalty within 1e-5 of the CPU's (float32 sums), strings equal;
    d. ContinuousBatchedEntropyModel at 192 channels over a
       NoisySoftRoundedDeepFactorized, a 3-component NoisyLogisticMixture and
       the same mixture without analytic tails (the log-CDF root-find): the
       priors on the card, tables equal to the CPU port's, offset and tails
       found on the card within 1e-5 of the CPU's, the rate of round(y) on
       two images within 1e-5, the training call and its backward finite;
    e. five SignalConv variants at 192 channels forward and backward in
       strict fp32 against the CPU (1e-5 of each tensor's largest entry): a
       5x5 stride-2 same_reflect down-conv, a channel-separable 5x5 up-conv
       (zero-stuffed, the JAX package's lhs_dilation route), an RDFT 5x5
       conv, SignalConv1D and SignalConv3D;
    f. the plain torch CDF quantizer in float64 on the card over 15a's 960
       PMF rows against the C++ quantizer row for row (a differing row is
       printed and must be explained by a float64 tie within 4 ulps), exact
       on the CPU; its time beside the C++ one;
    g. the toy sources at their defaults: rd_point_ntc (banana, 3000 steps,
       65,536 samples in one stream) and rd_point_ecvq (256 codewords, 200
       steps): rate, distortion and wall time;
16. the single-program decode and GDN at any width and dtype:
    a. ``decompress_batch_jit`` of the checkpoint's host-coded blobs of the
       8 structured 768x512 images byte-equal to ``decompress_batch``, cold
       (the program built, its two CUDA graphs captured) and warm (a cache
       hit); blob 0 alone equal to row 0; a 512x768 image a new key, equal;
       the device-coded blobs routed to K2 (1 launch), equal; a warm call's
       launches, replays counted (K1 3, the general kernel 0); the memory
       the cold call keeps (the two graphs' private pools); warm ms
       (median of ``--reps``) against ``decompress_batch``, and one
       ``profile_device`` pass of each (device busy and idle, no claim),
       in which the K1 kernels the card's trace shows must equal the
       counted launches of that same call;
    b. the general GDN kernel (``fused_gdn_general``, on the tensor
       cores) against its twin at the rows of the first GDN layer (8 x 384
       x 256): float32 at C = 224, 256 and 320 within K1's 2e-5, float64 at
       C = 256 within 1e-12, bfloat16 and float16 at C = 192 within two
       ulps, both directions, each timed beside its twin and its yardstick
       (``torch.addmm`` plus the elementwise ops in the row's dtype) against
       its byte bound and its tensor-core bound, units printed (3xTF32 for
       float32, the FP64 tensor cores for float64, 1xTF32 for the 16-bit
       types); and at the six calls of 16c's round trip;
    c. a seeded bmshj2018 at 320 filters: a quantized step of 2 crops on
       the card against the CPU (8b's tolerances), the launches of a
       training step (the general kernel 6, K1 0), the codec's round trip
       of the 8 images (general 6, K1 0; byte-identical re-compression,
       batch-1 decode equal to the batch-8 decode), and its jit decode
       (general 3 a warm call, held against the card's trace).

17. the multi-device layer on meshes of 1 and 4 shards of the one card
    (``parallel.data_parallel.Mesh`` with the card repeated):
    a. data-parallel training of bmshj2018 from the checkpoint at
       TrainConfig's 8 crops of 256x256: the 4-shard quantized step's loss,
       gradients and updated params within rtol 1e-5, atol 1e-6 of the mean of the
       per-shard gradients built from the one-device pieces, the mesh of one
       within rtol 1e-6 of ``train_step``; ms a step with noise, K1 6 a
       shard, device busy and idle (``profile_device``); then hific-mi's
       joint DP step at 8x256x256 (synthetic LPIPS), finite losses and D's
       spectral-norm state equal (1e-6) to the one-device step's, ms a step;
    c. bmshj2018's SpatialCodec from the checkpoint on one 3072x2048
       structured image at 1 and 4 shards: PSNR above 25 dB, a second decode
       equal to the first, K1 3 a shard a pass, the sharded y, z, sigma and
       x_hat within 1e-4 of the largest entry of the dense model's, compress
       and decompress ms, blobs byte-equal across 1 shard, 4 shards and the
       dense codec (printed, not held); bls2017, mbt2018-mean, ms2020-cc10
       and hific-mi from the seed on one 768x512 image at 4 shards: the
       round trip decodes, y within 1e-4 of the dense, its ms on a first
       call and on the next;
    d. ShardedCharmCodec over 1 and 4 shards, ms2020-cc10 from the seed on
       the 8 structured images, host- and device-coded: byte-equal to
       ``Codec.decompress_batch`` (K2 10 a shard on device-coded blobs), and
       a ragged batch of 7;
    and ``tfci compress/decompress --spatial 1`` on the checkpoint (K1 3
    each, PSNR above 25 dB); ``--spatial 2`` exits naming the device count.

Then one JSON line with every kernel's numbers (and its launches on every
path; the general kernel's must be 0 on every registry path), the training
numbers, the families' numbers, the library's (phase 15) and the jit
decode's (phase 16), the multi-device layer's (phase 17), the card line,
and the last line ``{"ok": true,
"device": {...}}``.
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

    with cf.ThreadPoolExecutor(4) as pool:
        nvcc = {src: pool.submit(timed, cuda_build.build, src)
                for src in ("gdn.cu", "rans.cu", "channel_norm.cu", "conv3x3.cu",
                            "conv_up3x3.cu")}
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
    for line in check_tensor_core_sass(cuda_build.sass("gdn.cu")):
        log(f"  sass gdn.cu {line}")
    for src in ("conv3x3.cu", "conv_up3x3.cu"):
        hgmma = len(re.findall(r"\bHGMMA\b", cuda_build.sass(src)))
        if not hgmma:
            raise AssertionError(f"sass: {src}'s kernels have no HGMMA")
        # C7514/C7512: ptxas serialized the wgmma products. A library an
        # earlier process built leaves no log in this one.
        serialized = (re.findall(r"C751[24]", cuda_build.build_logs[src])
                      if src in cuda_build.build_logs else "not read (built by an earlier process)")
        log(f"  sass {src}: {hgmma} HGMMA; ptxas serialization warnings {serialized or 'none'}")


# The tensor-core instruction each GDN kernel must compile to, by the
# template argument that opens its mangled name: K1 (gdn_kernel<C, inverse>)
# wgmma, HGMMA; the general kernel's TMA route (gdn_general_tma_kernel<NS,
# inverse>, float32) wgmma, HGMMA; its other route (gdn_general_kernel<T,
# V, inverse>, V the elements a load: 16 bytes' worth or 1) mma.sync, HMMA
# for float, __half and __nv_bfloat16 (TF32 products), DMMA for double.
GDN_SASS = {"gdn_kernelILi": ("K1", "HGMMA"),
            "gdn_general_kernelIf": ("general float32", "HMMA"),
            "gdn_general_kernelI6__half": ("general float16", "HMMA"),
            "gdn_general_kernelI13__nv_bfloat16": ("general bfloat16", "HMMA"),
            "gdn_general_kernelId": ("general float64", "DMMA"),
            "gdn_general_tma_kernelILi": ("general float32, TMA", "HGMMA")}


# Instantiations of each: K1 six widths, the TMA route three slice widths,
# both directions; the rest 4 (two load widths, both directions).
GDN_INSTANTIATIONS = {"K1": 12, "general float32, TMA": 6}


def check_tensor_core_sass(sass: str) -> list:
    """Each GDN kernel instantiation in ``sass`` (``cuobjdump -sass`` of the
    built gdn.cu) runs its products on the tensor cores: it must contain the
    instruction of :data:`GDN_SASS`, and every entry there must have both
    directions built (and for the general kernel both load widths).
    Returns one line a kernel kind: instantiations and tensor-core
    instructions counted."""
    found = {}
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        name, _, body = block.partition("\n")
        for prefix, (kind, op) in GDN_SASS.items():
            if prefix in name:
                count = len(re.findall(rf"\b{op}\b", body))
                if not count:
                    raise AssertionError(f"sass: {name} ({kind}) has no {op}")
                found.setdefault(kind, []).append(count)
    missing = [kind for kind, _ in GDN_SASS.values()
               if len(found.get(kind, ())) != GDN_INSTANTIATIONS.get(kind, 4)]
    if missing:
        raise AssertionError(f"sass: instantiations missing for {missing}: {found}")
    return [f"{kind}: {len(found[kind])} kernels, {op} {found[kind]}"
            for kind, op in GDN_SASS.values()]


def ptxas_summary(build_log: str) -> list:
    """One line a kernel from nvcc's ``-Xptxas -v`` report: the kernel (name
    and template arguments, from its mangled name), registers, spills."""
    lines, name, spills = [], None, ""
    for line in build_log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            mangled = entry.group(1)
            base = re.search(r"\d([a-z][a-z_]*_kernel)[IE]", mangled)
            args = re.findall(r"_kernelI(f|d|6__half|13__nv_bfloat16)", mangled)
            args += re.findall(r"L[ib](\d+)E", mangled)
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


def check_small_against_cpu(module, model, hw=(128, 192), **compress_kw) -> dict:
    """A small input through the card's codec and the CPU codec of the
    family ``module`` (same weights, same tables; ``compress_kw`` for a
    one-image codec's compress, b2018's quality): latents agree to 1e-4,
    reconstructions to one level. Returns the launches of the card's round
    trip (the general GDN kernel's must be 0)."""

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
    reset_launches()
    out_gpu = round_trip(gpu)
    launches = read_launches()
    if launches["gdn_general"]:
        raise AssertionError(f"the general GDN kernel ran {launches['gdn_general']} times")
    out_cpu = round_trip(cpu)
    diff = np.abs(out_gpu.astype(np.int16) - out_cpu.astype(np.int16))
    log(f"  {hw[0]}x{hw[1]} input vs CPU path ({type(model).__name__}): max |diff| "
        f"{diff.max()} levels, "
        f"{100 * np.mean(diff == 0):.3f}% equal; launches {launches}")
    if diff.max() > 1 or np.mean(diff == 0) < 0.99:
        raise AssertionError("card and CPU reconstructions disagree")
    return launches


def num_streams(codec) -> int:
    """y streams a blob: one a slice for ms2020, else one."""
    return getattr(codec.cfg, "num_slices", 1)


def phase_codec(codec, images, module, label: str = "codec", min_psnr=25.0,
                cpu_check: bool = True, gdn: int = 6, gdn_general: int = 0,
                norm: tuple = (0, 0), conv: tuple = (0, 0), up: tuple = (0, 0)) -> tuple:
    """A hyperprior codec's host-coded path: launches over exactly
    compress_batch + decompress_batch (``gdn`` for K1, ``gdn_general`` for
    the general GDN kernel; ``norm`` for the fused ChannelNorm's, ``conv``
    for the 3x3 convolution kernel's and ``up`` for the up-convolution
    kernel's in the compress and in the decompress), byte-identical
    re-compression, batch-1 decode equal to the batch-8 decode, PSNR and
    bpp (PSNR held to ``min_psnr`` where the weights are trained ones), and
    with ``cpu_check`` a small input against the CPU path of ``module``.
    Returns (blobs, reconstruction, launches)."""
    from compression_tpu_torch.models.device_coding import num_fields

    from compression_tpu_torch.layers.channel_norm_kernel import fused_channel_norm
    from compression_tpu_torch.util.image import psnr_np

    codec.compress_batch(images[:1])  # warm-up: cuDNN handles, kernel load

    # The path's run: the counts cover exactly compress + decompress.
    reset_launches()
    t0 = time.perf_counter()
    blobs = codec.compress_batch(images)
    t1 = time.perf_counter()
    compressing = read_launches()
    out = codec.decompress_batch(blobs)
    t2 = time.perf_counter()
    launches = read_launches()
    log(f"{label}: batch {BATCH} {HEIGHT}x{WIDTH}: compress {1e3 * (t1 - t0):.1f} ms, "
        f"decompress {1e3 * (t2 - t1):.1f} ms; launches {launches} ({compressing} compressing)")
    if (launches != launches_of(gdn=gdn, general=gdn_general, norm=sum(norm), conv=sum(conv),
                                up=sum(up))
            or [compressing[k] for k in HIFIC_KERNELS] != [norm[0], conv[0], up[0]]):
        raise AssertionError(f"expected {gdn} K1, {gdn_general} general GDN, {norm} "
                             f"ChannelNorm, {conv} 3x3 convolution and {up} up-convolution "
                             f"launches, saw {launches} ({compressing} compressing)")
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
                       label: str = "codec (device coder)", gdn: int = 6,
                       norm: tuple = (0, 0), conv: tuple = (0, 0), up: tuple = (0, 0)) -> dict:
    """A device-coded path: launches over exactly compress_batch +
    decompress_batch (K3 2 and K2 1 a y stream, K1 ``gdn``; the fused
    ChannelNorm ``norm``, the 3x3 convolution kernel ``conv`` and the
    up-convolution kernel ``up`` in the compress and in the decompress), and
    its outputs
    against the host coder's; each y stream within 1.1x the host coder's
    string for it plus the lane states. The general GDN kernel must not run."""
    from compression_tpu_torch.codec import rans
    from compression_tpu_torch.util import PackedTensors
    from compression_tpu_torch.util.image import psnr_np

    codec.decompress_batch(codec.compress_batch(images[:1], coder="device"))  # warm-up
    reset_launches()
    rans.rans_decode.variant_launches.update({"on_chip": 0, "global": 0})
    t0 = time.perf_counter()
    blobs = codec.compress_batch(images, coder="device")
    t1 = time.perf_counter()
    compressing = read_launches()
    out = codec.decompress_batch(blobs)
    t2 = time.perf_counter()
    launches = read_launches()
    log(f"{label}: batch {BATCH} {HEIGHT}x{WIDTH}: compress "
        f"{1e3 * (t1 - t0):.1f} ms, decompress {1e3 * (t2 - t1):.1f} ms; launches {launches} "
        f"({compressing} compressing)")
    S = num_streams(codec)
    if (launches != launches_of(gdn=gdn, enc=2 * S, dec=S, norm=sum(norm), conv=sum(conv),
                                up=sum(up))
            or [compressing[k] for k in HIFIC_KERNELS] != [norm[0], conv[0], up[0]]):
        raise AssertionError(f"expected K3 {2 * S} (fields, lanes a stream), K2 {S}, "
                             f"K1 {gdn}, ChannelNorm {norm}, 3x3 convolution {conv}, "
                             f"up-convolution {up} launches, saw {launches} ({compressing} "
                             "compressing)")
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
    """The kind of a device activity, from its name (K1, the general GDN
    kernel, K3, K2, copies) or
    from the CPU ops it was launched under, innermost first (ChannelNorm's
    forward, traced by a ``record_function``; Adam; K1's backward;
    convolutions backward and forward)."""
    low, chain = kernel.lower(), " ".join(ops)
    for kind, parts in (("gdn_general", ("gdn_general_kernel", "gdn_general_tma_kernel")),
                        ("K1", ("gdn_kernel",)),
                        ("K3", ("rans_fields", "rans_encode")),
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
    wall_ms, busy_ms, activity_ms, idle, device_activities, by_kind_ms,
    count_by_kind (device activities of each kind) and conv_forward_tflop."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from compression_tpu_torch.models.hific import archs

    forward = archs.ChannelNorm.forward

    def traced(self, *args, **kwargs):
        with record_function("hific.ChannelNorm"):
            return forward(self, *args, **kwargs)

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
                           "gdn_general", "gdn_backward", "adam", "K3", "K2", "copies",
                           "other"), 0.0)
    per_kernel, overlap, end, end_stream, same_stream = {}, {}, float("-inf"), None, 0.0
    counts = dict.fromkeys(kinds, 0)
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
        kind = kind_of(name, chain)
        kinds[kind] += own
        counts[kind] += 1
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
                device_activities=len(device), by_kind_ms=kinds, count_by_kind=counts,
                conv_forward_tflop=tflop)


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
                        tcfg=None, gdn_general: int = 0) -> dict:
    """A training main path's run: one train_step of a batch of 8 of
    ``model`` (Adam as ``tcfg`` sets it), the counts set to 0 just before
    and read just after; ``gdn`` K1 and ``gdn_general`` general GDN
    launches expected."""
    from compression_tpu_torch.models import common

    tcfg = tcfg or common.TrainConfig()
    model = model.to(DEVICE)
    optimizer = common.make_optimizer(model, tcfg)
    loss_fn = make_loss_fn(model)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    x = torch.from_numpy(next(train_batches(TRAIN_BATCH))).to(DEVICE)
    common.train_step(model, optimizer, loss_fn, x, gen, common.lr_schedule(tcfg))  # warm-up
    sync()
    reset_launches()
    loss, _ = common.train_step(model, optimizer, loss_fn, x, gen, common.lr_schedule(tcfg))
    sync()
    launches = read_launches()
    log(f"  {label} one training step of {TRAIN_BATCH}x{TRAIN_PATCH}x{TRAIN_PATCH}: launches "
        f"{launches} (loss {loss.item():.4f})")
    if launches != launches_of(gdn=gdn, general=gdn_general):
        raise AssertionError(f"{label}: expected K1 {gdn}, K3 0, K2 0, general GDN "
                             f"{gdn_general} launches, saw {launches}")
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
        reset_launches()
        blob = codec.compress(images[0])
        first = codec.decompress(blob)
        launches = read_launches()
        want = 4 if cfg.arch == "bls2017" else 6
        if launches != launches_of(gdn=want):
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
    if tiny_launches != launches_of(gdn=4):
        raise AssertionError(f"9 8 filters: expected 4 K1 launches, saw {tiny_launches}")
    codec = bls2017.Codec(tiny, device=DEVICE)
    image = structured_image(HEIGHT, WIDTH)[:96, :130]
    results["bls2017 8 filters"] = dict(
        launches=tiny_launches,
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
        reset_launches()
        blob = codec.compress(images[0], quality=cfg.num_qualities)
        first = codec.decompress(blob)
        launches = read_launches()
        if launches != launches_of(gdn=gdn):
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
        if small != launches_of(gdn=gdn):
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
    from compression_tpu_torch.models import hific

    model = hific.HificModel(cfg, seed=1).to(DEVICE)
    disc = hific.Discriminator(cfg.num_latents, seed=2).to(DEVICE)
    step, _, _ = hific.make_train_steps(model, disc, synthetic_lpips().to(DEVICE), cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    x = torch.from_numpy(next(train_batches(TRAIN_BATCH))).to(DEVICE)
    step(x, gen)  # warm-up
    sync()
    reset_launches()
    metrics = step(x, gen)
    sync()
    launches = read_launches()
    log(f"  13b one joint step of {TRAIN_BATCH}x{TRAIN_PATCH}x{TRAIN_PATCH}: launches "
        f"{launches} (g_loss {metrics['g_loss'].item():.4f})")
    norm = sum(hific_norm_launches(cfg))  # one forward of the encoder and the generator
    if launches != launches_of(norm=norm):
        raise AssertionError(f"13b: expected K1 0, K3 0, K2 0, general GDN 0, ChannelNorm "
                             f"{norm}, 3x3 convolution 0, up-convolution 0 launches, saw "
                             f"{launches}")
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


def channel_norm_calls(cfg) -> dict:
    """13g: the ChannelNorm calls of an encoded and a decoded batch of BATCH
    HEIGHTxWIDTH images, as ``(label, (N, H, W, C), (bias, relu, residual),
    calls a batch)``: the encoder's five (bias and ReLU); the generator's
    ``norm_in`` (plain), ``norm_head`` (bias), each residual block's
    ``norm0`` (bias and ReLU) and ``norm1`` (bias and the residual), the
    up-path's four (bias and ReLU)."""
    h, w = HEIGHT // 16, WIDTH // 16
    encode = [(f"encoder norm{i}", (BATCH, HEIGHT >> i, WIDTH >> i, c), (True, True, False), 1)
              for i, c in enumerate((60, 120, 240, 480, 960))]
    blocks = cfg.num_residual_blocks
    decode = [("norm_in", (BATCH, h, w, cfg.num_latents), (False, False, False), 1),
              ("norm_head", (BATCH, h, w, 960), (True, False, False), 1),
              ("res norm0", (BATCH, h, w, 960), (True, True, False), blocks),
              ("res norm1", (BATCH, h, w, 960), (True, False, True), blocks)]
    decode += [(f"upnorm{i}", (BATCH, h << (i + 1), w << (i + 1), c), (True, True, False), 1)
               for i, c in enumerate((480, 240, 120, 60))]
    return {"encode": encode, "decode": decode}


def channel_norm_bytes(shape, flags) -> int:
    """Bytes of one call read and written once: x, out and the residual,
    gamma, beta and the bias."""
    n, c = int(np.prod(shape)), shape[-1]
    bias, _, residual = flags
    return 4 * (n * (2 + residual) + c * (2 + bias))


def graph_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` replayed from a CUDA graph over
    ``reps`` back-to-back replays: the host's enqueue of a call (the
    wrapper's checks, allocations and launch) never holds the card, as it
    does not on a path that keeps the card busy."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = cuda_ms(graph.replay, reps)
    del graph
    return ms


def time_channel_norm(cfg, card: str, reps: int) -> dict:
    """13g: the fused ChannelNorm against its twin (within 4 ulps; whether
    bit for bit is logged) at every call of an encoded and a decoded batch,
    and its time beside its bytes bound, the
    twin's and ``F.layer_norm``'s with the same bias, ReLU and add, each
    replayed from a CUDA graph (:func:`graph_ms`), in turns (twin, kernel,
    yardstick, kernel, twin); each call's time counted as often as a batch
    makes it."""
    import torch.nn.functional as F

    from compression_tpu_torch.layers.channel_norm_kernel import (
        fused_channel_norm, fused_channel_norm_reference)

    def library(x, gamma, beta, bias, residual, relu):
        # Yardstick only (never called by the port): torch's fused layer
        # norm, with the bias added before it and the ReLU or add after.
        v = x if bias is None else x + bias
        out = F.layer_norm(v, (x.shape[-1],), gamma, beta, 1e-3)
        if relu:
            out = torch.relu_(out)
        return out if residual is None else out.add_(residual)

    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {}
    for phase, calls in channel_norm_calls(cfg).items():
        total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
        rows_out = []
        for label, shape, (bias, relu, residual), count in calls:
            c = shape[-1]
            x = torch.randn(shape, device="cuda", generator=gen).mul_(5).add_(3)
            gamma = torch.randn(c, device="cuda", generator=gen).mul_(0.3).add_(1)
            beta = torch.randn(c, device="cuda", generator=gen).mul_(0.3)
            b = torch.randn(c, device="cuda", generator=gen) if bias else None
            r = torch.randn(shape, device="cuda", generator=gen) if residual else None
            args = (x, gamma, beta, b, r, relu)
            with torch.inference_mode():
                got = fused_channel_norm(*args)
                want = fused_channel_norm_reference(*args)
                err = (got - want).abs().max().item()
                lib_err = (library(*args) - want).abs().max().item()
                # Bit for bit where ATen's sum order is the kernel's (the card
                # test test_channel_norm_sums_rows_as_torch_mean holds that);
                # held here to 4 ulps of the largest output.
                bit_equal = torch.equal(got, want)
                if err > 4 * torch.finfo(torch.float32).eps * want.abs().max().item():
                    raise AssertionError(f"13g {label}: kernel off its twin by {err:.3e}")
                del got, want
                runs = {"plain_ms": [], "ms": [], "library_ms": []}
                for key, fn in (("plain_ms", fused_channel_norm_reference),
                                ("ms", fused_channel_norm), ("library_ms", library),
                                ("ms", fused_channel_norm),
                                ("plain_ms", fused_channel_norm_reference)):
                    runs[key].append(graph_ms(lambda: fn(*args), reps))
            times = {k: sum(v) / len(v) for k, v in runs.items()}
            bound = 1e3 * channel_norm_bytes(shape, (bias, relu, residual)) / PEAK_HBM_BYTES
            for k in ("ms", "plain_ms", "library_ms"):
                total[k] += count * times[k]
            total["bound_ms"] += count * bound
            share = 100 * bound / times["ms"]
            rows_out.append(dict(label=label, shape=shape, count=count, bound_ms=bound,
                                 bound_share=share, max_abs_err=err, bit_equal=bit_equal,
                                 **times))
            log(f"  13g {phase} {label} {'x'.join(map(str, shape))} (bias {bias:d} relu "
                f"{relu:d} residual {residual:d}) x{count}: kernel {times['ms']:.4f} ms, "
                f"{share:.1f}% of its bytes bound {bound:.4f} ms; twin "
                f"{times['plain_ms']:.4f} ms; layer_norm {times['library_ms']:.4f} ms; "
                f"max_abs_err {err:.3e}{' (bit-equal)' if bit_equal else ''} (layer_norm "
                f"{lib_err:.3e})")
            del x, r, args
        log(f"13g ChannelNorm, the {phase} of a batch of {BATCH} ({card}): kernel "
            f"{total['ms']:.4f} ms ({total['ms'] / BATCH:.4f} an image), bound "
            f"{total['bound_ms']:.4f} ms (bytes), {100 * total['bound_ms'] / total['ms']:.1f}% "
            f"of it; twin {total['plain_ms']:.4f} ms; layer_norm {total['library_ms']:.4f} ms")
        result[phase] = dict(calls=rows_out, **total)
    return result


def conv3x3_calls(cfg) -> list:
    """13h: the 3x3 convolution kernel's calls of a decoded batch of BATCH
    HEIGHTxWIDTH images, as ``(label, (N, H, W, cin, cout), calls a
    batch)``: the generator's conv_in and two a residual block."""
    h, w = HEIGHT // 16, WIDTH // 16
    return [("conv_in", (BATCH, h, w, cfg.num_latents, 960), 1),
            ("residual", (BATCH, h, w, 960, 960), 2 * cfg.num_residual_blocks)]


def conv3x3_bounds_ms(shape) -> dict:
    """The least ms of one call: its 3xTF32 products at the tensor cores'
    TF32 rate (the kernel's bound), and its float32 multiply-adds on the
    CUDA cores (any float32 kernel without the tensor cores)."""
    n, h, w, cin, cout = shape
    flops = 2 * n * h * w * cout * 9 * cin
    return {"bound_ms": 1e3 * 3 * flops / PEAK_TF32_FLOPS,
            "fp32_bound_ms": 1e3 * flops / PEAK_FP32_FLOPS}


def time_conv_kernel(tag: str, what: str, card: str, reps: int, kernel, twin, calls: list,
                     yardsticks: dict, held_to: str, slack: float) -> dict:
    """13h and 13i: a convolution kernel at each of ``calls`` (``(label, (N,
    H, W, cin, cout), calls a batch)``, a decoded batch's): its largest
    error against ``twin`` in float64 within ``slack`` times that of
    ``held_to`` (``"plain"``, the twin in float32, or a yardstick's key),
    and its time beside its bounds (:func:`conv3x3_bounds_ms`), the twin's
    and each yardstick's (``{key: (name, make)}``, ``make(x, weight)``
    giving the call and what turns its output into NHWC), each replayed from
    a CUDA graph (:func:`graph_ms`), in turns (twin, kernel, yardsticks,
    kernel, yardsticks reversed, twin); each call's time counted as often as
    a batch makes it."""

    def key(k, name):
        return f"{k}_{name}" if k else name

    gen = torch.Generator(device="cuda").manual_seed(0)
    names = {"": "kernel", "plain": "twin", **{k: v[0] for k, v in yardsticks.items()}}
    total = dict.fromkeys([key(k, "ms") for k in names] + ["bound_ms", "fp32_bound_ms"], 0.0)
    rows_out = []
    for label, shape, count in calls:
        n, h, w, cin, cout = shape
        x = torch.randn(n, h, w, cin, device="cuda", generator=gen)
        weight = torch.randn(cout, cin, 3, 3, device="cuda", generator=gen) / (9 * cin) ** 0.5
        fns = {"": (lambda: kernel(x, weight), None), "plain": (lambda: twin(x, weight), None),
               **{k: make(x, weight) for k, (_, make) in yardsticks.items()}}
        with torch.inference_mode():
            want = twin(x.double(), weight.double())
            errs = {}
            for k, (fn, to_nhwc) in fns.items():
                out = fn() if to_nhwc is None else to_nhwc(fn())
                errs[k] = (out.double() - want).abs().max().item()
                del out
            del want
            if errs[""] > slack * errs[held_to]:
                raise AssertionError(f"{tag} {label}: kernel {errs['']:.3e} from float64, "
                                     f"{names[held_to]} {errs[held_to]:.3e}")
            runs = {k: [] for k in fns}
            for k in ["plain", "", *yardsticks, "", *reversed(yardsticks), "plain"]:
                runs[k].append(graph_ms(fns[k][0], reps))
        times = {key(k, "ms"): sum(v) / len(v) for k, v in runs.items()}
        bounds = conv3x3_bounds_ms(shape)
        for k, v in {**times, **bounds}.items():
            total[k] += count * v
        share = 100 * bounds["bound_ms"] / times["ms"]
        rows_out.append(dict(label=label, shape=shape, count=count, bound_share=share,
                             **{key(k, "max_abs_err"): e for k, e in errs.items()}, **bounds,
                             **times))
        log(f"  {tag} {label} {'x'.join(map(str, shape))} x{count}: kernel {times['ms']:.4f} ms, "
            f"{share:.1f}% of its 3xTF32 bound {bounds['bound_ms']:.4f} ms (float32 CUDA-core "
            f"bound {bounds['fp32_bound_ms']:.4f} ms); "
            + "; ".join(f"{names[k]} {times[key(k, 'ms')]:.4f} ms" for k in names if k)
            + "; max_abs_err " + ", ".join(f"{names[k]} {e:.3e}" for k, e in errs.items()))
        del x, weight, fns
    log(f"{tag} {what} of a decoded batch of {BATCH} ({card}): kernel {total['ms']:.4f} ms "
        f"({total['ms'] / BATCH:.4f} an image), bound {total['bound_ms']:.4f} ms (3xTF32), "
        f"{100 * total['bound_ms'] / total['ms']:.1f}% of it; float32 CUDA-core bound "
        f"{total['fp32_bound_ms']:.4f} ms; "
        + "; ".join(f"{names[k]} {total[key(k, 'ms')]:.4f} ms" for k in names if k))
    return dict(calls=rows_out, **total)


def time_conv3x3(cfg, card: str, reps: int) -> dict:
    """13h: the 3x3 convolution kernel at each call of a decoded batch
    (:func:`time_conv_kernel`): its largest error against float64 within 2x
    of its twin's (cuDNN in float32, TF32 off, through the channels-last
    view, as the port ran these convolutions before), and its time beside
    ``F.conv2d``'s on NCHW tensors (cuDNN in its own layout, the
    yardstick)."""
    import torch.nn.functional as F

    from compression_tpu_torch.layers.conv3x3_kernel import conv3x3, conv3x3_reference

    def library(x, weight):
        x_nchw = x.permute(0, 3, 1, 2).contiguous()
        return lambda: F.conv2d(x_nchw, weight, padding=1), lambda out: out.permute(0, 2, 3, 1)

    return time_conv_kernel("13h", "3x3 convolutions", card, reps, conv3x3, conv3x3_reference,
                            conv3x3_calls(cfg), {"library": ("F.conv2d NCHW", library)},
                            held_to="plain", slack=2.0)


def conv_up3x3_calls() -> list:
    """13i: the up-convolution kernel's calls of a decoded batch of BATCH
    HEIGHTxWIDTH images, as ``(label, (N, H, W, cin, cout), calls a
    batch)``: the generator's up0-up3, each once a batch."""
    widths = (960, 480, 240, 120, 60)
    return [(f"up{i}", (BATCH, HEIGHT // 2 ** (4 - i), WIDTH // 2 ** (4 - i), cin, cout), 1)
            for i, (cin, cout) in enumerate(zip(widths, widths[1:]))]


def time_conv_up3x3(card: str, reps: int) -> dict:
    """13i: the up-convolution kernel at each call of a decoded batch
    (:func:`time_conv_kernel`): its largest error against float64 no larger
    than ``signal_conv``'s (cuDNN's float32 phase convolution, TF32 off, and
    the depth-to-space copy, as the port ran these calls before), and its
    time (the 9 products an input pixel, as :func:`conv3x3_bounds_ms` counts
    them) beside that ``signal_conv`` call's and ``F.conv_transpose2d``'s on
    NCHW tensors (one PyTorch call of the same function, the yardstick)."""
    import torch.nn.functional as F

    from compression_tpu_torch.layers.conv_up3x3_kernel import conv_up3x3, conv_up3x3_reference
    from compression_tpu_torch.layers.signal_conv import signal_conv

    def phase_conv(x, weight):
        return lambda: signal_conv(x, weight, corr=False, strides_up=2, padding="same_zeros"), None

    def library(x, weight):
        x_nchw = x.permute(0, 3, 1, 2).contiguous()
        w_t = weight.transpose(0, 1).contiguous()  # conv_transpose2d's (cin, cout, 3, 3)
        return (lambda: F.conv_transpose2d(x_nchw, w_t, stride=2, padding=1, output_padding=1),
                lambda out: out.permute(0, 2, 3, 1))

    return time_conv_kernel("13i", "up-convolutions", card, reps, conv_up3x3,
                            conv_up3x3_reference, conv_up3x3_calls(),
                            {"signal_conv": ("signal_conv", phase_conv),
                             "library": ("F.conv_transpose2d NCHW", library)},
                            held_to="signal_conv", slack=1.0)


def phase_hific(card: str, reps: int, batches: int) -> dict:
    """Phase 13: HiFiC hific-mi at full width: one joint step against the
    CPU, training from the seed and a step's launches, the codec of the
    trained model with both coders, K3 and K2 on its symbols and rows,
    throughput, a profile by kind, the fused ChannelNorm's kernel, the 3x3
    convolution kernel and the up-convolution kernel."""
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
    nets = dict(norm=hific_norm_launches(cfg), conv=hific_conv_launches(cfg),
                up=hific_upconv_launches())
    host_blobs, host_out, host_launches = phase_codec(
        codec, images, hific, label="13c hific codec", min_psnr=None, gdn=0, **nets)
    launches = phase_codec_device(codec, images, host_blobs, host_out,
                                  label="13c hific codec (device coder)", gdn=0, **nets)
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
    norm = time_channel_norm(cfg, card, reps)
    conv = time_conv3x3(cfg, card, reps)
    upconv = time_conv_up3x3(card, reps)
    return dict(train=train, host_launches=host_launches, launches=launches, rans=rans_k,
                throughput=rates, profile=profiles, coded_bpp=coded, host_bpp=host_bpp,
                channel_norm=norm, norm_launches=hific_norm_launches(cfg), conv3x3=conv,
                conv_launches=hific_conv_launches(cfg), conv_up3x3=upconv,
                upconv_launches=hific_upconv_launches())


# -- phase 14: the tfci CLI ---------------------------------------------------

CLI = "compression_tpu_torch.cli.tfci"
# A subprocess runs the CLI as `-m` does, and reports on stderr the epoch
# time at which it first initializes the card (torch.cuda's lazy init).
CLI_FIRST_CALL = (
    "import runpy, sys, time, torch\n"
    "init = torch.cuda._lazy_init\n"
    "def lazy_init():\n"
    "    if not torch.cuda.is_initialized():\n"
    "        print(f'first device call at {time.time()!r}', file=sys.stderr, flush=True)\n"
    "    init()\n"
    "torch.cuda._lazy_init = lazy_init\n"
    f"runpy.run_module({CLI!r}, run_name='__main__', alter_sys=True)\n"
)
# K1 launches of one compress (or one decompress) of a family's codec.
CLI_GDN = {"bls2017": 2, "bmshj2018-factorized": 3, "mbt2018": 3,
           "ms2020": 3, "b2018-gdn-128": 2, "hific-lo": 0}


# The kernels of HiFiC's networks, which a codec's compress and decompress
# each launch a count of its own.
HIFIC_KERNELS = ("channel_norm", "conv3x3", "conv_up3x3")


def reset_launches() -> None:
    from compression_tpu_torch.codec import rans
    from compression_tpu_torch.layers.channel_norm_kernel import fused_channel_norm
    from compression_tpu_torch.layers.conv3x3_kernel import conv3x3
    from compression_tpu_torch.layers.conv_up3x3_kernel import conv_up3x3
    from compression_tpu_torch.layers.gdn_kernel import fused_gdn, fused_gdn_general

    fused_gdn.launches = rans.rans_encode.launches = rans.rans_decode.launches = 0
    fused_gdn_general.launches = fused_channel_norm.launches = conv3x3.launches = 0
    conv_up3x3.launches = 0


def read_launches() -> dict:
    from compression_tpu_torch.codec import rans
    from compression_tpu_torch.layers.channel_norm_kernel import fused_channel_norm
    from compression_tpu_torch.layers.conv3x3_kernel import conv3x3
    from compression_tpu_torch.layers.conv_up3x3_kernel import conv_up3x3
    from compression_tpu_torch.layers.gdn_kernel import fused_gdn, fused_gdn_general

    return {"gdn": fused_gdn.launches, "rans_encode": rans.rans_encode.launches,
            "rans_decode": rans.rans_decode.launches,
            "gdn_general": fused_gdn_general.launches,
            "channel_norm": fused_channel_norm.launches, "conv3x3": conv3x3.launches,
            "conv_up3x3": conv_up3x3.launches}


def launches_of(gdn: int = 0, enc: int = 0, dec: int = 0, general: int = 0,
                norm: int = 0, conv: int = 0, up: int = 0) -> dict:
    return {"gdn": gdn, "rans_encode": enc, "rans_decode": dec, "gdn_general": general,
            "channel_norm": norm, "conv3x3": conv, "conv_up3x3": up}


def hific_norm_launches(cfg) -> tuple:
    """The fused ChannelNorm's launches of one HiFiC encode and one decode of
    a batch: the encoder's 5 norms; the generator's norm_in, norm_head, two a
    residual block and the up-path's 4."""
    return 5, 2 + 2 * cfg.num_residual_blocks + 4


def hific_conv_launches(cfg) -> tuple:
    """The 3x3 convolution kernel's launches of one HiFiC encode and one
    decode of a batch: none encoding (7x7 and stride-2 convolutions); the
    generator's conv_in and two a residual block."""
    return 0, 1 + 2 * cfg.num_residual_blocks


def hific_upconv_launches() -> tuple:
    """The up-convolution kernel's launches of one HiFiC encode and one
    decode of a batch: none encoding; the generator's up0-up3."""
    return 0, 4


def tfci(argv: list, want=None, device: str = None, label: str = None) -> tuple:
    """One CLI verb in this process (``main(argv)`` on ``device``, DEVICE by
    default): its wall ms, its launches (the counts set to 0 just before it
    and read just after; held to ``want``) and its standard output."""
    from compression_tpu_torch.cli.tfci import main

    reset_launches()
    out = io.StringIO()
    sync()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main(["--device", device or DEVICE] + argv)
    sync()
    ms = 1e3 * (time.perf_counter() - t0)
    launches = read_launches()
    log(f"  tfci {label or ' '.join(argv[:2])}: {ms:.1f} ms, launches {launches}; "
        + " | ".join(out.getvalue().strip().splitlines()[-2:]))
    if rc != 0:
        raise AssertionError(f"tfci {argv} returned {rc}")
    if want is not None and launches != want:
        raise AssertionError(f"tfci {argv}: expected launches {want}, saw {launches}")
    return ms, launches, out.getvalue()


def tfci_process(argv: list, first_call: bool = False) -> dict:
    """One CLI verb in a process of its own: ``python -X importtime -m``
    (or, with ``first_call``, the same module through runpy with the card's
    first initialization reported). Returns wall ms, the start-up ms to
    the first device call (or None) and the top-level modules imported."""
    head = ["-c", CLI_FIRST_CALL] if first_call else ["-m", CLI]
    cmd = [sys.executable, "-X", "importtime", *head, "--device", DEVICE, *argv]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.time()
    proc = subprocess.run(cmd, env=env, cwd=str(ROOT), capture_output=True, text=True,
                          timeout=300)
    wall_ms = 1e3 * (time.time() - t0)
    if proc.returncode != 0:
        raise AssertionError(f"tfci {argv} in its own process returned {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    first = re.search(r"first device call at (\S+)", proc.stderr)
    startup_ms = 1e3 * (float(first.group(1)) - t0) if first else None
    modules = {m.split(".")[0] for m in re.findall(
        r"^import time:\s*\d+\s*\|\s*\d+\s*\|\s*(\S+)", proc.stderr, re.M)}
    log(f"  tfci {' '.join(argv[:2])} in its own process: {wall_ms:.1f} ms"
        + (", start-up to the first device call "
           + (f"{startup_ms:.1f} ms" if first else "not measured (no device call seen)")
           if first_call else "")
        + f"; {proc.stdout.strip()}")
    if "PIL" in modules or "jax" in modules or "compression_tpu" in modules:
        raise AssertionError(f"the CLI process imported {modules & {'PIL', 'jax', 'compression_tpu'}}")
    if "compression_tpu_torch" not in modules:
        raise AssertionError("-X importtime showed no import of the port")
    return dict(wall_ms=wall_ms, startup_ms=startup_ms)


def cli_profile(label: str, argv: list, launches: dict) -> None:
    """The verb again under ``profile_device``: the K1, general GDN, K3 and
    K2 kernels the trace shows equal the wrappers' counts."""
    from compression_tpu_torch.cli.tfci import main

    with contextlib.redirect_stdout(io.StringIO()):
        prof = profile_device(f"14 tfci {label}", lambda: main(["--device", DEVICE] + argv))
    if not prof:
        return
    seen = {name: prof["count_by_kind"][kind] for name, kind in (
        ("gdn", "K1"), ("rans_encode", "K3"), ("rans_decode", "K2"),
        ("gdn_general", "gdn_general"))}
    log(f"  traced kernels of tfci {label}: {seen}")
    if seen != {k: launches[k] for k in seen}:
        raise AssertionError(f"tfci {label}: the trace shows {seen}, the wrappers {launches}")


def equal_share(a: np.ndarray, b: np.ndarray) -> tuple:
    diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int(diff.max()), float(np.mean(diff == 0))


def cli_tiny_families(tmp: pathlib.Path, png: str) -> dict:
    """14i: every registry family through the CLI on the card: at
    TPC_TINY_MODELS=1, 3 training steps, then compress and decompress with
    each coder the family has; hific-lo at full width with random weights."""
    os.environ["TPC_TINY_MODELS"] = "1"
    out = {}
    try:
        for name, train, coders, extra in (
                ("bls2017", "bls2017", ("host",), []),
                ("bmshj2018-factorized", "bmshj2018-factorized", ("host",), []),
                ("mbt2018", "mbt2018", ("host", "device"), []),
                ("ms2020", "ms2020", ("host", "device"), []),
                ("b2018-gdn-128", "b2018", ("host",), ["--rd_parameter", "2"])):
            tfci(["train", train, "--steps", "3", "--batch-size", "2", "--patch-size", "64"])
            out[name] = cli_round_trips(tmp, png, name, coders, extra)
    finally:
        del os.environ["TPC_TINY_MODELS"]
    out["hific-lo"] = cli_round_trips(tmp, png, "hific-lo", ("host", "device"),
                                      ["--allow-random"])
    return out


def cli_round_trips(tmp, png, name, coders, extra) -> dict:
    """compress then decompress with each coder; both decodes equal."""
    from compression_tpu_torch.models import hific
    from compression_tpu_torch.util.image import read_png

    gdn, decoded, launches = CLI_GDN[name], {}, {}
    streams = 4 if name == "ms2020" else 1  # TPC_TINY_MODELS: 4 slices
    norm_c, norm_d = (hific_norm_launches(hific.get_config(name)) if name.startswith("hific")
                      else (0, 0))
    conv_c, conv_d = (hific_conv_launches(hific.get_config(name)) if name.startswith("hific")
                      else (0, 0))
    up_c, up_d = hific_upconv_launches() if name.startswith("hific") else (0, 0)
    for coder in coders:
        dev = coder == "device"
        tfci_file, out_png = str(tmp / f"{name}_{coder}.tfci"), str(tmp / f"{name}_{coder}.png")
        flag = ["--device-coder"] if dev else []
        launches[f"compress ({coder})"] = tfci(
            ["compress", name, png, tfci_file, *extra, *flag],
            want=launches_of(gdn, 2 * streams if dev else 0, norm=norm_c, conv=conv_c,
                             up=up_c))[1]
        launches[f"decompress ({coder})"] = tfci(
            ["decompress", tfci_file, out_png, *(["--allow-random"] if "--allow-random" in extra
                                                 else [])],
            want=launches_of(gdn, 0, streams if dev else 0, norm=norm_d, conv=conv_d,
                             up=up_d))[1]
        decoded[coder] = read_png(out_png)
        if decoded[coder].shape != (HEIGHT, WIDTH, 3):
            raise AssertionError(f"{name}: decoded shape {decoded[coder].shape}")
    if len(decoded) == 2 and not np.array_equal(decoded["host"], decoded["device"]):
        raise AssertionError(f"{name}: the device-coded file decodes differently")
    return launches


def phase_cli(card: str) -> dict:
    """Phase 14: the tfci CLI on the card, in a model directory of its own
    holding ckpt/bmshj2018.msgpack as bmshj2018-hyperprior.msgpack."""
    import shutil
    import tempfile

    from compression_tpu_torch.models import bmshj2018, codec_base, codec_cache, common
    from compression_tpu_torch.entropy_models.continuous_base import load_tables
    from compression_tpu_torch.util.image import psnr_np, read_png, write_png

    log(f"tfci CLI (phase 14; {card}):")
    t_phase = time.perf_counter()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="tfci_"))
    models = tmp / "models"
    models.mkdir()
    ckpt = models / "bmshj2018-hyperprior.msgpack"
    shutil.copy(ROOT / "ckpt" / "bmshj2018.msgpack", ckpt)
    saved_env = {k: os.environ.pop(k, None)
                 for k in ("TPC_MODEL_DIR", "TPC_TINY_MODELS", "TPC_TABLE_CACHE_FILE")}
    os.environ["TPC_MODEL_DIR"] = str(models)
    table_ms = []

    def tables_via_disk_timed(build, module=None):
        t0 = time.perf_counter()
        tables = codec_cache.tables_via_disk(build, module)
        table_ms.append(1e3 * (time.perf_counter() - t0))
        return tables

    codec_base.tables_via_disk = tables_via_disk_timed
    losses = []
    train_step = common.train_step

    def train_step_recorded(*args, **kwargs):
        loss, metrics = train_step(*args, **kwargs)
        losses.append(loss.detach())
        return loss, metrics

    common.train_step = train_step_recorded
    try:
        image = structured_image(HEIGHT, WIDTH)
        png = str(tmp / "in.png")
        write_png(png, image)
        evals = tmp / "eval"
        evals.mkdir()
        for seed in range(3):
            write_png(str(evals / f"{seed}.png"), structured_image(HEIGHT, WIDTH, seed))
        name = "bmshj2018-hyperprior"
        a, b, b_own = (str(tmp / f) for f in ("a.tfci", "b.tfci", "b_own.tfci"))
        ms = {}
        # 14a models; 14b host-coded compress, building and writing the tables.
        ms["models"] = tfci(["models"], want=launches_of())[0]
        ms["compress (host, tables built)"] = tfci(["compress", name, png, a],
                                                   want=launches_of(3))[0]
        st = os.stat(ckpt)
        table_file = f"{ckpt}.{st.st_mtime_ns}.{st.st_size}.tables.npz"
        if len(table_ms) != 1 or not os.path.exists(table_file):
            raise AssertionError(f"the first compress wrote no table file {table_file}")
        before = os.stat(table_file)
        # 14c the device-coded compress in a second process, which loads the tables.
        sub = {"compress (device)": tfci_process(["compress", name, png, b, "--device-coder"])}
        after = os.stat(table_file)
        if (after.st_ino, after.st_mtime_ns) != (before.st_ino, before.st_mtime_ns):
            raise AssertionError("the second process rebuilt the table file")
        launch = {}
        ms["compress (device)"], launch["compress (device)"], _ = tfci(
            ["compress", name, png, b_own, "--device-coder"], want=launches_of(3, 2))
        if open(b, "rb").read() != open(b_own, "rb").read():
            raise AssertionError("the device-coded file differs between processes")
        # 14d decompress of both files, here and in other processes.
        ms["compress (host)"], launch["compress (host)"], _ = tfci(
            ["compress", name, png, a], want=launches_of(3))
        ms["decompress (host file)"], launch["decompress (host file)"], _ = tfci(
            ["decompress", a, str(tmp / "a.png")], want=launches_of(3))
        ms["decompress (device file)"], launch["decompress (device file)"], _ = tfci(
            ["decompress", b, str(tmp / "b.png")], want=launches_of(3, 0, 1))
        sub["decompress (device file)"] = tfci_process(["decompress", b, str(tmp / "b_sub.png")])
        sub["decompress (host file)"] = tfci_process(["decompress", a, str(tmp / "a_sub.png")],
                                                     first_call=True)
        out_a, out_b = read_png(str(tmp / "a.png")), read_png(str(tmp / "b.png"))
        if not np.array_equal(out_a, out_b):
            raise AssertionError("the device-coded file decodes to another image")
        for f, want in (("a_sub.png", out_a), ("b_sub.png", out_b)):
            if not np.array_equal(read_png(str(tmp / f)), want):
                raise AssertionError(f"{f}: the decode in another process differs")
        if len(table_ms) < 5:
            raise AssertionError(f"expected the tables loaded in every verb, saw {table_ms}")
        # The Codec API on the same tables: the same bytes and image.
        tables = load_tables(table_file)
        codec = bmshj2018.Codec(bmshj2018.load_model(ckpt), device=DEVICE, tables=tables)
        api = codec.compress(image)
        if api != open(a, "rb").read():
            raise AssertionError("the CLI's host-coded file differs from Codec.compress")
        if codec.compress(image, "device") != open(b, "rb").read():
            raise AssertionError("the CLI's device-coded file differs from Codec.compress")
        if not np.array_equal(codec.decompress(api), out_a):
            raise AssertionError("the CLI's decode differs from Codec.decompress")
        psnr = float(psnr_np(out_a, image))
        bpp = 8.0 * os.path.getsize(a) / (HEIGHT * WIDTH)
        log(f"  host file {os.path.getsize(a)} B, {bpp:.4f} bpp, PSNR {psnr:.3f} dB; device "
            f"file {os.path.getsize(b)} B; byte-identical to Codec.compress (both coders) "
            "and between processes; the two coders' decodes equal, here and in other "
            f"processes; table build+save {table_ms[0]:.1f} ms (first compress), load "
            + ", ".join(f"{t:.1f}" for t in table_ms[1:]) + " ms (later verbs here); "
            "the second process left the table file as it was")
        if not psnr > 25.0:
            raise AssertionError(f"PSNR {psnr:.3f} dB <= 25")
        # 14e the card-written file decoded on the CPU: printed, not held.
        cpu_png = str(tmp / "a_cpu.png")
        tfci(["decompress", a, cpu_png], device="cpu", label="decompress on the CPU")
        worst, share = equal_share(read_png(cpu_png), out_a)
        log(f"  CPU decode of the card's file: {100 * share:.3f}% of pixels equal, "
            f"max |diff| {worst} levels (not held: no decode across devices is promised)")
        # 14f the CLI's cost per image against the Codec API's.
        reps = 3
        cli_c = min(tfci(["compress", name, png, a], want=launches_of(3))[0]
                    for _ in range(reps))
        cli_d = min(tfci(["decompress", a, str(tmp / "a.png")], want=launches_of(3))[0]
                    for _ in range(reps))
        api_c = min(timed_ms(lambda: codec.compress(image)) for _ in range(reps))
        api_d = min(timed_ms(lambda: codec.decompress(api)) for _ in range(reps))
        rates = {"cli_compress": 1e3 / cli_c, "cli_decompress": 1e3 / cli_d,
                 "api_compress": 1e3 / api_c, "api_decompress": 1e3 / api_d}
        log(f"  img/s (best of {reps}, one {HEIGHT}x{WIDTH} image): CLI compress "
            f"{rates['cli_compress']:.3f} vs Codec {rates['api_compress']:.3f}, CLI "
            f"decompress {rates['cli_decompress']:.3f} vs Codec {rates['api_decompress']:.3f}; "
            f"the CLI's overhead {cli_c - api_c:.1f} / {cli_d - api_d:.1f} ms an image")
        overhead = cli_overhead(name, ckpt, png, str(tmp / "o.png"), image)
        # 14g dump and eval.
        npz = str(tmp / "d.npz")
        ms["dump"] = tfci(["dump", a, "--output", npz], want=launches_of())[0]
        with np.load(npz) as dumped:
            if str(dumped["model"]) != name or not {"0", "1", "2", "3"} <= set(dumped.files):
                raise AssertionError(f"dump --output wrote {dumped.files}")
        csv = str(tmp / "r.csv")
        ms["eval (3 images)"] = tfci(["eval", name, str(evals / "*.png"), "--csv", csv],
                                     want=launches_of(18))[0]
        rows = open(csv).read().strip().splitlines()
        if rows[0] != "image,bpp,psnr,msssim" or len(rows) != 5:
            raise AssertionError(f"eval CSV: {rows}")
        mean = [float(v) for v in rows[-1].split(",")[1:]]
        log(f"  eval mean: {mean[0]:.4f} bpp, PSNR {mean[1]:.3f} dB, MS-SSIM {mean[2]:.5f}")
        # 14h train 20 steps, then on to 30: it resumes at step 20.
        train = ["train", "bmshj2018", "--batch-size", str(TRAIN_BATCH),
                 "--patch-size", str(TRAIN_PATCH)]
        ms["train (20 steps)"] = tfci(train + ["--steps", "20"], want=launches_of(120))[0]
        ms["train (to 30, resumed)"], _, text = tfci(train + ["--steps", "30"],
                                                     want=launches_of(60))
        if f"resumed from {models / 'bmshj2018.train.msgpack'} @ step 20" not in text:
            raise AssertionError(f"train did not resume at step 20: {text[-400:]}")
        loss = [float(v) for v in torch.stack(losses).cpu()]
        first, last = float(np.mean(loss[:5])), float(np.mean(loss[-5:]))
        log(f"  {len(loss)} steps; mean loss over steps 1-5 {first:.4f}, 26-30 {last:.4f}")
        if len(loss) != 30 or not np.all(np.isfinite(loss)) or not last < first:
            raise AssertionError("the CLI's training loss did not fall")
        tfci(["compress", "bmshj2018", png, str(tmp / "t.tfci")], want=launches_of(3))
        tfci(["decompress", str(tmp / "t.tfci"), str(tmp / "t.png")], want=launches_of(3))
        log(f"  the trained checkpoint: PSNR "
            f"{float(psnr_np(read_png(str(tmp / 't.png')), image)):.3f} dB")
        # Launches again, counted by the profiler's trace.
        for label, argv in (("compress (host)", ["compress", name, png, a]),
                            ("compress (device)", ["compress", name, png, b_own,
                                                   "--device-coder"]),
                            ("decompress (host file)", ["decompress", a, str(tmp / "a.png")]),
                            ("decompress (device file)", ["decompress", b,
                                                          str(tmp / "b.png")])):
            cli_profile(label, argv, launch[label])
        # 14i every family of the registry.
        families = cli_tiny_families(tmp, png)
        if "PIL" in sys.modules:
            raise AssertionError("an in-process verb imported PIL")
    finally:
        codec_base.tables_via_disk = codec_cache.tables_via_disk
        common.train_step = train_step
        for k, v in saved_env.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
    total = time.perf_counter() - t_phase
    log(f"  PIL not imported by any verb, here or in the other processes; phase 14 "
        f"{total:.1f} s")
    return dict(verb_ms=ms, processes=sub, launches=launch, families=families,
                table_ms=table_ms, img_per_s=rates, overhead_ms=overhead, psnr=psnr, bpp=bpp,
                eval_mean=dict(zip(("bpp", "psnr", "msssim"), mean)),
                loss_first5=first, loss_last5=last, seconds=total)


def cli_overhead(name: str, ckpt, png: str, out_png: str, image: np.ndarray) -> dict:
    """The host steps a CLI verb takes around the codec, each timed alone
    (best of 3): the seeded model build, the checkpoint's parse and load,
    the move to the card, and the PNG read and write."""
    from compression_tpu_torch.cli import registry
    from compression_tpu_torch.models import common
    from compression_tpu_torch.util.image import read_png, write_png

    entry, _ = registry.resolve(name)
    model = entry.make_model()
    params = common.load_checkpoint(str(ckpt))[0]
    steps = {"model build": entry.make_model,
             "checkpoint parse": lambda: common.load_checkpoint(str(ckpt)),
             "load_state_dict": lambda: model.load_state_dict(params),
             "to the card": lambda: model.to("cpu").to(DEVICE),
             "PNG read": lambda: read_png(png),
             "PNG write": lambda: write_png(out_png, image)}
    out = {k: min(timed_ms(fn) for _ in range(3)) for k, fn in steps.items()}
    log("  a verb's host steps (ms, best of 3): "
        + ", ".join(f"{k} {v:.1f}" for k, v in out.items()))
    return out


# -- phase 15: the rest of the library at full width ----------------------------

LIB_LEVELS = 15     # noise levels of the universal models (the JAX default)
LIB_ALPHA = 5.0     # soft-round adapter's alpha (the JAX default)
LIB_MIXTURE = 3     # components of the logistic mixture
LIB_TOL = 1e-5      # card against CPU, of each tensor's largest entry (15d, 15e)
LIB_GRAD_TOL = 1e-4  # the universal rate's y-gradient, card against CPU (15a)
TIE_ULPS = 4        # CDF twin: a row may differ only at a float64 tie this close


@contextlib.contextmanager
def pinned_universal_noise(noise: torch.Tensor):
    """The universal models' training noise taken from ``noise`` (a CPU
    tensor), moved to each draw's device: the card and the CPU see the same
    U(-1/2, 1/2) draw."""
    from compression_tpu_torch.entropy_models import universal

    saved = universal.uniform_noise
    universal.uniform_noise = lambda t, generator: noise.to(t.device, t.dtype)
    try:
        yield
    finally:
        universal.uniform_noise = saved


def rel_max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want| (CPU tensors)."""
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def timed(label: str, card: str, steps: dict, fn, warm: bool = False):
    """Runs ``fn`` once (after one untimed call with ``warm``: the first
    call of a kernel pays its lazy load), syncing around it; logs and
    records its wall ms."""
    if warm:
        fn()
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    steps[label] = 1e3 * (time.perf_counter() - t0)
    log(f"  15{label}: {steps[label]:.1f} ms ({card})")
    return out


def greedy_ties(pmf: np.ndarray, length: int, precision: int) -> list:
    """Replays the C++ quantizer's greedy repair of one row in host float64
    and returns, for each step, ``(best, best_gain, runner_up, its_gain)``
    (gains for increments, losses for decrements): where the device's log
    may break a tie the other way."""
    total = 1 << precision
    p = np.where((pmf[:length] > 0) & np.isfinite(pmf[:length]), pmf[:length], 0.0)
    if p.sum() <= 0:
        p = np.ones(length)
    s = 0.0
    for v in p:  # left to right, as the C++ loop sums
        s += v
    x = p / s * total
    q = np.maximum(1, np.floor(x) + (x - np.floor(x) >= 0.5)).astype(np.int64)
    steps = []
    while q.sum() != total:
        inc = q.sum() < total
        with np.errstate(divide="ignore"):
            score = (p * np.log((q + 1.0) / q) if inc
                     else np.where(q > 1, -p * np.log(q / np.maximum(q - 1.0, 1e-300)), -np.inf))
        order = np.argsort(-score, kind="stable")
        steps.append((int(order[0]), float(score[order[0]]),
                      int(order[1]) if length > 1 else -1,
                      float(score[order[1]]) if length > 1 else -np.inf))
        q[order[0]] += 1 if inc else -1
    return steps


def initial_sums(pmf: np.ndarray, lengths: np.ndarray, precision: int) -> np.ndarray:
    """Each row's sum before the repair: sum of max(1, llround(p / sum(p) *
    2**precision)) over its entries."""
    valid = np.arange(pmf.shape[1])[None, :] < lengths[:, None]
    p = np.where(valid & np.isfinite(pmf) & (pmf > 0), pmf, 0.0)
    s = p.sum(1, keepdims=True)
    p = np.where(s > 0, p, valid.astype(np.float64))
    x = p / p.sum(1, keepdims=True) * (1 << precision)
    q = np.maximum(1, np.floor(x) + (x - np.floor(x) >= 0.5))
    return np.where(valid, q, 0).sum(1)


def check_cdf_twin(pmf: np.ndarray, lengths: np.ndarray, cdf: np.ndarray, precision: int,
                   card: str, steps: dict) -> dict:
    """15f: the plain torch quantizer on the card in float64 over the rows
    the table build gave the C++ quantizer, row for row against it; exact on
    the CPU. A row that differs on the card must be explained by a float64
    tie: two entries the repair chose between with gains within TIE_ULPS
    ulps, one of them an entry where the rows differ."""
    from compression_tpu_torch.codec import pmf_to_quantized_cdf, pmf_to_quantized_cdf_torch

    pmf_t, len_t = torch.from_numpy(pmf), torch.from_numpy(lengths)
    cpu = pmf_to_quantized_cdf_torch(pmf_t, len_t, precision).numpy()
    if not np.array_equal(cpu, cdf):
        raise AssertionError("15f: the CDF twin on the CPU differs from the C++ quantizer in "
                             f"{int((cpu != cdf).any(1).sum())} rows")
    on_card = pmf_t.to(DEVICE), len_t.to(DEVICE)
    got = timed("f CDF twin on the card", card, steps,
                lambda: pmf_to_quantized_cdf_torch(*on_card, precision)).cpu().numpy()
    reps = 5
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        pmf_to_quantized_cdf_torch(*on_card, precision)
    sync()
    twin_ms = 1e3 * (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        pmf_to_quantized_cdf(pmf, lengths, precision)
    cpp_ms = 1e3 * (time.perf_counter() - t0) / reps
    ties = []
    for r in np.flatnonzero((got != cdf).any(1)):
        n = int(lengths[r])
        differ = set(np.flatnonzero(np.diff(got[r, : n + 1]) != np.diff(cdf[r, : n + 1])))
        near = [(a, ga, b, gb) for a, ga, b, gb in greedy_ties(pmf[r], n, precision)
                if abs(ga - gb) <= TIE_ULPS * np.spacing(abs(ga)) and {a, b} & differ]
        log(f"  15f row {r}: the card's row differs from the C++ one at entries "
            f"{sorted(differ)}; float64 ties within {TIE_ULPS} ulps there: {near[:3]}")
        if not near:
            raise AssertionError(f"15f: row {r} differs with no float64 tie to explain it")
        ties.append(int(r))
    # Each repair step moves a row's sum by one unit.
    max_steps = int(np.abs((1 << precision) - initial_sums(pmf, lengths, precision)).max())
    # Byte bound: the PMF rows and lengths read once, the CDF rows written once.
    bound_ms = 1e3 * (pmf.nbytes + lengths.nbytes + got.nbytes) / PEAK_HBM_BYTES
    log(f"  15f CDF twin over {len(lengths)} rows of up to {pmf.shape[1]} entries: card "
        f"{twin_ms:.2f} ms a call (float64, {max_steps} repair steps at most; byte bound "
        f"{bound_ms:.4f} ms), C++ on the host {cpp_ms:.2f} ms; rows equal to the C++ "
        f"quantizer: {len(lengths) - len(ties)} of {len(lengths)} ({len(ties)} explained by "
        f"ties); exact on the CPU ({card})")
    return dict(rows=int(len(lengths)), max_len=int(pmf.shape[1]), ms=twin_ms, cpp_ms=cpp_ms,
                bound_ms=bound_ms, repair_steps=max_steps, tie_rows=len(ties), cpu_exact=True)


def spy_pmf(build):
    """Runs a table build and returns its tables and the float64 PMF rows,
    lengths and precision it handed the C++ quantizer."""
    from compression_tpu_torch.entropy_models import continuous_base

    seen = {}
    real = continuous_base.codec.pmf_to_quantized_cdf

    def spy(pmf, lengths, precision):
        seen.update(pmf=np.array(pmf), lengths=np.array(lengths), precision=precision)
        return real(pmf, lengths, precision)

    continuous_base.codec.pmf_to_quantized_cdf = spy
    try:
        tables = build()
    finally:
        continuous_base.codec.pmf_to_quantized_cdf = real
    return tables, seen


def library_universal(model, x, card: str, steps: dict) -> dict:
    """15a and 15b: y and z of the checkpoint coded by the universal models."""
    from compression_tpu_torch.distributions import NoisyNormal
    from compression_tpu_torch.entropy_models import (
        UniversalBatchedEntropyModel,
        UniversalIndexedEntropyModel,
        inverse_log_scale_fn,
        log_scale_fn,
    )

    with torch.no_grad():
        model.analysis(x)  # warm: cuDNN and K1 load on first use
        reset_launches()
        y = timed("a analysis (K1 x3)", card, steps, lambda: model.analysis(x))
        launches = read_launches()
    if launches != launches_of(gdn=3):
        raise AssertionError(f"15a: the analysis launched {launches}, expected K1 3")
    with torch.no_grad():
        z = model.hyper_analysis(y)
    # 15b: z over the checkpoint's hyperprior, dithered per channel.
    em_z = timed("b tables (128 channels)", card, steps, lambda: UniversalBatchedEntropyModel(
        model.hyperprior(), coding_rank=3, num_noise_levels=LIB_LEVELS, compression=True))
    offsets = np.unique(em_z.tables.offset)
    if len(offsets) < 2:
        raise AssertionError("15b: the dither offsets do not differ across channels")
    z_strings = timed("b compress z", card, steps, lambda: em_z.compress(z), warm=True)
    z_hat = timed("b decompress z", card, steps,
                  lambda: em_z.decompress(z_strings, tuple(z.shape[1:3])), warm=True)
    z_err = float(np.abs(z_hat - z.cpu().numpy()).max())
    if z_err > 0.5 + 1e-6 or em_z.compress(z.cpu()) != z_strings:
        raise AssertionError(f"15b: |z_hat - z| {z_err} or strings differ from the CPU's")
    z_eval = em_z(z, training=False)[0].detach().cpu().numpy()
    if float(np.abs(z_eval - z_hat).max()) > 1e-5:
        raise AssertionError("15b: the eval path is not the codec's grid")
    z_bytes = sum(map(len, z_strings))
    log(f"  15b universal batched on z {tuple(z.shape)}: {len(offsets)} distinct dither "
        f"offsets over 128 channels, |z_hat - z| <= {z_err:.4f}, {z_bytes} bytes, eval path "
        "== codec grid, strings byte-identical to the CPU port's")

    # 15a: y against 64 scales x 15 noise levels = 960 rows.
    with torch.no_grad():
        sigma = model.hyper_synthesis(torch.from_numpy(z_hat).to(DEVICE))
        indexes = inverse_log_scale_fn(sigma)
    em_y, spied = spy_pmf(lambda: timed(
        "a tables (960 rows)", card, steps, lambda: UniversalIndexedEntropyModel(
            lambda loc, scale: NoisyNormal(loc, scale), (64,),
            {"loc": torch.zeros_like, "scale": log_scale_fn}, coding_rank=3,
            num_noise_levels=LIB_LEVELS, compression=True)))
    if em_y.tables.num_cdfs != 960:
        raise AssertionError(f"15a: {em_y.tables.num_cdfs} table rows, expected 960")
    noise = torch.rand(y.shape, generator=torch.Generator().manual_seed(15)) - 0.5
    out = {}
    for device in (DEVICE, "cpu"):
        yd = y.detach().to(device).requires_grad_()
        with pinned_universal_noise(noise):
            _, bits = timed(f"a training call ({device})", card, steps,
                            lambda: em_y(yd, indexes.to(device), training=True),
                            warm=True)
            timed(f"a backward ({device})", card, steps, lambda: bits.sum().backward())
        out[device] = bits.detach().cpu(), yd.grad.cpu()
    bits_err = rel_max_err(out[DEVICE][0], out["cpu"][0])
    grad_err = rel_max_err(out[DEVICE][1], out["cpu"][1])
    if not (torch.isfinite(out[DEVICE][1]).all() and bits_err <= LIB_TOL
            and grad_err <= LIB_GRAD_TOL):
        raise AssertionError(f"15a: bits {bits_err:.2e} / y-gradient {grad_err:.2e} from the CPU's")
    strings = timed("a compress y", card, steps, lambda: em_y.compress(y, indexes), warm=True)
    y_hat = timed("a decompress y", card, steps, lambda: em_y.decompress(strings, indexes),
                  warm=True)
    y_err = float(np.abs(y_hat - y.cpu().numpy()).max())
    y_eval = em_y(y, indexes, training=False)[0].detach().cpu().numpy()
    eval_err = float(np.abs(y_eval - y_hat).max())
    same = em_y.compress(y.cpu(), indexes.cpu()) == strings
    if y_err > 0.5 + 1e-6 or eval_err > 1e-5 or not same:
        raise AssertionError(f"15a: |y_hat - y| {y_err}, eval vs codec {eval_err}, "
                             f"strings equal to the CPU's {same}")
    y_bytes = sum(map(len, strings))
    bpp = 8 * (y_bytes + z_bytes) / (x.shape[0] * HEIGHT * WIDTH)
    log(f"  15a universal indexed on y {tuple(y.shape)}: 960 rows, K1 launches {launches}; "
        f"training call (expected gradients) bits {bits_err:.2e} and y-gradient "
        f"{grad_err:.2e} from the CPU's (of their largest entry); |y_hat - y| <= {y_err:.4f}, "
        f"eval path within {eval_err:.1e} of the codec grid, strings byte-identical to the "
        f"CPU port's; {y_bytes} + {z_bytes} bytes, {bpp:.4f} bpp")
    return dict(y=y, launches=launches, spied=spied, tables=em_y.tables,
                universal_indexed=dict(rows=960, bits_rel_err=bits_err, grad_rel_err=grad_err,
                                       max_err=y_err, eval_err=eval_err, bytes=y_bytes, bpp=bpp),
                universal_batched=dict(channels=128, offsets=int(len(offsets)), max_err=z_err,
                                       bytes=z_bytes))


def library_power_law(y, card: str, steps: dict) -> dict:
    """15c: the power-law model on y."""
    from compression_tpu_torch.entropy_models import PowerLawEntropyModel

    em = PowerLawEntropyModel(coding_rank=3)
    penalty = timed("c penalty", card, steps, lambda: em.penalty(y), warm=True)
    err = rel_max_err(penalty, em.penalty(y.cpu()))
    strings = timed("c compress", card, steps, lambda: em.compress(y))
    back = timed("c decompress", card, steps, lambda: em.decompress(strings, tuple(y.shape)))
    if not np.array_equal(back, np.round(y.cpu().numpy())) or err > LIB_TOL:
        raise AssertionError(f"15c: decompress is not round(y), or the penalty is {err:.2e} "
                             "from the CPU's")
    if em.compress(y.cpu()) != strings:
        raise AssertionError("15c: strings differ from the CPU port's")
    nbytes = sum(map(len, strings))
    log(f"  15c power law on y: penalty {float(penalty.sum()):.1f} bits ({err:.1e} from the "
        f"CPU's, float32 sums), {nbytes} bytes of run-length gamma, decompress == round(y)")
    return dict(penalty_bits=float(penalty.sum()), penalty_rel_err=err, bytes=nbytes)


def library_priors(y, card: str, steps: dict) -> dict:
    """15d: a soft-rounded DeepFactorized prior and a logistic mixture at
    192 channels; and a mixture without analytic tails (the log-CDF
    root-find)."""
    import dataclasses as dc

    from compression_tpu_torch.distributions import (
        MixtureSameFamily,
        NoisyLogisticMixture,
        NoisySoftRoundedDeepFactorized,
        UniformNoiseAdapter,
        helpers,
    )
    from compression_tpu_torch.distributions.base import map_tensors
    from compression_tpu_torch.distributions.scalar import Logistic
    from compression_tpu_torch.entropy_models import ContinuousBatchedEntropyModel

    @dc.dataclass(frozen=True)
    class NoTails(MixtureSameFamily):
        def _lower_tail(self, tail_mass):
            return None

        def _upper_tail(self, tail_mass):
            return None

    rng = np.random.RandomState(15)
    mix = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.randn(192, LIB_MIXTURE), rng.randn(192, LIB_MIXTURE) * 2,
        np.exp(rng.uniform(-1, 1, (192, LIB_MIXTURE))))]
    priors = {
        "soft-rounded DeepFactorized": NoisySoftRoundedDeepFactorized(
            alpha=LIB_ALPHA, generator=torch.Generator().manual_seed(15), batch_shape=(192,)),
        "logistic mixture": NoisyLogisticMixture(*mix),
        "mixture, log-CDF tails": UniformNoiseAdapter(NoTails(mix[0], Logistic(mix[1], mix[2]))),
    }
    out = {}
    yr = torch.round(y)
    for name, prior_cpu in priors.items():
        prior = map_tensors(lambda t: t.to(DEVICE), prior_cpu)
        em = ContinuousBatchedEntropyModel(prior, coding_rank=3)
        tables = timed(f"d tables, {name}", card, steps, em.build_tables)
        want = ContinuousBatchedEntropyModel(prior_cpu, coding_rank=3).build_tables()
        if not all(np.array_equal(getattr(tables, k), getattr(want, k))
                   for k in ("cdf", "cdf_length", "cdf_offset", "offset")):
            raise AssertionError(f"15d {name}: tables differ from the CPU port's")
        grid = {}
        for key, fn in (("offset", lambda p: helpers.quantization_offset(p)),
                        ("lower", lambda p: helpers.lower_tail(p, em.tail_mass)),
                        ("upper", lambda p: helpers.upper_tail(p, em.tail_mass))):
            with torch.no_grad():
                got = timed(f"d {key} on the card, {name}", card, steps, lambda: fn(prior))
                grid[key] = rel_max_err(got, fn(prior_cpu))
        yd = yr.detach().to(DEVICE).requires_grad_()
        bits = timed(f"d training call, {name}", card, steps,
                     lambda: em(yd, torch.Generator(device=DEVICE).manual_seed(0))[1])
        bits.sum().backward()
        with torch.no_grad():  # two images against the CPU
            rate = em._bits(em._log2_prob(prior, yr[:2]), 4)
            rate_err = rel_max_err(rate, em._bits(em._log2_prob(prior_cpu, yr[:2].cpu()), 4))
        if not (torch.isfinite(bits).all() and torch.isfinite(yd.grad).all()) \
                or rate_err > LIB_TOL or max(grid.values()) > LIB_TOL:
            raise AssertionError(f"15d {name}: rate {rate_err:.2e}, grid {grid}, or a "
                                 "non-finite training call")
        log(f"  15d {name} at 192 channels: tables ({tables.num_cdfs} rows, up to "
            f"{int(tables.cdf_length.max())} entries) equal to the CPU port's; offset and tails "
            "on the card " + ", ".join(f"{k} {v:.1e}" for k, v in grid.items())
            + f" from the CPU's; rate of round(y) {rate_err:.1e} from the CPU's; training "
            "call and its backward finite")
        out[name] = dict(rows=int(tables.num_cdfs), rate_rel_err=rate_err, **{
            f"{k}_rel_err": v for k, v in grid.items()})
    return out


def library_signal_conv(card: str, steps: dict) -> dict:
    """15e: the five SignalConv variants at 192 channels, forward and
    backward in strict fp32, card against CPU."""
    from compression_tpu_torch.layers import SignalConv1D, SignalConv2D, SignalConv3D

    cases = {
        "5x5 stride-2 same_reflect down-conv": (SignalConv2D(
            192, 192, 5, corr=True, strides_down=2, padding="same_reflect", use_bias=True),
            (2, 32, 32, 192)),
        "channel-separable 5x5 up-conv": (SignalConv2D(
            192, 1, 5, corr=False, strides_up=2, padding="same_zeros",
            channel_separable=True, use_bias=True), (2, 16, 16, 192)),
        "rdft 5x5 stride-2 conv": (SignalConv2D(
            192, 192, 5, corr=True, strides_down=2, padding="same_zeros",
            kernel_param="rdft"), (2, 32, 32, 192)),
        "SignalConv1D 5 stride-2 same_reflect": (SignalConv1D(
            192, 192, 5, corr=True, strides_down=2, padding="same_reflect"), (2, 256, 192)),
        "SignalConv3D 3x3x3 up-conv": (SignalConv3D(
            192, 192, 3, corr=False, strides_up=2, padding="same_zeros"), (1, 4, 8, 8, 192)),
    }
    out = {}
    gen = torch.Generator().manual_seed(15)
    for name, (mod, shape) in cases.items():
        x = torch.randn(shape, generator=gen)
        results = {}
        for device in (DEVICE, "cpu"):
            m = mod.to(device)
            m.zero_grad(set_to_none=True)
            xd = x.to(device).requires_grad_()
            yd = timed(f"e {name} forward ({device})", card, steps, lambda: m(xd), warm=True)
            timed(f"e {name} backward ({device})", card, steps,
                  lambda: (yd * yd).sum().backward())
            results[device] = [yd.detach().cpu(), xd.grad.cpu()] + [
                p.grad.cpu() for p in m.parameters()]
        errs = [rel_max_err(g, w) for g, w in zip(results[DEVICE], results["cpu"])]
        if max(errs) > LIB_TOL:
            raise AssertionError(f"15e {name}: {errs} from the CPU (of each tensor's largest "
                                 f"entry), above {LIB_TOL}")
        log(f"  15e {name}, x {shape}: output {errs[0]:.1e}, dx {errs[1]:.1e}, "
            "parameter gradients " + ", ".join(f"{e:.1e}" for e in errs[2:])
            + " from the CPU's (of each one's largest entry)")
        out[name] = max(errs)
    return out


def library_toy(card: str, steps: dict) -> dict:
    """15g: the toy-source rate-distortion points at their defaults."""
    from compression_tpu_torch.models import toy_sources as toy

    t0 = time.perf_counter()
    rate, dist = toy.rd_point_ntc(toy.Config(), toy.banana, device=DEVICE)
    ntc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    vq_rate, vq_dist = toy.rd_point_ecvq(toy.banana, toy.Config().lmbda, device=DEVICE)
    vq_s = time.perf_counter() - t0
    steps["g rd_point_ntc"], steps["g rd_point_ecvq"] = 1e3 * ntc_s, 1e3 * vq_s
    if not all(np.isfinite(v) and v > 0 for v in (rate, dist, vq_rate, vq_dist)):
        raise AssertionError(f"15g: rate/distortion {rate, dist, vq_rate, vq_dist}")
    log(f"  15g toy sources, banana, lambda 1: NTC (3000 steps, 65,536 samples in one "
        f"stream) {rate:.4f} bits/sample, MSE {dist:.4f}, {ntc_s:.1f} s; ECVQ (256 codewords, "
        f"200 steps) {vq_rate:.4f} bits/sample, MSE {vq_dist:.4f}, {vq_s:.2f} s ({card})")
    return dict(ntc=dict(rate=rate, mse=dist, s=ntc_s), ecvq=dict(rate=vq_rate, mse=vq_dist, s=vq_s))


def phase_library(card: str) -> dict:
    """Phase 15: the library's entropy models, priors, convolutions, CDF
    twin and toy sources, at the full width of ckpt/bmshj2018.msgpack on the
    8 structured 768x512 images."""
    log(f"library (phase 15; {card}):")
    t_phase = time.perf_counter()
    steps = {}
    model = ckpt_model().to(DEVICE).eval()
    x = torch.from_numpy(structured_images()).to(DEVICE).to(torch.float32) / 255.0
    uni = library_universal(model, x, card, steps)
    power = library_power_law(uni["y"], card, steps)
    priors = library_priors(uni["y"], card, steps)
    convs = library_signal_conv(card, steps)
    spied = uni["spied"]
    twin = check_cdf_twin(spied["pmf"], spied["lengths"], uni["tables"].cdf,
                          spied["precision"], card, steps)
    toy = library_toy(card, steps)
    seconds = time.perf_counter() - t_phase
    log(f"  phase 15 took {seconds:.1f} s ({card})")
    return dict(launches=uni["launches"], steps_ms=steps,
                universal_indexed=uni["universal_indexed"],
                universal_batched=uni["universal_batched"], power_law=power, priors=priors,
                signal_conv_rel_err=convs, cdf_twin=twin, toy=toy, seconds=seconds)


# Phase 16: the single-program decode and GDN at any width and dtype.
PEAK_FP64_FLOPS = 67e12   # H100 SXM data sheet, fp64 on the tensor cores (DMMA, dense)
WIDE_FILTERS = 320       # 16c: a bmshj2018 wider than K1's 192 channels
LOW_ULPS = 2             # 16b: bfloat16 and float16 within two ulps of the twin's output


def median_ms(fn, reps: int) -> float:
    """Median host milliseconds of ``fn`` (which ends in a host sync) over
    ``reps`` warm calls."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def reserved_bytes() -> int:
    """Device memory the caching allocator holds once its free blocks are
    released: what live tensors and CUDA graphs' private pools keep."""
    if not torch.cuda.is_available():
        return 0
    sync()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def traced_launches(label: str, run) -> dict:
    """``run()`` under ``profile_device``, with every launch count set to 0
    just before it: the K1 and general GDN kernels the card's trace shows
    must equal the wrappers' counts of that same call. Returns the profile."""
    reset_launches()
    prof = profile_device(label, run)
    counted = read_launches()
    if not prof:
        raise AssertionError(f"{label}: the trace saw no device activity")
    seen = {"gdn": prof["count_by_kind"]["K1"],
            "gdn_general": prof["count_by_kind"]["gdn_general"]}
    log(f"  traced kernels of {label}: {seen}")
    if seen != {k: counted[k] for k in seen}:
        raise AssertionError(f"{label}: the trace shows {seen}, the wrappers {counted}")
    return prof


def phase_jit_decode(card: str, reps: int) -> dict:
    """16a: ``decompress_batch_jit`` of the checkpoint's blobs of the 8
    structured 768x512 images against ``decompress_batch``."""
    from compression_tpu_torch.models import bmshj2018

    images = structured_images()
    codec = bmshj2018.Codec(ckpt_model(), device=DEVICE)
    host_blobs = codec.compress_batch(images)
    device_blobs = codec.compress_batch(images, coder="device")
    want = codec.decompress_batch(host_blobs)
    before = reserved_bytes()
    t0 = time.perf_counter()
    cold = codec.decompress_batch_jit(host_blobs)  # builds the program, captures its graphs
    cold_ms = 1e3 * (time.perf_counter() - t0)
    program_mib = (reserved_bytes() - before) / 2 ** 20
    reset_launches()
    warm = codec.decompress_batch_jit(host_blobs)
    sync()
    launches = read_launches()
    keys = list(codec._jit_decoders)
    if not (np.array_equal(cold, want) and np.array_equal(warm, want)):
        raise AssertionError("16a: the jit decode differs from decompress_batch")
    if len(keys) != 1:
        raise AssertionError(f"16a: the second call built a program of its own: {keys}")
    if launches != launches_of(gdn=3):
        raise AssertionError(f"16a: a warm jit decode launched {launches}, expected K1 3")
    single = codec.decompress_batch_jit(host_blobs[:1])
    if not np.array_equal(single[0], want[0]):
        raise AssertionError("16a: the batch-1 jit decode differs from row 0 of the batch of 8")
    other = structured_image(WIDTH, HEIGHT)[None]
    other_blobs = codec.compress_batch(other)
    programs = len(codec._jit_decoders)
    if not np.array_equal(codec.decompress_batch_jit(other_blobs),
                          codec.decompress_batch(other_blobs)):
        raise AssertionError(f"16a: the jit decode of a {WIDTH}x{HEIGHT} image differs")
    if len(codec._jit_decoders) != programs + 1:
        raise AssertionError(f"16a: the {WIDTH}x{HEIGHT} image got no program of its own: "
                             f"{list(codec._jit_decoders)}")
    reset_launches()
    device_out = codec.decompress_batch_jit(device_blobs)
    sync()
    device_launches = read_launches()
    if device_launches != launches_of(gdn=3, dec=1):
        raise AssertionError(f"16a: device-coded blobs launched {device_launches}, "
                             "expected K2 1 and K1 3")
    if not np.array_equal(device_out, codec.decompress_batch(device_blobs)):
        raise AssertionError("16a: the device-coded jit decode differs from decompress_batch")
    jit_ms = [median_ms(lambda: codec.decompress_batch_jit(host_blobs), reps)]
    batch_ms = [median_ms(lambda: codec.decompress_batch(host_blobs), reps)]
    batch_ms.append(median_ms(lambda: codec.decompress_batch(host_blobs), reps))
    jit_ms.append(median_ms(lambda: codec.decompress_batch_jit(host_blobs), reps))
    log(f"16a jit decode ({card}), {BATCH}x{HEIGHT}x{WIDTH} from the checkpoint: byte-equal "
        f"to decompress_batch (cold {cold_ms:.1f} ms, then a cache hit, keys {keys}; the "
        f"program keeps {program_mib:.1f} MiB of device memory); batch 1 "
        f"== row 0; a {WIDTH}x{HEIGHT} image a new key, equal; device-coded blobs to K2, equal "
        f"(launches {device_launches}); a warm jit decode launches {launches}; warm ms "
        f"(median of {reps}, jit, batch, batch, jit): decompress_batch_jit "
        f"{jit_ms[0]:.3f} / {jit_ms[1]:.3f}, decompress_batch {batch_ms[0]:.3f} / "
        f"{batch_ms[1]:.3f}")
    profiles = {
        "jit": traced_launches(f"16a decompress_batch_jit of {BATCH}",
                               lambda: codec.decompress_batch_jit(host_blobs)),
        "batch": profile_device(f"16a decompress_batch of {BATCH}",
                                lambda: codec.decompress_batch(host_blobs)),
    }
    return dict(launches=launches, device_launches=device_launches, cold_ms=cold_ms,
                program_mib=program_mib, jit_ms=jit_ms, batch_ms=batch_ms,
                profile={k: {kk: p.get(kk) for kk in ("wall_ms", "busy_ms", "idle")}
                         for k, p in profiles.items()})


def general_bounds_ms(rows: int, c: int, dtype) -> dict:
    """Least times of one general-kernel call: x read and y written once,
    beta and gamma read once, over the HBM rate; and its rows x C x C
    multiply-adds on the tensor cores, as the kernel takes them within each
    tolerance (:data:`GENERAL_OPS_UNITS`): float32 as the three TF32
    products of 3xTF32 over the TF32 rate, float64 over the FP64 tensor
    cores' rate, bfloat16 and float16 as one TF32 product (x*x squared in
    float and rounded to TF32, gamma exact in TF32) over the TF32 rate."""
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * rows * c + c * c + c) * size
    flops = 2 * rows * c * c
    ops_ms = 1e3 * {torch.float32: 3 * flops / PEAK_TF32_FLOPS,
                    torch.float64: flops / PEAK_FP64_FLOPS}.get(dtype, flops / PEAK_TF32_FLOPS)
    return {"bytes": 1e3 * nbytes / PEAK_HBM_BYTES, "ops": ops_ms}


GENERAL_OPS_UNITS = {torch.float32: "3xTF32", torch.float64: "FP64 tensor cores",
                     torch.bfloat16: "1xTF32", torch.float16: "1xTF32"}
SIGNIFICANT_BITS = {torch.bfloat16: 8, torch.float16: 11}


def general_close(got, want) -> float:
    """The general kernel against its twin: float32 within K1's 2e-5,
    float64 within 1e-12, bfloat16 and float16 within two ulps of the twin's
    output (below the smallest normal, the subnormal spacing). Returns the
    largest absolute error."""
    if want.dtype in SIGNIFICANT_BITS:
        g, w = got.double(), want.double()
        ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(torch.finfo(want.dtype).tiny)))
                         - (SIGNIFICANT_BITS[want.dtype] - 1))
        worst = ((g - w).abs() / ulp).max().item()
        if worst > LOW_ULPS:
            raise AssertionError(f"16b: {want.dtype} off its twin by {worst} ulps")
    else:
        tol = 1e-12 if want.dtype == torch.float64 else GDN_TOL
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    return (got.double() - want.double()).abs().max().item()


def time_general(label: str, x, beta, gamma, inverse: bool, reps: int) -> dict:
    """One general-kernel call against its twin: its error, the ms of the
    twin, the kernel and the library yardstick (``torch.addmm`` plus the
    elementwise ops in x's dtype, as K1's; never called by the port), in
    turns (twin, kernel, yardstick, kernel, twin), and the bounds."""
    from compression_tpu_torch.layers.gdn_kernel import fused_gdn_general, fused_gdn_reference

    def library(x, beta, gamma, inverse):
        norm = torch.addmm(beta, x * x, gamma)
        return x * (norm.sqrt_() if inverse else norm.rsqrt_())

    rows, c = x.numel() // x.shape[-1], x.shape[-1]
    with torch.inference_mode():
        got = fused_gdn_general(x, beta, gamma, inverse)
        want = fused_gdn_reference(x, beta, gamma, inverse)
        sync()
        err = general_close(got, want)
        runs = {"plain_ms": [], "ms": [], "library_ms": []}
        for key, fn in (("plain_ms", fused_gdn_reference), ("ms", fused_gdn_general),
                        ("library_ms", library), ("ms", fused_gdn_general),
                        ("plain_ms", fused_gdn_reference)):
            runs[key].append(cuda_ms(lambda: fn(x, beta, gamma, inverse), reps))
    times = {k: sum(v) / len(v) for k, v in runs.items()}
    bounds = general_bounds_ms(rows, c, x.dtype)
    bound = max(bounds.values())
    units = GENERAL_OPS_UNITS[x.dtype]
    log(f"  16b {label:28s} rows {rows:7d} C {c}: max_abs_err {err:.3e}; kernel "
        f"{times['ms']:.4f} ms, twin {times['plain_ms']:.4f} ms, addmm + elementwise "
        f"{times['library_ms']:.4f} ms; bound {bounds['bytes']:.4f} ms (bytes), "
        f"{bounds['ops']:.4f} ms ({units}); {100 * bound / times['ms']:.1f}% of bound "
        f"({'bytes' if bounds['bytes'] >= bounds['ops'] else units})")
    return dict(max_abs_err=err, bound_ms=bound, bytes_ms=bounds["bytes"],
                ops_ms=bounds["ops"], ops_units=units, **times)


def phase_general_kernel(model, reps: int) -> dict:
    """16b: the general GDN kernel against its twin on the card, at the rows
    of the first GDN layer of the batch (8 x 384 x 256): float32 at C = 224,
    256 and 320, float64 at C = 256, bfloat16 and float16 at C = 192; and at
    the six calls of the 320-filter model's round trip (16c), whose sum is
    its line in the kernels JSON."""
    from compression_tpu_torch.layers import parameters

    gen = torch.Generator(device=DEVICE).manual_seed(16)
    rows = BATCH * (HEIGHT // 2) * (WIDTH // 2)

    def inputs(n, c, dtype):
        x = torch.randn(n, c, device=DEVICE, generator=gen).to(dtype)
        beta = (torch.rand(c, device=DEVICE, generator=gen) * 1.5 + 0.5).to(dtype)
        gamma = (torch.rand(c, c, device=DEVICE, generator=gen) * (0.2 / c)
                 + 0.05 * torch.eye(c, device=DEVICE)).to(dtype)
        return x, beta, gamma

    checks = {}
    for c, dtype in ((224, torch.float32), (256, torch.float32), (320, torch.float32),
                     (256, torch.float64), (192, torch.bfloat16), (192, torch.float16)):
        for inverse in (False, True):
            label = f"{str(dtype).split('.')[-1]} C={c} {'inverse' if inverse else 'forward'}"
            checks[label] = time_general(label, *inputs(rows, c, dtype), inverse, reps)
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, bytes_ms=0.0,
                  ops_ms=0.0)
    max_err = 0.0
    for label, n, inverse, (tname, lname) in gdn_shapes():
        layer = getattr(getattr(model, tname), lname)
        with torch.no_grad():
            beta = parameters.nonneg_apply(layer.beta, layer.beta_min).to(DEVICE)
            gamma = parameters.nonneg_apply(layer.gamma, 0.0).to(DEVICE)
        x = torch.randn(n, gamma.shape[0], device=DEVICE, generator=gen)
        r = time_general(f"path {label}", x, beta, gamma, inverse, reps)
        max_err = max(max_err, r["max_abs_err"])
        for k in totals:
            totals[k] += r[k]
    bound_by = "bytes" if totals["bytes_ms"] >= totals["ops_ms"] else "operations"
    log(f"16b general GDN kernel over the six calls of the {WIDE_FILTERS}-filter round trip: "
        f"kernel {totals['ms']:.4f} ms, twin {totals['plain_ms']:.4f} ms, addmm + elementwise "
        f"{totals['library_ms']:.4f} ms; bound {totals['bound_ms']:.4f} ms (bytes "
        f"{totals['bytes_ms']:.4f}, 3xTF32 {totals['ops_ms']:.4f}), "
        f"{100 * totals['bound_ms'] / totals['ms']:.1f}% of bound; max_abs_err {max_err:.3e}")
    return dict(max_abs_err=max_err, bound_by=bound_by, checks=checks,
                **{k: totals[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")})


def phase_wide_gdn(card: str, reps: int) -> dict:
    """16c: a seeded bmshj2018 at 320 filters (GDN through the general
    kernel): a quantized step on the card against the CPU, the launches of
    a training step, the codec's round trip of the 8 images, and its jit
    decode."""
    from compression_tpu_torch.models import bmshj2018

    cfg = bmshj2018.Config(num_filters=WIDE_FILTERS)
    cpu_err = check_step_against_cpu(lambda: bmshj2018.BMSHJ2018Model(cfg, seed=0),
                                     bmshj2018.make_loss_fn, f"16c {WIDE_FILTERS} filters")
    train_launches = count_step_launches(bmshj2018.BMSHJ2018Model(cfg, seed=1),
                                         bmshj2018.make_loss_fn, "16c", gdn=0, gdn_general=6)
    model = bmshj2018.BMSHJ2018Model(cfg, seed=0)
    codec = bmshj2018.Codec(model, device=DEVICE)
    images = structured_images()
    blobs, out, host_launches = phase_codec(
        codec, images, bmshj2018, label=f"16c codec at {WIDE_FILTERS} filters ({card})",
        min_psnr=None, cpu_check=False, gdn=0, gdn_general=6)
    codec.decompress_batch_jit(blobs)
    reset_launches()
    jit_out = codec.decompress_batch_jit(blobs)
    sync()
    jit_launches = read_launches()
    if not np.array_equal(jit_out, out) or jit_launches != launches_of(general=3):
        raise AssertionError(f"16c: the jit decode differs or launched {jit_launches}")
    traced_launches(f"16c decompress_batch_jit at {WIDE_FILTERS} filters",
                    lambda: codec.decompress_batch_jit(blobs))
    log(f"  16c jit decode at {WIDE_FILTERS} filters: equal to decompress_batch; a warm call "
        f"launches {jit_launches}")
    return dict(cpu_max_rel_err=cpu_err, train_launches=train_launches,
                host_launches=host_launches, jit_launches=jit_launches, model=model)


def phase_jit_and_any_gdn(card: str, reps: int) -> dict:
    """16: the single-program decode (16a), the general GDN kernel (16b), a
    bmshj2018 at 320 filters (16c)."""
    t_phase = time.perf_counter()
    jit = phase_jit_decode(card, reps)
    wide = phase_wide_gdn(card, reps)
    general = phase_general_kernel(wide.pop("model"), reps)
    seconds = time.perf_counter() - t_phase
    log(f"  phase 16 took {seconds:.1f} s ({card})")
    return dict(jit=jit, wide=wide, general=general, seconds=seconds)


# -- phase 17: the multi-device layer on shards of the one card -----------------

DP_REPS = 5               # 17a: timed data-parallel steps after two warm-up steps
HIFIC_DP_REPS = 2         # 17a: timed HiFiC joint DP steps after the first
SPATIAL_H, SPATIAL_W = 3072, 2048  # 17c: bmshj2018's giant image (H sharded)
SHARDS = 4                # shards of the one card in each multi-shard mesh
DP_RTOL, DP_ATOL = 1e-5, 1e-6      # tests/test_parallel.py's tolerance
SPATIAL_TOL = 1e-4        # 17c: sharded against dense, of the largest entry


def card_mesh(n: int):
    """``n`` shards of the one card (or of the CPU in a rehearsal)."""
    from compression_tpu_torch.parallel.data_parallel import Mesh

    dev = torch.device("cuda", 0) if DEVICE == "cuda" else torch.device("cpu")
    return Mesh((dev,) * n)


def max_rel_err(got, want) -> float:
    """The largest difference over the largest entry of ``want``."""
    want = want.detach().float()
    return float((got.detach().float().to(want.device) - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def mean_of_shards_step(model, optimizer, loss_fn, shards) -> torch.Tensor:
    """17a's reference, from the one-device pieces: the loss and gradients
    of each shard in turn, their sums over the count, one update."""
    sums, losses = None, []
    for x in shards:
        loss, _ = loss_fn(model, x, None)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        sums = list(grads) if sums is None else [a + g for a, g in zip(sums, grads)]
        losses.append(loss.detach())
    for p, g in zip(model.parameters(), sums):
        p.grad = g / len(shards)
    optimizer.step()
    return torch.stack(losses).mean()


def params_err(a, b, rtol: float, atol: float, label: str, grads: bool = False) -> float:
    """Raises unless every parameter of ``a`` (with ``grads``, the gradient
    its step left on it) is within ``rtol``/``atol`` of ``b``'s; returns the
    largest |a - b| - rtol |b| found."""
    worst = -1.0
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        if grads:
            p, q = p.grad, q.grad
        excess = float(((p - q).abs() - rtol * q.abs()).max().detach())
        worst = max(worst, excess)
        if excess > atol:
            raise AssertionError(f"{label}: {name} off by {excess:.3g} beyond rtol {rtol}")
    return worst


def timed_steps(run, reps: int) -> float:
    """Milliseconds a call of ``run`` over ``reps`` calls (host clock, each
    ending in a sync)."""
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    sync()
    return 1e3 * (time.perf_counter() - t0) / reps


def phase_dp_training(card: str) -> dict:
    """17a: data-parallel training on meshes of 1 and SHARDS shards of the
    card: bmshj2018 from the checkpoint at 8x256x256 (gated against the
    one-device pieces), then HiFiC hific-mi's joint step."""
    import copy

    from compression_tpu_torch.models import bmshj2018, common, hific
    from compression_tpu_torch.models.hific import archs
    from compression_tpu_torch.parallel import make_dp_step, shard_batch
    from compression_tpu_torch.parallel.data_parallel import shard_generators

    dev = card_mesh(1).devices[0]
    model0 = ckpt_model().to(dev)
    batch = torch.from_numpy(next(train_batches(TRAIN_BATCH)))
    tcfg = common.TrainConfig()
    quantized = lambda m, x, g: bmshj2018.make_loss_fn(m, training=False)(x, g)  # noqa: E731
    out = {"launches": {}}
    mesh1, meshn = card_mesh(1), card_mesh(SHARDS)

    # The SHARDS-shard step against the mean of per-shard gradients.
    dp, ref = copy.deepcopy(model0), copy.deepcopy(model0)
    step = make_dp_step(quantized, common.make_optimizer(dp, tcfg), mesh=meshn)
    reset_launches()
    metrics = step(dp, batch, shard_generators(0, meshn))
    sync()
    out["launches"][f"quantized step, {SHARDS} shards"] = read_launches()
    want = mean_of_shards_step(ref, common.make_optimizer(ref, tcfg), quantized,
                               shard_batch(batch, meshn))
    loss_err = abs(metrics["loss"].item() - want.item()) / abs(want.item())
    if loss_err > DP_RTOL:
        raise AssertionError(f"17a: DP loss {metrics['loss'].item()} vs {want.item()}")
    # Adam's first update is about lr sign(g): the gradients themselves are
    # what shows a sum of shards taken for their mean.
    out["dp_grad_excess"] = params_err(dp, ref, DP_RTOL, DP_ATOL, "17a DP gradients",
                                       grads=True)
    out["dp_param_excess"] = params_err(dp, ref, DP_RTOL, DP_ATOL, "17a DP step")
    # A mesh of one against train_step.
    one, ts = copy.deepcopy(model0), copy.deepcopy(model0)
    step1 = make_dp_step(quantized, common.make_optimizer(one, tcfg), mesh=mesh1)
    got1 = step1(one, batch, shard_generators(0, mesh1))["loss"].item()
    want1, _ = common.train_step(ts, common.make_optimizer(ts, tcfg),
                                 bmshj2018.make_loss_fn(ts, training=False), batch.to(dev),
                                 None, common.lr_schedule(tcfg))
    if abs(got1 - want1.item()) > 1e-6 * abs(want1.item()):
        raise AssertionError(f"17a: mesh of one {got1} vs train_step {want1.item()}")
    out["one_grad_excess"] = params_err(one, ts, 1e-6, 0.0, "17a mesh of one gradients",
                                        grads=True)
    out["one_param_excess"] = params_err(one, ts, 1e-6, 0.0, "17a mesh of one")
    log(f"  17a bmshj2018 DP, {SHARDS} shards of the card: loss {metrics['loss'].item():.6f}"
        f" vs mean-of-shards {want.item():.6f} (rel {loss_err:.2e}), gradients and params "
        f"within rtol {DP_RTOL} (+{out['dp_grad_excess']:.2e}, "
        f"+{out['dp_param_excess']:.2e}); mesh of one vs train_step: gradients and params "
        f"within rtol 1e-6 (+{out['one_grad_excess']:.2e}, +{out['one_param_excess']:.2e})")
    del dp, ref, one, ts

    # Training steps with noise: ms a step, launches, device busy and idle.
    for mesh in (mesh1, meshn):
        n = mesh.size
        model = copy.deepcopy(model0)
        loss_fn = lambda m, x, g: bmshj2018.make_loss_fn(m)(x, g)  # noqa: E731
        step = make_dp_step(loss_fn, common.make_optimizer(model, tcfg), mesh=mesh)
        gens = shard_generators(1, mesh)
        run = lambda: step(model, batch, gens)  # noqa: E731
        run()
        run()
        reset_launches()
        run()
        sync()
        launches = read_launches()
        if launches["gdn"] != 6 * n or launches["gdn_general"]:
            raise AssertionError(f"17a: a {n}-shard step launched {launches}")
        out["launches"][f"train step, {n} shard(s)"] = launches
        ms = timed_steps(run, DP_REPS)
        prof = profile_device(f"bmshj2018 DP train step, {n} shard(s) of the card", run,
                              steps=2)
        out[f"bmshj2018_{n}"] = dict(step_ms=ms, busy_ms=prof.get("busy_ms"),
                                     idle=prof.get("idle"), wall_ms=prof.get("wall_ms"))
        log(f"  17a bmshj2018 train step, {n} shard(s): {ms:.2f} ms a step, K1 "
            f"{launches['gdn']} a step ({card})")
        del model, step

    # HiFiC hific-mi's joint DP step: finite losses, the spectral-norm
    # state one device reaches in one step.
    cfg = hific_config()
    g0 = hific.HificModel(cfg, seed=0).to(dev)
    d0 = archs.Discriminator(cfg.num_latents, seed=1).to(dev)
    lp = synthetic_lpips().to(dev)
    g, d = copy.deepcopy(g0), copy.deepcopy(d0)
    step, _, _ = hific.make_train_steps(g, d, lp, cfg)
    step(batch.to(dev), torch.Generator(dev).manual_seed(0))
    want_state = {k: v.clone() for k, v in d.named_buffers()}
    del g, d, step
    for mesh in (mesh1, meshn):
        n = mesh.size
        g, d = copy.deepcopy(g0), copy.deepcopy(d0)
        step, _, _ = hific.make_train_steps(g, d, lp, cfg, mesh=mesh)
        gens = shard_generators(0, mesh)
        reset_launches()
        metrics = step(batch, gens)
        sync()
        out["launches"][f"hific joint step, {n} shard(s)"] = read_launches()
        if not all(bool(torch.isfinite(metrics[k])) for k in ("g_loss", "d_loss")):
            raise AssertionError(f"17a: HiFiC DP losses {metrics['g_loss']}, "
                                 f"{metrics['d_loss']}")
        state_err = max(max_rel_err(v, want_state[k]) for k, v in d.named_buffers())
        if state_err > 1e-6:
            raise AssertionError(f"17a: HiFiC DP spectral-norm state off by {state_err}")
        ms = timed_steps(lambda: step(batch, gens), HIFIC_DP_REPS)
        out[f"hific_{n}"] = dict(step_ms=ms, g_loss=metrics["g_loss"].item(),
                                 d_loss=metrics["d_loss"].item(), state_err=state_err)
        log(f"  17a hific-mi joint DP step, {n} shard(s): {ms:.2f} ms a step, g_loss "
            f"{metrics['g_loss'].item():.4f} d_loss {metrics['d_loss'].item():.4f}, "
            f"spectral-norm state vs one device {state_err:.2e} ({card})")
        del g, d, step
    return out


def phase_spatial(card: str) -> dict:
    """17c: SpatialCodecs on meshes of the card: bmshj2018 from the
    checkpoint on one SPATIAL_H x SPATIAL_W image at 1 and SHARDS shards
    against the dense Codec; the other families untrained from the seed on
    one HEIGHT x WIDTH image at SHARDS shards."""
    from compression_tpu_torch.models import bls2017, bmshj2018, hific, mbt2018, ms2020
    from compression_tpu_torch.parallel.spatial import gather_rows
    from compression_tpu_torch.util.image import psnr_np

    out = {"launches": {}}
    model = ckpt_model()
    image = structured_image(SPATIAL_H, SPATIAL_W)
    dense = bmshj2018.Codec(model, device=card_mesh(1).devices[0])
    dense_blob = dense.compress(image)
    dense_ms = timed_ms(lambda: dense.decompress(dense_blob))
    blobs = {}
    for n in (1, SHARDS):
        mesh = card_mesh(n)
        sc = bmshj2018.SpatialCodec(model, mesh)
        reset_launches()
        t0 = time.perf_counter()
        blob = sc.compress(image)
        sync()
        c_ms = 1e3 * (time.perf_counter() - t0)
        out["launches"][f"bmshj2018 compress, {n} shard(s)"] = c_launch = read_launches()
        reset_launches()
        t0 = time.perf_counter()
        decoded = sc.decompress(blob)
        sync()
        d_ms = 1e3 * (time.perf_counter() - t0)
        out["launches"][f"bmshj2018 decompress, {n} shard(s)"] = d_launch = read_launches()
        if c_launch["gdn"] != 3 * n or d_launch["gdn"] != 3 * n:
            raise AssertionError(f"17c: K1 launches {c_launch}, {d_launch} at {n} shards")
        if not np.array_equal(sc.decompress(blob), decoded):
            raise AssertionError(f"17c: a second decode differs at {n} shards")
        psnr = float(psnr_np(decoded, image))
        if decoded.shape != image.shape or psnr <= 25.0:
            raise AssertionError(f"17c: round trip {decoded.shape}, PSNR {psnr:.2f} dB")
        warm_c = timed_ms(lambda: sc.compress(image))
        warm_d = timed_ms(lambda: sc.decompress(blob))
        prof = profile_device(f"bmshj2018 SpatialCodec compress {SPATIAL_H}x{SPATIAL_W}, "
                              f"{n} shard(s)", lambda: sc.compress(image), top=4)
        # The sharded y, z, sigma and x_hat against the dense model's.
        x = torch.from_numpy(image[None]).to(mesh.devices[0]).to(torch.float32) / 255.0
        with torch.inference_mode():
            y, z = bmshj2018.sharded_encode_latents(sc.model, x, mesh)
            y_d, z_d = sc.model.encode_latents(x)
            z_hat = dense._z_symbols(z_d)[1]
            y_hat = torch.round(y_d)
            errs = dict(
                y=max_rel_err(gather_rows(y), y_d), z=max_rel_err(gather_rows(z), z_d),
                sigma=max_rel_err(gather_rows(bmshj2018.sharded_sigma(sc.model, z_hat, mesh)),
                                  sc.model.sigma_from_zhat(z_hat)),
                x_hat=max_rel_err(gather_rows(bmshj2018.sharded_synthesize(
                    sc.model, y_hat, mesh)), sc.model.synthesize(y_hat)))
        if max(errs.values()) > SPATIAL_TOL:
            raise AssertionError(f"17c: sharded against dense at {n} shards: {errs}")
        blobs[n] = blob
        out[f"bmshj2018_{n}"] = dict(compress_ms=c_ms, decompress_ms=d_ms,
                                     warm_compress_ms=warm_c, warm_decompress_ms=warm_d,
                                     psnr=psnr, bytes=len(blob), errs=errs,
                                     compress_busy_ms=prof.get("busy_ms"),
                                     compress_idle=prof.get("idle"),
                                     compress_by_kind_ms=prof.get("by_kind_ms"))
        log(f"  17c bmshj2018 SpatialCodec {SPATIAL_H}x{SPATIAL_W}, {n} shard(s): compress "
            f"{c_ms:.1f} ms (warm {warm_c:.1f}), decompress {d_ms:.1f} ms (warm "
            f"{warm_d:.1f}); K1 {c_launch['gdn']} + {d_launch['gdn']}; PSNR {psnr:.2f} dB, "
            f"{len(blob)} bytes; sharded vs dense {errs} ({card})")
    out["blobs_equal"] = {"1_vs_n": blobs[1] == blobs[SHARDS],
                          "1_vs_dense": blobs[1] == dense_blob,
                          "n_vs_dense": blobs[SHARDS] == dense_blob}
    out["dense_decompress_ms"] = dense_ms
    log(f"  17c blobs byte-equal (reported, not held): {out['blobs_equal']}; dense "
        f"decompress {dense_ms:.1f} ms")
    del dense

    image = structured_image(HEIGHT, WIDTH)
    x = torch.from_numpy(image[None]).to(card_mesh(1).devices[0]).to(torch.float32) / 255.0
    mesh = card_mesh(SHARDS)
    fams = (("bls2017", bls2017, bls2017.BLS2017Model(bls2017.Config(), seed=0)),
            ("mbt2018-mean", mbt2018, mbt2018.MBT2018Model(mbt2018_config(), seed=0)),
            ("ms2020-cc10", ms2020, ms2020.MS2020Model(ms2020_config(), seed=0)),
            ("hific-mi", hific, hific.HificModel(hific_config(), seed=0)))
    for name, mod, fam_model in fams:
        sc = mod.SpatialCodec(fam_model, mesh)
        # The first call pays cuDNN's algorithm search for the shard shapes;
        # the second is the one timed and counted.
        t0 = time.perf_counter()
        sc.decompress(sc.compress(image))
        sync()
        first_ms = 1e3 * (time.perf_counter() - t0)
        reset_launches()
        t0 = time.perf_counter()
        decoded = sc.decompress(sc.compress(image))
        sync()
        ms = 1e3 * (time.perf_counter() - t0)
        out["launches"][f"{name} round trip, {SHARDS} shards"] = launches = read_launches()
        if decoded.shape != image.shape:
            raise AssertionError(f"17c: {name} decoded {decoded.shape}")
        with torch.inference_mode():
            if mod is bls2017:
                y, y_d = bls2017.sharded_analyze(sc.model, x, mesh), sc.model.analysis(x)
            else:
                y = mod.sharded_encode_latents(sc.model, x, mesh)[0]
                y_d = sc.model.encode_latents(x)[0]
            err = max_rel_err(gather_rows(y), y_d)
        if err > SPATIAL_TOL:
            raise AssertionError(f"17c: {name} sharded y off the dense by {err}")
        out[name] = dict(round_trip_ms=ms, first_round_trip_ms=first_ms, y_err=err,
                         psnr=float(psnr_np(decoded, image)))
        log(f"  17c {name} SpatialCodec {HEIGHT}x{WIDTH}, {SHARDS} shards: round trip "
            f"{ms:.1f} ms (first call {first_ms:.1f}), K1 {launches['gdn']}, y vs dense "
            f"{err:.2e} ({card})")
    return out


def phase_charm_sharded(card: str) -> dict:
    """17d: ShardedCharmCodec over meshes of 1 and SHARDS shards of the
    card, ms2020-cc10 from the seed on the 8 structured images, both
    coders, byte-equal to Codec.decompress_batch; and a ragged 7."""
    from compression_tpu_torch.models import ms2020
    from compression_tpu_torch.parallel import ShardedCharmCodec

    out = {"launches": {}}
    model = ms2020.MS2020Model(ms2020_config(), seed=0)
    codec = ms2020.make_codec(model, card_mesh(1).devices[0])
    images = structured_images()
    sharded = {n: ShardedCharmCodec(model, card_mesh(n)) for n in (1, SHARDS)}
    for coder in ("host", "device"):
        blobs = codec.compress_batch(images, coder=coder)
        ref = codec.decompress_batch(blobs)
        for n, sc in sharded.items():
            reset_launches()
            t0 = time.perf_counter()
            got = sc.decompress_batch(blobs)
            sync()
            ms = 1e3 * (time.perf_counter() - t0)
            out["launches"][f"{coder} coder, {n} shard(s)"] = launches = read_launches()
            if not np.array_equal(got, ref):
                raise AssertionError(f"17d: {coder}-coded decode over {n} shard(s) differs")
            want_k2 = 10 * n if coder == "device" else 0
            if launches["rans_decode"] != want_k2:
                raise AssertionError(f"17d: K2 {launches['rans_decode']}, not {want_k2}")
            out[f"{coder}_{n}"] = dict(decode_ms=ms, launches=launches)
            log(f"  17d ShardedCharmCodec {coder} coder, {n} shard(s): {BATCH} images "
                f"byte-equal, {ms:.1f} ms, K1 {launches['gdn']}, K2 "
                f"{launches['rans_decode']} ({card})")
        if not np.array_equal(sharded[SHARDS].decompress_batch(blobs[:7]), ref[:7]):
            raise AssertionError(f"17d: the ragged batch of 7 ({coder}) differs")
    log("  17d ragged batch of 7 over 4 shards byte-equal with both coders")
    return out


def phase_cli_spatial(card: str) -> dict:
    """17 CLI: ``tfci compress/decompress --spatial 1`` on the card with
    the checkpoint; ``--spatial 2`` exits naming the device count."""
    import shutil
    import tempfile

    from compression_tpu_torch.util.image import psnr_np, read_png, write_png

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="tfci_spatial_"))
    models = tmp / "models"
    models.mkdir()
    shutil.copy(ROOT / "ckpt" / "bmshj2018.msgpack", models / "bmshj2018-hyperprior.msgpack")
    saved = os.environ.get("TPC_MODEL_DIR")
    os.environ["TPC_MODEL_DIR"] = str(models)
    out = {"launches": {}}
    try:
        image = structured_image(HEIGHT, WIDTH)
        png, blob, back = str(tmp / "in.png"), str(tmp / "a.tfci"), str(tmp / "a.png")
        write_png(png, image)
        ms, out["launches"]["compress --spatial 1"], _ = tfci(
            ["compress", "bmshj2018-hyperprior", png, blob, "--spatial", "1"],
            want=launches_of(gdn=3))
        ms_d, out["launches"]["decompress --spatial 1"], _ = tfci(
            ["decompress", blob, back, "--spatial", "1"], want=launches_of(gdn=3))
        psnr = float(psnr_np(read_png(back), image))
        if psnr <= 25.0:
            raise AssertionError(f"17 CLI: --spatial 1 round trip PSNR {psnr:.2f}")
        count = torch.cuda.device_count() if DEVICE == "cuda" else os.cpu_count()
        try:
            tfci(["compress", "bmshj2018-hyperprior", png, str(tmp / "b.tfci"),
                  "--spatial", str(count + 1)])
        except SystemExit as e:
            message = str(e)
        else:
            raise AssertionError(f"17 CLI: --spatial {count + 1} did not exit")
        if f"this process sees {count} device(s)" not in message:
            raise AssertionError(f"17 CLI: --spatial {count + 1} said {message!r}")
        log(f"  17 CLI --spatial 1: compress {ms:.1f} ms, decompress {ms_d:.1f} ms, PSNR "
            f"{psnr:.2f} dB; --spatial {count + 1}: {message!r}")
        out.update(compress_ms=ms, decompress_ms=ms_d, psnr=psnr)
    finally:
        os.environ.pop("TPC_MODEL_DIR", None)
        if saved is not None:
            os.environ["TPC_MODEL_DIR"] = saved
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def phase_multi_device(card: str) -> dict:
    """17: the multi-device layer on shards of the one card: DP training
    (17a), SpatialCodecs (17c), the image-parallel CHARM decode (17d) and
    ``tfci --spatial``."""
    log(f"multi-device layer on {SHARDS} shards of the card (phase 17; {card}):")
    t_phase = time.perf_counter()
    out = dict(dp=phase_dp_training(card), spatial=phase_spatial(card),
               charm=phase_charm_sharded(card), cli=phase_cli_spatial(card))
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 17 took {out['seconds']:.1f} s ({card})")
    return out


def timed_ms(fn) -> float:
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    return 1e3 * (time.perf_counter() - t0)


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
    cli = phase_cli(card)
    library = phase_library(card)
    any_gdn = phase_jit_and_any_gdn(card, args.reps)
    multi = phase_multi_device(card)

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
        **{f"tfci bmshj2018-hyperprior {verb}": counts
           for verb, counts in cli["launches"].items()},
        **{f"tfci {name} {verb} (TPC_TINY_MODELS=1)" if name != "hific-lo"
           else f"tfci {name} {verb} (--allow-random)": counts
           for name, verbs in cli["families"].items() for verb, counts in verbs.items()},
        "library (phase 15a): bmshj2018 analysis of the 8 images": library["launches"],
        "bmshj2018 jit decode (16a, warm)": any_gdn["jit"]["launches"],
        "bmshj2018 jit decode, device-coded blobs (16a)": any_gdn["jit"]["device_launches"],
        **{f"bmshj2018/hific-mi data-parallel {k} (17a)": v
           for k, v in multi["dp"]["launches"].items()},
        **{f"SpatialCodec {k} (17c)": v for k, v in multi["spatial"]["launches"].items()},
        **{f"ms2020 ShardedCharmCodec decode, {k} (17d)": v
           for k, v in multi["charm"]["launches"].items()},
        **{f"tfci bmshj2018-hyperprior {k} (17)": v
           for k, v in multi["cli"]["launches"].items()},
    }
    # Paths of a model outside the registry: GDN at 320 channels (16c).
    wide_paths = {
        f"bmshj2018 at {WIDE_FILTERS} filters codec, host coder": any_gdn["wide"]["host_launches"],
        f"bmshj2018 at {WIDE_FILTERS} filters train step": any_gdn["wide"]["train_launches"],
        f"bmshj2018 at {WIDE_FILTERS} filters jit decode (warm)": any_gdn["wide"]["jit_launches"],
    }
    unread = [path for path, counts in {**paths, **wide_paths}.items()
              if "gdn_general" not in counts]
    ran = {path: counts["gdn_general"] for path, counts in paths.items()
           if counts.get("gdn_general")}
    if unread or ran:
        raise AssertionError(f"the general GDN kernel's count was not read on {unread}, "
                             f"or it ran on a registry path: {ran}")
    # The fused ChannelNorm: read on every path, launched on HiFiC's and on no other.
    every = {**paths, **wide_paths}
    unread = [path for path, counts in every.items() if "channel_norm" not in counts]
    def on_hific(path):  # "bmshj2018/hific-mi data-parallel ..." names both families
        return "hific" in path.replace("bmshj2018/hific-mi", "")

    amiss = {path: counts["channel_norm"] for path, counts in every.items()
             if "channel_norm" in counts and bool(counts["channel_norm"]) != on_hific(path)}
    if unread or amiss:
        raise AssertionError(f"ChannelNorm's kernel count was not read on {unread}, or it ran "
                             f"off HiFiC's paths or not on them: {amiss}")
    # The 3x3 convolution kernel: read on every path, launched on HiFiC's
    # decoding paths alone (its training and sharded paths keep cuDNN).
    unread = [path for path, counts in every.items() if "conv3x3" not in counts]
    amiss = {path: counts["conv3x3"] for path, counts in every.items()
             if counts.get("conv3x3") and not on_hific(path)}
    if unread or amiss:
        raise AssertionError(f"the 3x3 convolution kernel's count was not read on {unread}, "
                             f"or it ran off HiFiC's paths: {amiss}")
    # The up-convolution kernel: read on every path, and launched 4 times a
    # decoded batch where the 3x3 kernel is (HiFiC's dense generator on the
    # card) and on no other path.
    unread = [path for path, counts in every.items() if "conv_up3x3" not in counts]
    amiss = {path: (counts["conv_up3x3"], counts["conv3x3"]) for path, counts in every.items()
             if "conv_up3x3" in counts and (counts["conv_up3x3"] % 4 or
                                            bool(counts["conv_up3x3"]) != bool(counts["conv3x3"]))}
    if unread or amiss:
        raise AssertionError(f"the up-convolution kernel's count was not read on {unread}, or "
                             f"it ran apart from the 3x3 kernel's: {amiss}")

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
        "paths": {path: counts.get("gdn", 0) for path, counts in {**paths, **wide_paths}.items()},
    }, {
        "name": "gdn_general",
        "route": "cuda",
        "source": "compression_tpu_torch/csrc/gdn.cu",
        "replaces": "compression_tpu/layers/pallas/gdn_kernel.py:41",
        "launches": any_gdn["wide"]["host_launches"]["gdn_general"],
        **{k: any_gdn["general"][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms")},
        "train_launches": any_gdn["wide"]["train_launches"]["gdn_general"],
        "paths": {path: counts["gdn_general"] for path, counts in {**paths, **wide_paths}.items()},
        "checks": any_gdn["general"]["checks"],
    }]
    norm = hi["channel_norm"]
    kernels.append({
        "name": "channel_norm",
        "route": "cuda",
        "source": "compression_tpu_torch/csrc/channel_norm.cu",
        "replaces": None,  # the JAX package's ChannelNorm is plain jnp, no TPU kernel
        "launches": hi["launches"]["channel_norm"],  # HiFiC's device-coded round trip
        "per_batch": dict(zip(("compress", "decompress"), hi["norm_launches"])),
        "max_abs_err": max(row["max_abs_err"] for phase in ("encode", "decode")
                           for row in norm[phase]["calls"]),
        "bit_equal": all(row["bit_equal"] for phase in ("encode", "decode")
                         for row in norm[phase]["calls"]),
        **{k: {phase: norm[phase][k] for phase in ("encode", "decode")}
           for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "bound_by": "bytes",
        "train_launches": hi["train"]["launches"]["channel_norm"],
        "paths": {path: counts["channel_norm"] for path, counts in every.items()},
    })
    conv = hi["conv3x3"]
    kernels.append({
        "name": "conv3x3",
        "route": "cuda",
        "source": "compression_tpu_torch/csrc/conv3x3.cu",
        "replaces": None,  # the JAX package leaves its convolutions to XLA
        "launches": hi["launches"]["conv3x3"],  # HiFiC's device-coded round trip
        "per_batch": dict(zip(("compress", "decompress"), hi["conv_launches"])),
        "max_abs_err": max(row["max_abs_err"] for row in conv["calls"]),
        "plain_max_abs_err": max(row["plain_max_abs_err"] for row in conv["calls"]),
        **{k: conv[k] for k in ("ms", "plain_ms", "bound_ms", "fp32_bound_ms", "library_ms")},
        "bound_by": "3xTF32 operations",
        "train_launches": hi["train"]["launches"]["conv3x3"],
        "paths": {path: counts["conv3x3"] for path, counts in every.items()},
    })
    upconv = hi["conv_up3x3"]
    kernels.append({
        "name": "conv_up3x3",
        "route": "cuda",
        "source": "compression_tpu_torch/csrc/conv_up3x3.cu",
        "replaces": None,  # the JAX package leaves its convolutions to XLA
        "launches": hi["launches"]["conv_up3x3"],  # HiFiC's device-coded round trip
        "per_batch": dict(zip(("compress", "decompress"), hi["upconv_launches"])),
        **{k: max(row[k] for row in upconv["calls"])
           for k in ("max_abs_err", "plain_max_abs_err", "signal_conv_max_abs_err")},
        **{k: upconv[k] for k in ("ms", "plain_ms", "signal_conv_ms", "library_ms", "bound_ms",
                                  "fp32_bound_ms")},
        "bound_by": "3xTF32 operations",
        "train_launches": hi["train"]["launches"]["conv_up3x3"],
        "paths": {path: counts["conv_up3x3"] for path, counts in every.items()},
    })
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
            "paths": {path: counts.get(name, 0)
                      for path, counts in {**paths, **wide_paths}.items()},
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
    cli_line = {k: cli[k] for k in ("verb_ms", "processes", "table_ms", "img_per_s",
                                    "overhead_ms", "psnr",
                                    "bpp", "eval_mean", "loss_first5", "loss_last5",
                                    "seconds")}
    library_line = {k: v for k, v in library.items() if k != "launches"}
    jit_line = {**{k: v for k, v in any_gdn["jit"].items() if "launches" not in k},
                "wide_cpu_max_rel_err": any_gdn["wide"]["cpu_max_rel_err"],
                "seconds": any_gdn["seconds"]}
    multi_line = {k: ({kk: vv for kk, vv in v.items() if kk != "launches"}
                      if isinstance(v, dict) else v) for k, v in multi.items()}
    print(json.dumps({"kernels": kernels, "training": train_line, "families": families,
                      "cli": cli_line, "library": library_line, "jit_decode": jit_line,
                      "multi_device": multi_line}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
