"""compression_tpu_torch: the PyTorch/CUDA port of ``compression_tpu``.

The JAX package ``compression_tpu`` is the reference; this package mirrors
its module paths so every counterpart is easy to find:

  ops/             lower_bound / upper_bound, clip, round_st / soft_round,
                   same-padding
  layers/          SignalConv2D, GDN (+ the hand-written CUDA kernel K1 at any
                   width up to 192, and K1 under autograd)
  distributions/   Normal, DeepFactorized, uniform-noise adapters, tails
  entropy_models/  batched (z) and scale-indexed (y) models: training calls
                   and CDF tables
  codec/           native C++ range coder (ctypes) + host API; the device
                   rANS coder (kernels K3/K2) and its NumPy spec
  models/          bmshj2018 scale hyperprior, mbt2018 mean-scale
                   hyperprior and ms2020 CHARM (Codecs with the host and
                   device coders; training), bls2017 factorized prior in
                   its two archs (bls2017, bmshj2018-factorized) and the
                   variable-rate b2018 (one-image Codecs; training),
                   hific/ (HiFiC: ChannelNorm, the Encoder, Generator and
                   spectral-norm Discriminator, LPIPS on VGG16, the joint
                   G/D step with its rate controller, the Codec with both
                   coders, the train driver), codec_base.py (what the
                   codecs share),
                   device_coding.py (blob formats, the device coder's
                   stages), common.py (train loop, data, checkpoints)
  parallel/        double-buffered device/host coding pipeline, staggered
                   decode, CHARM's pipelined batch decode
  util/            PackedTensors, image padding and metrics, numeric, stage timing
  csrc/            CUDA C++ kernels (gdn.cu, rans.cu), built with nvcc at first use
  convert.py       weight bridge to and from the JAX package's flax checkpoints
                   (nested holders, flax nn.Conv kernels, spectral-norm
                   batch_stats)
  entry.py         bmshj2018's full-width loss step with example arguments

It imports torch and numpy, never JAX or the JAX package. Entry points run
on ``device="cuda"`` unless the caller asks for the CPU, and raise when CUDA
is absent; no path falls back to the CPU on its own.
"""

__version__ = "0.1.0"
