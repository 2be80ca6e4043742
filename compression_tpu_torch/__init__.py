"""compression_tpu_torch: the PyTorch/CUDA port of ``compression_tpu``.

The JAX package ``compression_tpu`` is the reference; this package mirrors
its module paths so every counterpart is easy to find:

  ops/             lower_bound / upper_bound, clip, perturb_and_apply,
                   round_st / soft_round, same-padding
  layers/          SignalConv1D/2D/3D (reflect padding, channel-separable,
                   RDFT kernels), GDN at any width and dtype (+ the
                   hand-written CUDA kernels: K1, float32 up to 192
                   channels, and fused_gdn_general for the rest, under
                   autograd), Round /
                   SoftRound modules, parameters, initializers
  distributions/   Normal, Logistic, mixtures, DeepFactorized, uniform-noise
                   and round adapters, tails (analytic or by log-CDF)
  entropy_models/  batched, indexed (any number of index dimensions),
                   universal and power-law models: training calls, CDF
                   tables, coding
  codec/           native C++ range coder (ctypes) + host API (incl. the
                   run-length gamma coder) and its fixed-capacity buffer
                   form (buffer_ops.py); the plain torch CDF quantizer
                   for any device; the device rANS coder (kernels K3/K2) and
                   its NumPy spec
  models/          bmshj2018 scale hyperprior (with the single-program
                   decode, decompress_batch_jit), mbt2018 mean-scale
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
                   stages), common.py (train loop, data, checkpoints),
                   toy_sources.py (NTC and ECVQ on 2-D sources)
  parallel/        one-process meshes of devices: data-parallel training
                   (make_mesh, shard_batch, make_dp_step), halo-sharded
                   convolutions and transforms (spatial.py, each family's
                   sharded functions and SpatialCodec), the image-parallel
                   CHARM decode (ShardedCharmCodec); the double-buffered
                   device/host coding pipeline (pipeline_map), staggered
                   decode, CHARM's pipelined batch decode
  util/            PackedTensors, image padding and metrics, numeric, tracing
                   and stage timing, device segments as CUDA graphs
  csrc/            CUDA C++ kernels (gdn.cu, rans.cu), built with nvcc at first use
  convert.py       weight bridge to and from the JAX package's flax checkpoints
                   (nested holders, flax nn.Conv kernels, spectral-norm
                   batch_stats)
  entry.py         bmshj2018's full-width loss step with example arguments;
                   dryrun_multichip, one pass over the multi-device paths
  all_tests.py     post-install smoke run (python -m compression_tpu_torch.all_tests)

It imports torch and numpy, never JAX or the JAX package. Entry points run
on ``device="cuda"`` unless the caller asks for the CPU, and raise when CUDA
is absent; no path falls back to the CPU on its own.

The top level re-exports the public names of ``compression_tpu`` (the
reference's flat ``tfc.*`` namespace).
"""

from compression_tpu_torch.codec.host import (
    pmf_to_quantized_cdf,
    run_length_gamma_decode,
    run_length_gamma_encode,
)
from compression_tpu_torch.distributions.deep_factorized import DeepFactorized
from compression_tpu_torch.distributions.helpers import (
    estimate_tails,
    lower_tail,
    quantization_offset,
    upper_tail,
)
from compression_tpu_torch.distributions.round_adapters import (
    NoisyRoundAdapter,
    NoisyRoundedDeepFactorized,
    NoisyRoundedNormal,
    NoisySoftRoundAdapter,
    NoisySoftRoundedDeepFactorized,
    NoisySoftRoundedNormal,
    RoundAdapter,
    SoftRoundAdapter,
)
from compression_tpu_torch.distributions.uniform_noise import (
    NoisyDeepFactorized,
    NoisyLogistic,
    NoisyLogisticMixture,
    NoisyMixtureSameFamily,
    NoisyNormal,
    NoisyNormalMixture,
    UniformNoiseAdapter,
)
from compression_tpu_torch.entropy_models import (
    ContinuousBatchedEntropyModel,
    ContinuousIndexedEntropyModel,
    EntropyBottleneck,
    GaussianConditional,
    LocationScaleIndexedEntropyModel,
    PowerLawEntropyModel,
    UniversalBatchedEntropyModel,
    UniversalIndexedEntropyModel,
)
from compression_tpu_torch.layers import (
    GDN,
    GDNParameter,
    Parameter,
    RDFTParameter,
    Round,
    SignalConv1D,
    SignalConv2D,
    SignalConv3D,
    SoftRound,
    SoftRoundConditionalMean,
    identity_kernel_init,
    nonneg_apply,
    nonneg_init,
    rdft_apply,
    rdft_basis,
    rdft_init,
)
from compression_tpu_torch.ops.math_ops import (
    lower_bound,
    perturb_and_apply,
    upper_bound,
)
from compression_tpu_torch.ops.padding_ops import same_padding_for_kernel
from compression_tpu_torch.ops.round_ops import (
    round_st,
    soft_round,
    soft_round_conditional_mean,
    soft_round_inverse,
)
from compression_tpu_torch.util import PackedTensors

# The reference's tfc.IdentityInitializer; the functional spelling is
# canonical, as in the JAX package.
IdentityInitializer = identity_kernel_init

__version__ = "0.1.0"
