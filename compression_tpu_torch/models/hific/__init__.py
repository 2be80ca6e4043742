"""HiFiC, high-fidelity generative image compression (Mentzer et al. 2020):
counterpart of ``compression_tpu/models/hific/``. archs (ChannelNorm, the
Encoder and Generator, the spectral-norm Discriminator), model (the G-side
model, the G and D losses with the rate hinge, the joint G/D step, the
codec with both coders and the module-level ``make_codec`` / ``compress``
/ ``decompress``, the sharded transforms and ``SpatialCodec``), configs
(hific-lo/mi/hi), lpips, train.
"""

from compression_tpu_torch.models.hific.archs import (
    ChannelNorm,
    Discriminator,
    Encoder,
    Generator,
)
from compression_tpu_torch.models.hific.configs import CONFIGS, HificConfig, get_config
from compression_tpu_torch.models.hific.model import (
    Codec,
    HificModel,
    SpatialCodec,
    compress,
    decompress,
    load_model,
    make_codec,
    make_loss_fns,
    make_train_steps,
    sharded_encode,
    sharded_encode_latents,
    sharded_generate,
    sharded_params,
)
from compression_tpu_torch.models.hific.train import train

__all__ = [
    "ChannelNorm",
    "Discriminator",
    "Encoder",
    "Generator",
    "CONFIGS",
    "HificConfig",
    "get_config",
    "HificModel",
    "Codec",
    "compress",
    "decompress",
    "load_model",
    "make_codec",
    "make_loss_fns",
    "make_train_steps",
    "sharded_encode",
    "sharded_encode_latents",
    "sharded_generate",
    "sharded_params",
    "SpatialCodec",
    "train",
]
