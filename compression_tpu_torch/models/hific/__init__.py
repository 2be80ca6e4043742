"""HiFiC, high-fidelity generative image compression (Mentzer et al. 2020):
counterpart of ``compression_tpu/models/hific/``. archs (ChannelNorm, the
Encoder and Generator, the spectral-norm Discriminator), model (the G-side
model, the G and D losses with the rate hinge, the joint G/D step, the
codec with both coders), configs (hific-lo/mi/hi), lpips, train.

Not ported yet: the module-level ``make_codec`` / ``compress`` /
``decompress`` (they sit on the table cache), ``SpatialCodec`` and the
sharded functions.
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
    load_model,
    make_loss_fns,
    make_train_steps,
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
    "load_model",
    "make_loss_fns",
    "make_train_steps",
    "train",
]
