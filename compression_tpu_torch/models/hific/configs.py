"""HiFiC's named configurations (counterpart of
``compression_tpu/models/hific/configs.py``).

Three operating points, hific-lo / -mi / -hi, that differ only in the
target rate. Loss weights follow the paper (Mentzer et al. 2020, Table 4):
MSE on the 0-255 scale times 0.075 * 2^-5, LPIPS 1.0, GAN 0.15. Every
field and default equals the JAX package's; its comments there record why
each value was chosen.
"""

from __future__ import annotations

import dataclasses

__all__ = ["HificConfig", "get_config", "CONFIGS"]


@dataclasses.dataclass(frozen=True)
class HificConfig:
    name: str
    target_rate: float            # bpp the rate controller aims at
    # Rate weights of the bang-bang hinge: lambda_a while the compared rate
    # is above the target (push down), lambda_b at or below it (relax).
    lambda_a: float = 8.0
    lambda_b: float = 2.0 ** -4
    # The hinge compares the rate of the y latents at least this many
    # positions from every edge (the patch's interior), plus z's.
    hinge_boundary_ring: int = 3
    k_mse: float = 0.075 * 2.0 ** -5
    k_lpips: float = 1.0
    k_gan: float = 0.15
    # For the first N steps the GAN term leaves the G loss and D's params
    # and Adam state stay as they are (its spectral-norm state still moves).
    gan_warmup_steps: int = 0
    # Coded-rate probe: with a glob, the hinge compares the coded bpp of
    # these full-resolution images (re-measured every rate_probe_every
    # steps) instead of the patch statistic.
    rate_probe_glob: str = ""
    rate_probe_every: int = 100
    # s > 0: lambda log-proportional in the rate error, lambda_b at
    # rate <= target / 2^s, lambda_a at rate >= target * 2^s.
    hinge_softness: float = 0.0
    # Exponential smoothing of the probe's readings, in [0, 1).
    probe_ema: float = 0.0
    # ki > 0: an integral controller on the host, lambda *= (rate /
    # target)^ki at every probe reading, clipped to [lambda_b, lambda_a *
    # max(k_mse_scale, 1)]; needs rate_probe_glob.
    hinge_integral: float = 0.0
    # Multiplies k_mse (makes up for a missing LPIPS term).
    k_mse_scale: float = 1.0
    num_latents: int = 220
    num_hyperlatents: int = 320
    num_residual_blocks: int = 9
    lr: float = 1e-4
    disc_lr: float = 1e-4

    # What the shared codec stages read (``cfg.model_name``, the blob's
    # model name, and ``cfg.downscale``, the padding multiple: 16 in the
    # encoder times 4 in the hyper-analysis).
    @property
    def model_name(self) -> str:
        return self.name

    @property
    def downscale(self) -> int:
        return 64


CONFIGS = {
    "hific-lo": HificConfig(name="hific-lo", target_rate=0.14),
    "hific-mi": HificConfig(name="hific-mi", target_rate=0.30),
    "hific-hi": HificConfig(name="hific-hi", target_rate=0.45),
}


def get_config(name: str) -> HificConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown HiFiC config {name!r}; have {sorted(CONFIGS)}")
    return CONFIGS[name]
