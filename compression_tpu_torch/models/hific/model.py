"""HiFiC, the generative image codec (counterpart of
``compression_tpu/models/hific/model.py``): the G-side model, the G and D
losses with the rate controller's laws, the joint G/D step, and the codec
with both coders.

  Encoder -> y -> mean-scale hyperprior (mbt2018's hyper pair) -> y_hat
  Generator(y_hat) -> x_hat
  Discriminator(x or x_hat, conditioned on y_hat) -> patch logits

G loss: ``lambda * bpp + k_mse * k_mse_scale * MSE_255 + k_lpips * LPIPS
+ k_gan * gan_scale * softplus(-D(x_hat))``, lambda from the bang-bang
hinge (``lambda_a`` above the target rate, ``lambda_b`` at or below), its
log-proportional form (``hinge_softness``) or the caller's value
(``lam_override >= 0``, the integral controller of ``train``). D loss: the
non-saturating logistic loss on the real batch, then on x_hat.

Training forward, as the JAX package's: the hyper-synthesis reads the
noisy z that the side model returns, the generator reads y rounded around
mu, and the interior rate draws a third noise of its own. The noise comes
from one generator, drawn in the order z, y, interior.

Not ported yet: ``SpatialCodec`` and the sharded functions, the
data-parallel step (``num_devices > 1`` raises), and the module-level
``make_codec`` / ``compress`` / ``decompress`` (they sit on the table
cache).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from compression_tpu_torch.distributions.uniform_noise import NoisyNormal
from compression_tpu_torch.entropy_models import (
    ContinuousBatchedEntropyModel,
    LocationScaleIndexedEntropyModel,
)
from compression_tpu_torch.layers.priors import DeepFactorizedPrior
from compression_tpu_torch.models import mbt2018
from compression_tpu_torch.models.hific import archs
from compression_tpu_torch.models.hific.configs import HificConfig
from compression_tpu_torch.ops.math_ops import clip

__all__ = ["HificModel", "make_loss_fns", "make_train_steps", "Codec", "load_model"]

# range_coder_precision of both product coders: no coded symbol costs more.
_CODER_PRECISION = 12.0


class HificModel(nn.Module):
    """Encoder, generator, mbt2018's hyper pair at ``num_hyperlatents``
    filters, and the factorized hyperprior (the G side; D is separate).

    Submodule and parameter names follow the JAX package's param tree; the
    initial weights are drawn from one generator seeded with ``seed``,
    layer by layer.
    """

    def __init__(self, config: HificConfig, seed: int = 0):
        super().__init__()
        self.config = cfg = config
        gen = torch.Generator().manual_seed(seed)
        self.encoder = archs.Encoder(cfg.num_latents, gen)
        self.generator = archs.Generator(cfg.num_latents, cfg.num_residual_blocks, gen)
        self.hyper_analysis = mbt2018.HyperAnalysisTransform(
            cfg.num_hyperlatents, cfg.num_latents, cfg.num_hyperlatents, gen)
        self.hyper_synthesis = mbt2018.HyperSynthesisTransform(
            cfg.num_hyperlatents, cfg.num_latents, cfg.num_hyperlatents, gen)
        self.hyperprior = DeepFactorizedPrior((cfg.num_hyperlatents,), generator=gen)
        self._main_em = LocationScaleIndexedEntropyModel(NoisyNormal, coding_rank=3)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                training: bool = True):
        """x in [0, 1] (N, H, W, 3) -> ``(x_hat, y_hat, bpp, hinge_bpp)``.

        ``bpp`` is the whole input's rate (the loss's rate term);
        ``hinge_bpp`` the rate of the y latents at least
        ``hinge_boundary_ring`` positions from every edge, over the pixels
        they cover, plus z's (the statistic the hinge compares; ``bpp``
        where y has no interior)."""
        em = self._main_em
        y = self.encoder(x)
        z = self.hyper_analysis(y)
        side_em = ContinuousBatchedEntropyModel(self.hyperprior(), coding_rank=3)
        z_tilde, z_bits = side_em(z, generator, training)
        mu, sigma = self.hyper_synthesis(z_tilde)
        _, y_bits = em(y, sigma, loc=mu, generator=generator, training=training)
        y_hat = em.quantize(y, loc=mu)
        x_hat = self.generator(y_hat)
        num_pixels = x.shape[1] * x.shape[2]
        z_bpp = torch.mean(z_bits) / num_pixels
        bpp = torch.mean(y_bits) / num_pixels + z_bpp
        ring = self.config.hinge_boundary_ring
        hy, wy = y.shape[1], y.shape[2]
        if hy > 2 * ring and wy > 2 * ring:
            sl = (slice(None), slice(ring, hy - ring), slice(ring, wy - ring))
            _, y_bits_in = em(y[sl], sigma[sl], loc=mu[sl], generator=generator,
                              training=training)
            in_px = (hy - 2 * ring) * (wy - 2 * ring) * 16 * 16
            hinge_bpp = torch.mean(y_bits_in) / in_px + z_bpp
        else:
            hinge_bpp = bpp
        return x_hat, y_hat, bpp, hinge_bpp

    def coded_bpp(self, x: torch.Tensor) -> torch.Tensor:
        """The rate the coder pays (the rate probe's statistic): the bits of
        the rounded symbols, each at most the coder's 12-bit precision (the
        quantized tables floor every in-range symbol's probability), summed
        per image, averaged over the batch, per pixel."""
        y, z = self.encode_latents(x)
        side_em = ContinuousBatchedEntropyModel(self.hyperprior(), coding_rank=3)
        z_hat = side_em.quantize(z)
        z_bits = torch.clamp(-side_em._log2_prob(side_em.prior, z_hat),
                             max=_CODER_PRECISION)
        mu, sigma = self.hyper_synthesis(z_hat)
        inner = self._main_em._em
        prior = inner._make_prior(inner._normalize_indexes(
            self._main_em.inverse_scale_fn(sigma)))
        y_bits = torch.clamp(-inner._log2_prob(prior, torch.round(y - mu)),
                             max=_CODER_PRECISION)
        num_pixels = x.shape[1] * x.shape[2]
        return (torch.mean(torch.sum(y_bits, dim=(1, 2, 3)))
                + torch.mean(torch.sum(z_bits, dim=(1, 2, 3)))) / num_pixels

    def encode_latents(self, x):
        """x in [0, 1] (N, H, W, 3) -> (y, z)."""
        y = self.encoder(x)
        return y, self.hyper_analysis(y)

    def params_from_zhat(self, z_hat):
        return self.hyper_synthesis(z_hat)

    def generate(self, y_hat):
        return self.generator(y_hat)

    synthesize = generate  # the name the shared codec stages call

    @property
    def analysis(self) -> nn.Module:
        """The encoder, under the other families' name for their analysis."""
        return self.encoder

    def get_hyperprior(self):
        return self.hyperprior()


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (torch's has a threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def make_loss_fns(model: HificModel, disc: archs.Discriminator, lpips: nn.Module,
                  cfg: HificConfig):
    """The G and D losses.

    ``g_loss_fn(batch, generator, gan_scale=1.0, probe_bpp=-1.0,
    lam_override=-1.0) -> (loss, aux)``: a nonnegative ``probe_bpp`` (the
    probe's coded full-resolution rate) replaces the interior patch rate in
    the hinge's comparison; a nonnegative ``lam_override`` replaces the
    hinge's lambda. D sees x_hat and y_hat without changing its
    spectral-norm state, and y_hat without gradient.
    ``d_loss_fn(batch, x_hat, y_hat) -> loss``: D on the real batch, then
    on x_hat, each pass advancing the spectral-norm state.
    """

    def g_loss_fn(batch, generator, gan_scale=1.0, probe_bpp=-1.0, lam_override=-1.0):
        x_hat, y_hat, bpp, hinge_bpp = model(batch, generator, training=True)
        mse = torch.mean(torch.square(batch - x_hat)) * (255.0**2)
        perceptual = torch.mean(lpips(clip(batch, 0.0, 1.0), clip(x_hat, 0.0, 1.0)))
        logits_fake = disc(x_hat, y_hat.detach(), update_stats=False)
        gan_loss = torch.mean(_softplus(-logits_fake))
        probe = torch.as_tensor(probe_bpp, dtype=hinge_bpp.dtype, device=hinge_bpp.device)
        hinge_stat = torch.where(probe >= 0.0, probe, hinge_bpp)
        if cfg.hinge_softness > 0.0:
            err = torch.log2(torch.clamp(hinge_stat, min=1e-6) / cfg.target_rate
                             ) / cfg.hinge_softness
            frac = clip((err + 1.0) * 0.5, 0.0, 1.0)
            lam = torch.exp((1.0 - frac) * math.log(cfg.lambda_b)
                            + frac * math.log(cfg.lambda_a))
        else:
            lam = torch.where(hinge_stat > cfg.target_rate,
                              torch.full_like(hinge_stat, cfg.lambda_a),
                              torch.full_like(hinge_stat, cfg.lambda_b))
        override = torch.as_tensor(lam_override, dtype=lam.dtype, device=lam.device)
        lam = torch.where(override >= 0.0, override, lam)
        loss = (lam * bpp
                + cfg.k_mse * cfg.k_mse_scale * mse
                + cfg.k_lpips * perceptual
                + cfg.k_gan * gan_scale * gan_loss)
        aux = {
            "bpp": bpp,
            "hinge_bpp": hinge_bpp,
            "mse": mse,
            "lpips": perceptual,
            "g_gan": gan_loss,
            # 1 while the push-down arm is on: its mean over training is the
            # controller's duty cycle.
            "hinge_on": (hinge_stat > cfg.target_rate).to(torch.float32),
            "hinge_stat": hinge_stat,
            "lam": lam,
            "x_hat": x_hat,
            "y_hat": y_hat,
        }
        return loss, aux

    def d_loss_fn(batch, x_hat, y_hat):
        logits_real = disc(batch, y_hat, update_stats=True)
        logits_fake = disc(x_hat, y_hat, update_stats=True)
        return torch.mean(_softplus(-logits_real)) + torch.mean(_softplus(logits_fake))

    return g_loss_fn, d_loss_fn


def make_train_steps(model: HificModel, disc: archs.Discriminator, lpips: nn.Module,
                     cfg: HificConfig, num_devices: int = 1):
    """The joint G/D step and its two optimizers.

    Returns ``(step, g_opt, d_opt)``: ``step(batch, generator,
    step_idx=None, probe_bpp=None, lam_override=None) -> metrics`` (device
    tensors, no host sync) takes G's gradients alone (D's parameters get
    none from the G loss) and updates G, then D's loss on the batch and the
    pre-update x_hat, y_hat. While ``step_idx < cfg.gan_warmup_steps`` the
    GAN term is scaled by 0 and D's parameters and Adam state (its step
    count too) stay as they are; its spectral-norm state still advances.
    ``step_idx=None`` is past any warm-up. Both optimizers are Adam at the
    constant ``cfg.lr`` and ``cfg.disc_lr`` (optax's update: ``eps``
    outside the square root). A uint8 batch is divided by 255 on its
    device.
    """
    if num_devices > 1:
        raise NotImplementedError(
            "data-parallel training (num_devices > 1) is not ported yet; "
            "see ROADMAP item 17"
        )
    g_params = list(model.parameters())
    g_opt = torch.optim.Adam(g_params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
    d_opt = torch.optim.Adam(disc.parameters(), lr=cfg.disc_lr, betas=(0.9, 0.999),
                             eps=1e-8)
    g_loss_fn, d_loss_fn = make_loss_fns(model, disc, lpips, cfg)

    def step(batch, generator, step_idx=None, probe_bpp=None, lam_override=None):
        if batch.dtype == torch.uint8:
            batch = batch.to(torch.float32) / 255.0
        gate = 1.0 if step_idx is None else float(step_idx >= cfg.gan_warmup_steps)
        g_loss, aux = g_loss_fn(
            batch, generator, gan_scale=gate,
            probe_bpp=-1.0 if probe_bpp is None else probe_bpp,
            lam_override=-1.0 if lam_override is None else lam_override)
        for p, g in zip(g_params, torch.autograd.grad(g_loss, g_params)):
            p.grad = g
        g_opt.step()
        x_hat = aux.pop("x_hat").detach()
        y_hat = aux.pop("y_hat").detach()
        if gate:
            d_loss = d_loss_fn(batch, x_hat, y_hat)
            d_opt.zero_grad(set_to_none=True)
            d_loss.backward()
            d_opt.step()
        else:
            with torch.no_grad():
                d_loss = d_loss_fn(batch, x_hat, y_hat)
        gan_on = torch.tensor(gate, device=g_loss.device)
        return {"g_loss": g_loss.detach(), "d_loss": d_loss.detach(), "gan_on": gan_on,
                **{k: v.detach() for k, v in aux.items()}}

    return step, g_opt, d_opt


def load_model(path, config: HificConfig) -> HificModel:
    """Builds the G-side model and loads a flax msgpack checkpoint of it
    (either package's ``train`` writes one), on the CPU."""
    from compression_tpu_torch.convert import load_flax_msgpack, params_from_numpy

    model = HificModel(config)
    model.load_state_dict(params_from_numpy(load_flax_msgpack(path)))
    return model


class Codec(mbt2018.Codec):
    """A HiFiC model on a device with its CDF tables, as a codec with both
    coders: mbt2018-mean's stages with the generator as the synthesis
    (``_front``, and ``_mu_rows``: the hyper-synthesis run one image at a
    time, the one path from z_hat to mu and the rows on both sides), 4- and
    5-field blobs under the model name ``config.name``, inputs padded to a
    multiple of 64.

    Args:
      model: a :class:`HificModel` (moved to ``device``).
      device: ``"cuda"`` (default; raises if absent) or ``"cpu"``.
      tables: optional ``{"side": CdfTables, "main": CdfTables}`` to use
        instead of building them from the model.
    """
