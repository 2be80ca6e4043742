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

The joint step runs data-parallel over a mesh of devices (one body for one
device and many), and ``SpatialCodec`` codes one image with its
transforms H-sharded over a mesh.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from compression_tpu_torch.distributions.uniform_noise import NoisyNormal
from compression_tpu_torch.entropy_models import (
    ContinuousBatchedEntropyModel,
    LocationScaleIndexedEntropyModel,
)
from compression_tpu_torch.layers.priors import DeepFactorizedPrior
from compression_tpu_torch.models import mbt2018
from compression_tpu_torch.models.codec_cache import cached
from compression_tpu_torch.models.hific import archs
from compression_tpu_torch.models.hific.configs import HificConfig
from compression_tpu_torch.models.spatial_codec import SpatialCodecBase
from compression_tpu_torch.ops.math_ops import clip
from compression_tpu_torch.parallel.data_parallel import (
    Mesh,
    Replicas,
    device_of,
    make_mesh,
    mean_metrics,
    reduce_mean,
    shard_batch,
)
from compression_tpu_torch.parallel.spatial import (
    as_shards,
    map_shards,
    sharded_conv,
    sharded_transform_apply,
)

__all__ = ["HificModel", "make_loss_fns", "make_train_steps", "Codec", "load_model",
           "make_codec", "compress", "decompress", "sharded_encode", "sharded_generate",
           "sharded_encode_latents", "sharded_params", "SpatialCodec"]

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


def _g_parts(model: HificModel, disc: archs.Discriminator, lpips: nn.Module,
             cfg: HificConfig):
    """The G loss in two parts: ``forward(batch, generator) -> terms`` (the
    model, MSE, LPIPS and D's logits on x_hat), and ``finish(terms,
    hinge_bpp, gan_scale, probe_bpp, lam_override) -> (loss, aux)``, which
    picks lambda from ``hinge_bpp``: the shard's own rate, or under data
    parallelism the shards' mean (the JAX package's ``pmean`` of it)."""

    def forward(batch, generator):
        x_hat, y_hat, bpp, hinge_bpp = model(batch, generator, training=True)
        mse = torch.mean(torch.square(batch - x_hat)) * (255.0**2)
        perceptual = torch.mean(lpips(clip(batch, 0.0, 1.0), clip(x_hat, 0.0, 1.0)))
        logits_fake = disc(x_hat, y_hat.detach(), update_stats=False)
        gan_loss = torch.mean(_softplus(-logits_fake))
        return dict(x_hat=x_hat, y_hat=y_hat, bpp=bpp, hinge_bpp=hinge_bpp, mse=mse,
                    lpips=perceptual, g_gan=gan_loss)

    def finish(terms, hinge_bpp, gan_scale=1.0, probe_bpp=-1.0, lam_override=-1.0):
        bpp = terms["bpp"]
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
                + cfg.k_mse * cfg.k_mse_scale * terms["mse"]
                + cfg.k_lpips * terms["lpips"]
                + cfg.k_gan * gan_scale * terms["g_gan"])
        aux = {
            "bpp": bpp,
            "hinge_bpp": hinge_bpp,
            "mse": terms["mse"],
            "lpips": terms["lpips"],
            "g_gan": terms["g_gan"],
            # 1 while the push-down arm is on: its mean over training is the
            # controller's duty cycle.
            "hinge_on": (hinge_stat > cfg.target_rate).to(torch.float32),
            "hinge_stat": hinge_stat,
            "lam": lam,
            "x_hat": terms["x_hat"],
            "y_hat": terms["y_hat"],
        }
        return loss, aux

    return forward, finish


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
    forward, finish = _g_parts(model, disc, lpips, cfg)

    def g_loss_fn(batch, generator, gan_scale=1.0, probe_bpp=-1.0, lam_override=-1.0):
        terms = forward(batch, generator)
        return finish(terms, terms["hinge_bpp"], gan_scale, probe_bpp, lam_override)

    def d_loss_fn(batch, x_hat, y_hat):
        logits_real = disc(batch, y_hat, update_stats=True)
        logits_fake = disc(x_hat, y_hat, update_stats=True)
        return torch.mean(_softplus(-logits_real)) + torch.mean(_softplus(logits_fake))

    return g_loss_fn, d_loss_fn


def make_train_steps(model: HificModel, disc: archs.Discriminator, lpips: nn.Module,
                     cfg: HificConfig, num_devices: int = 1, axis: str = "data", *,
                     mesh=None):
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

    With ``num_devices > 1`` (a mesh of that many cards) or an explicit
    ``mesh``, the step is data-parallel: ``batch`` is the whole batch or
    its shards, ``generator`` one generator per shard
    (:func:`~compression_tpu_torch.parallel.data_parallel.shard_generators`),
    and it returns the shards' mean metrics. Both run one body
    (:func:`_joint_step`), the one-device step on a mesh of one.
    """
    g_opt = torch.optim.Adam(model.parameters(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
    d_opt = torch.optim.Adam(disc.parameters(), lr=cfg.disc_lr, betas=(0.9, 0.999),
                             eps=1e-8)
    if mesh is None and num_devices > 1:
        mesh = make_mesh(num_devices, axis)
    if mesh is not None:
        return _joint_step(model, disc, lpips, cfg, g_opt, d_opt, mesh), g_opt, d_opt
    # One device: the same body on a mesh of the model's device, one shard.
    joint = _joint_step(model, disc, lpips, cfg, g_opt, d_opt,
                        Mesh((device_of(model),), axis))

    def step(batch, generator, step_idx=None, probe_bpp=None, lam_override=None):
        return joint([batch], [generator], step_idx, probe_bpp, lam_override)

    return step, g_opt, d_opt


def _gate(cfg: HificConfig, step_idx) -> float:
    """The GAN warm-up gate: 1 past ``cfg.gan_warmup_steps`` (or with no
    step index), else 0."""
    return 1.0 if step_idx is None else float(step_idx >= cfg.gan_warmup_steps)


def _joint_step(model, disc, lpips, cfg, g_opt, d_opt, mesh):
    """The joint step over ``mesh`` (the JAX package's ``joint_step``, under
    ``shard_map`` for more than one shard; one process):

    * every shard's G forward runs first; lambda comes from the shards'
      mean ``hinge_bpp`` (a whole-batch decision: a shard's own rate is
      1/n of the evidence), then each shard's G loss is finished and G
      takes the mean of the shards' gradients;
    * D's loss runs shard by shard from the spectral-norm state the step
      began with, as on every JAX device, so the state advances once a
      step (its power iteration reads only the weights);
    * metrics are the shards' means.
    """
    forward, finish = _g_parts(model, disc, lpips, cfg)
    _, d_loss_fn = make_loss_fns(model, disc, lpips, cfg)
    n = mesh.size
    # One module over G, D and LPIPS, so one functional_call runs a shard's
    # whole loss on its device's copies.
    bundle = nn.ModuleDict({"g": model, "d": disc, "lpips": lpips})
    replicas = Replicas(bundle, mesh.devices)
    if replicas.device != mesh.devices[0]:
        raise ValueError(f"the model is on {replicas.device}; the mesh's "
                         f"first device is {mesh.devices[0]}")

    def step(batch, generators, step_idx=None, probe_bpp=None, lam_override=None):
        shards = batch if isinstance(batch, (list, tuple)) else shard_batch(batch, mesh)
        if len(shards) != n or len(generators) != n:
            raise ValueError(f"{len(shards)} shards and {len(generators)} generators "
                             f"for a mesh of {n}")
        shards = [x.to(torch.float32) / 255.0 if x.dtype == torch.uint8 else x
                  for x in shards]
        devices = mesh.devices
        gate = _gate(cfg, step_idx)
        probe = -1.0 if probe_bpp is None else probe_bpp
        lam_o = -1.0 if lam_override is None else lam_override
        main = replicas.device

        terms = [replicas.call(dev, forward, x, gen)
                 for dev, x, gen in zip(devices, shards, generators)]
        hinge = torch.mean(torch.stack([t["hinge_bpp"].to(main) for t in terms]))
        g_losses, auxes = zip(*(finish(t, hinge.to(dev), gate, probe, lam_o)
                                for dev, t in zip(devices, terms)))
        total = sum(loss.to(main) for loss in g_losses) / n
        per_dev = {dev: _subset(replicas, dev, "g.") for dev in replicas.devices()}
        flat = [p for ps in per_dev.values() for p in ps]
        grads = iter(torch.autograd.grad(total, flat))
        g_sums = {dev: [next(grads) for _ in ps] for dev, ps in per_dev.items()}
        # total is already the shards' mean: the parts only add up.
        g_mean = reduce_mean(g_sums, main, 1)
        for p, g in zip(model.parameters(), g_mean):
            p.grad = g
        g_opt.step()

        start = {name: t.detach().clone() for name, t in bundle.named_buffers()
                 if name.startswith("d.")}
        d_sums, d_losses = {}, []
        for dev, x, aux in zip(devices, shards, auxes):
            replicas.load(dev, start)
            x_hat, y_hat = aux["x_hat"].detach(), aux["y_hat"].detach()
            if gate:
                d_loss = replicas.call(dev, d_loss_fn, x, x_hat, y_hat)
                grads = torch.autograd.grad(d_loss, _subset(replicas, dev, "d."))
                prev = d_sums.get(dev)
                d_sums[dev] = grads if prev is None else [a + g for a, g in zip(prev, grads)]
            else:
                with torch.no_grad():
                    d_loss = replicas.call(dev, d_loss_fn, x, x_hat, y_hat)
            d_losses.append(d_loss)
        if gate:
            for p, g in zip(disc.parameters(), reduce_mean(d_sums, main, n)):
                p.grad = g
            d_opt.step()
        replicas.broadcast()

        metrics = [{"g_loss": g, "d_loss": d,
                    **{k: v for k, v in aux.items() if k not in ("x_hat", "y_hat")}}
                   for g, d, aux in zip(g_losses, d_losses, auxes)]
        out = mean_metrics(metrics, main)
        return {"g_loss": out.pop("g_loss"), "d_loss": out.pop("d_loss"),
                "gan_on": torch.tensor(gate, device=main), **out}

    return step


def _subset(replicas, device, prefix: str) -> list:
    """The parameters on ``device`` of the bundle's member ``prefix``."""
    return [p for name, p in zip(replicas.names, replicas.parameters(device))
            if name.startswith(prefix)]


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


def make_codec(model: HificModel, device="cuda") -> Codec:
    """The model's :class:`Codec` on ``device``, built once for the model,
    its weights and the device
    (:func:`~compression_tpu_torch.models.codec_cache.cached`)."""
    return cached(model, lambda: Codec(model, device), device)


def compress(model: HificModel, image: np.ndarray, coder: str = "host",
             device="cuda") -> bytes:
    """uint8 (H, W, 3) image -> .tfci blob, from the host range coder
    (``"host"``) or the card's rANS (``"device"``)."""
    return make_codec(model, device).compress(image, coder)


def decompress(model: HificModel, data: bytes, device="cuda") -> np.ndarray:
    return make_codec(model, device).decompress(data)


# -- spatially sharded transforms (images too large for one device) -----------
#
# The encoder and the generator are wired by hand (ChannelNorm, the
# residual trunk). ChannelNorm normalizes each position over its channels,
# so it runs on each shard, made contiguous rows for its kernel (a shard cut
# from a batch, or a float64 convolution's NCHW memory, is not); only the
# convolutions exchange halos.


def sharded_encode(model: HificModel, x, mesh, axis="data"):
    """H-sharded encoder: image in [0, 1] (H divisible by ``mesh size *
    16``) or its shards -> y's shards."""
    enc = model.encoder
    reps = Replicas(enc, mesh.devices)
    for i in range(5):
        x = sharded_conv(getattr(enc, f"conv{i}"), x, mesh, axis)
        norm = getattr(enc, f"norm{i}")
        x = reps.map(lambda t, norm=norm: torch.relu(norm(t.contiguous())), x)
    return sharded_conv(enc.conv_out, x, mesh, axis)


def sharded_generate(model: HificModel, y_hat, mesh, axis="data"):
    """H-sharded generator: y_hat (latent H divisible by the mesh size) or
    its shards -> the image's shards (16x up-sampled floats)."""
    gen = model.generator
    reps = Replicas(gen, mesh.devices)
    x = reps.map(lambda t: gen.norm_in(t.contiguous()), as_shards(y_hat, mesh, axis))
    x = reps.map(lambda t: gen.norm_head(t.contiguous()),
                 sharded_conv(gen.conv_in, x, mesh, axis))
    for i in range(gen.num_residual_blocks):
        res = getattr(gen, f"res{i}")
        h = sharded_conv(res.conv0, x, mesh, axis)
        h = reps.map(lambda t, res=res: torch.relu(res.norm0(t.contiguous())), h)
        h = reps.map(lambda t, res=res: res.norm1(t.contiguous()),
                     sharded_conv(res.conv1, h, mesh, axis))
        x = map_shards(torch.add, x, h)
    for i in range(4):
        x = sharded_conv(getattr(gen, f"up{i}"), x, mesh, axis)
        norm = getattr(gen, f"upnorm{i}")
        x = reps.map(lambda t, norm=norm: torch.relu(norm(t.contiguous())), x)
    return sharded_conv(gen.conv_out, x, mesh, axis)


def sharded_encode_latents(model: HificModel, x, mesh, axis="data"):
    """The encode front (x -> y -> z) H-sharded (H divisible by ``mesh
    size * 64``); returns the shards of y and of z."""
    y = sharded_encode(model, x, mesh, axis)
    return y, sharded_transform_apply(model.hyper_analysis, y, mesh, axis)


def sharded_params(model: HificModel, z_hat, mesh, axis="data"):
    """H-sharded hyper-synthesis (mbt2018's joint head): z_hat -> the
    shards of mu and of sigma (>= SCALES_MIN)."""
    return mbt2018.split_params(
        sharded_transform_apply(model.hyper_synthesis, z_hat, mesh, axis))


class SpatialCodec(SpatialCodecBase):
    """Giant-image generative codec: one image, the encoder, the hyper pair
    and the generator H-sharded over ``mesh``, the host range coder, the
    standard 4-field blob; z_hat -> (mu, rows) is one sharded function on
    both sides.

    Args:
      model: a :class:`HificModel` (moved to ``mesh.devices[0]``).
      mesh: the shards' devices.
    """

    def __init__(self, model: HificModel, mesh, axis="data"):
        super().__init__(make_codec(model, mesh.devices[0]), mesh, axis)

    def _front(self, x):
        return sharded_encode_latents(self.model, x, self.mesh, self.axis)

    def _mu_rows(self, z_hat):
        mu, sigma = sharded_params(self.model, z_hat, self.mesh, self.axis)
        return mu, map_shards(self.codec.em.rows, sigma)

    def _synth(self, y_hat):
        return sharded_generate(self.model, y_hat, self.mesh, self.axis)
