"""mbt2018-mean: the mean-scale hyperprior image codec (counterpart of
``compression_tpu/models/mbt2018.py``: the transforms, training, and
``Codec`` with both entropy coders).

bmshj2018's analysis/synthesis pair at 320 latents, with (a) the
hyper-analysis reading y itself rather than |y| and (b) the
hyper-synthesis predicting both a mean mu and a scale sigma for each
element of y, which is coded as ``round(y - mu)`` against the
sigma-indexed NoisyNormal tables:

* ``coder="host"``: the C++ range coder on the host; 4-field blobs
  ``[y_string, z_string, xshape, zshape]``;
* ``coder="device"``: y is K-lane rANS-coded on the card (kernels K3/K2,
  through :mod:`compression_tpu_torch.models.device_coding`'s shared
  mean-scale stages), z on the host; 5-field blobs ``[y_words, z_string,
  xshape, zshape, [K]]``.

Both formats are byte-compatible with the JAX package's, and the decoder
detects the format per batch.

Training uses mixed quantization, as the JAX package does: the rates come
from the noise surrogate, while the hyper-synthesis reads the rounded z and
the synthesis the y rounded around mu, the values the decoder will see.

Not ported yet: ``SpatialCodec`` and the sharded transforms.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from compression_tpu_torch.distributions.uniform_noise import NoisyNormal
from compression_tpu_torch.entropy_models import (
    SCALES_MIN,
    ContinuousBatchedEntropyModel,
    LocationScaleIndexedEntropyModel,
)
from compression_tpu_torch.layers import SignalConv2D
from compression_tpu_torch.layers.priors import DeepFactorizedPrior
from compression_tpu_torch.models import bmshj2018, common
from compression_tpu_torch.models.codec_base import HyperpriorCodec
from compression_tpu_torch.ops.math_ops import lower_bound

__all__ = [
    "Config",
    "MBT2018Model",
    "Codec",
    "load_model",
    "make_loss_fn",
    "train",
]


@dataclasses.dataclass(frozen=True)
class Config:
    lmbda: float = 0.01
    distortion: str = "mse"        # "mse" | "msssim"
    num_filters: int = 192
    num_latents: int = 320
    num_hyperlatents: int = 192
    model_name: str = "mbt2018-mean"
    downscale: int = 64


class HyperAnalysisTransform(bmshj2018.HyperAnalysisTransform):
    """y -> z, on signed y: the mean prediction needs the sign."""

    def forward(self, y):
        return self.conv2(self.conv1(self.conv0(y)))


class HyperSynthesisTransform(nn.Module):
    """z_hat -> (mu, sigma), each with ``num_latents`` channels; sigma
    bounded below by the scale table's lower edge."""

    def __init__(self, num_filters: int, num_latents: int, num_hyperlatents: int,
                 gen: torch.Generator):
        super().__init__()
        wide = num_filters * 3 // 2
        self.conv0 = bmshj2018._up(num_hyperlatents, num_filters, 5, gen, torch.relu)
        self.conv1 = bmshj2018._up(num_filters, wide, 5, gen, torch.relu)
        self.conv2 = SignalConv2D(wide, 2 * num_latents, 3, corr=True,
                                  padding="same_zeros", use_bias=True, generator=gen)

    def forward(self, z):
        mu, sigma = torch.chunk(self.conv2(self.conv1(self.conv0(z))), 2, dim=-1)
        # lower_bound, not a hard max: keeps rate gradients alive where the
        # predicted sigma starts below the table's floor (see bmshj2018).
        return mu, lower_bound(sigma, SCALES_MIN)


class MBT2018Model(nn.Module):
    """The four transforms plus the factorized hyperprior's parameters.

    Submodule and parameter names follow the JAX package's param tree, so
    :func:`compression_tpu_torch.convert.params_from_numpy` maps a flax
    checkpoint onto ``load_state_dict``. The initial weights are drawn from
    one generator seeded with ``seed``, layer by layer.
    """

    def __init__(self, config: Config = Config(), seed: int = 0):
        super().__init__()
        self.config = cfg = config
        gen = torch.Generator().manual_seed(seed)
        self.analysis = bmshj2018.AnalysisTransform(cfg.num_filters, cfg.num_latents, gen)
        self.synthesis = bmshj2018.SynthesisTransform(cfg.num_filters, cfg.num_latents, gen)
        self.hyper_analysis = HyperAnalysisTransform(
            cfg.num_filters, cfg.num_latents, cfg.num_hyperlatents, gen)
        self.hyper_synthesis = HyperSynthesisTransform(
            cfg.num_filters, cfg.num_latents, cfg.num_hyperlatents, gen)
        self.hyperprior = DeepFactorizedPrior((cfg.num_hyperlatents,),
                                              generator=gen)
        self._main_em = LocationScaleIndexedEntropyModel(NoisyNormal, coding_rank=3)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                training: bool = True):
        """x in [0, 1] (N, H, W, 3) -> ``(x_hat, y_bits, z_bits)``, bits per
        image. Mixed quantization: with ``training`` the rates are taken
        under U(-1/2, 1/2) noise from ``generator`` (z's, then y's), and
        otherwise at the rounded values; either way the hyper-synthesis
        reads z rounded on its prior's offset grid and the synthesis reads
        y rounded around mu, with straight-through gradients."""
        y = self.analysis(x)
        z = self.hyper_analysis(y)
        side_em = ContinuousBatchedEntropyModel(self.hyperprior(), coding_rank=3)
        _, z_bits = side_em(z, generator, training)
        mu, sigma = self.hyper_synthesis(side_em.quantize(z))
        _, y_bits = self._main_em(y, sigma, loc=mu, generator=generator,
                                  training=training)
        x_hat = self.synthesis(self._main_em.quantize(y, loc=mu))
        return x_hat, y_bits, z_bits

    def encode_latents(self, x):
        """x in [0, 1] (N, H, W, 3) -> (y, z)."""
        y = self.analysis(x)
        return y, self.hyper_analysis(y)

    def params_from_zhat(self, z_hat):
        return self.hyper_synthesis(z_hat)

    def synthesize(self, y_hat):
        return self.synthesis(y_hat)


def make_loss_fn(model: MBT2018Model, training: bool = True):
    """``loss_fn(batch, generator) -> (loss, {"bpp", <metric>})``: bits per
    pixel plus ``lmbda`` times the configured distortion."""
    cfg = model.config

    def loss_fn(x, generator=None):
        x_hat, y_bits, z_bits = model(x, generator, training)
        num_pixels = x.shape[1] * x.shape[2]
        bpp = (torch.mean(y_bits) + torch.mean(z_bits)) / num_pixels
        dist, mname, mval = common.distortion_loss(x, x_hat, cfg.distortion)
        return bpp + cfg.lmbda * dist, {"bpp": bpp, mname: mval}

    return loss_fn


def train(cfg: Config, train_cfg: common.TrainConfig, params=None,
          device="cuda"):
    """Builds the model (seeded with ``train_cfg.seed``, or from ``params``,
    a state dict), trains it and returns it."""
    model = MBT2018Model(cfg, seed=train_cfg.seed)
    if params is not None:
        model.load_state_dict(params)
    return common.train_model(model, make_loss_fn(model), train_cfg,
                              device=device)


def load_model(path, config: Config = Config()) -> MBT2018Model:
    """Builds the model and loads a flax msgpack checkpoint (on the CPU)."""
    from compression_tpu_torch.convert import load_flax_msgpack, params_from_numpy

    model = MBT2018Model(config)
    model.load_state_dict(params_from_numpy(load_flax_msgpack(path)))
    return model


class Codec(HyperpriorCodec):
    """The trained model on a device, plus its CDF tables, as a codec with
    both coders (the batch API, both coders' stages and the pipelined
    iterators come from
    :class:`~compression_tpu_torch.models.codec_base.HyperpriorCodec`).

    Encode/decode agreement: what the decoder must reproduce goes through
    functions both sides call: ``_mu_rows`` (z_hat -> mu and the CDF rows,
    the hyper-synthesis run one image at a time, so cuDNN sees the same
    shapes at any batch size), ``_center_round`` (``round(y - mu)``) and
    ``_apply_loc`` (``values + mu``).

    Args:
      model: an :class:`MBT2018Model` (moved to ``device``).
      device: ``"cuda"`` (default; raises if absent) or ``"cpu"``.
      tables: optional ``{"side": CdfTables, "main": CdfTables}`` to use
        instead of building them from the model.
    """

    def _front(self, x_uint8: torch.Tensor):
        """uint8 images on the device -> (y, z symbols, z_hat)."""
        y, z = self.model.encode_latents(x_uint8.to(torch.float32) / 255.0)
        return (y, *self._z_symbols(z))

    def _mu_rows(self, z_hat: torch.Tensor):
        """z_hat -> (mu, uint8 CDF rows); encode and decode both call this."""
        mus, sigmas = zip(*(self.model.params_from_zhat(z_hat[i : i + 1])
                            for i in range(z_hat.shape[0])))
        return torch.cat(mus), self.em.rows(torch.cat(sigmas))
