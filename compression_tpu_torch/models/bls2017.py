"""bls2017: the factorized-prior image codec (counterpart of
``compression_tpu/models/bls2017.py``: the transforms, training, and
``Codec`` with the host range coder).

A 3-layer GDN analysis transform (9x9/4, then two 5x5/2 convolutions), a
DeepFactorized prior over the latents y, and the mirrored IGDN synthesis,
which ends in a 9x9 up-convolution at stride 4. ``arch="bmshj2018"`` keeps
the prior and takes bmshj2018's four-layer transform pair instead, at
``latent_channels``: the ``bmshj2018-factorized`` models.

Training: ``model(x, generator, training)`` gives ``(x_hat, bits)``,
:func:`make_loss_fn` the rate-distortion loss and :func:`train` runs
:func:`compression_tpu_torch.models.common.train_model`.

Coding: :class:`Codec` takes one image at a time, as the JAX package's
does; each becomes a 3-field ``.tfci`` blob ``[string, xshape, yshape]``,
byte-compatible with the JAX package's. Layouts at the public boundary are
the JAX package's: images HWC uint8, latents ``(N, h, w, C)``.
:func:`make_codec` keeps one codec per model and device; as in the JAX
package, its tables are built without the table disk cache. The
``sharded_*`` functions run the transforms with H sharded over a mesh, and
:class:`SpatialCodec` codes one image through them
(:mod:`compression_tpu_torch.parallel.spatial`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from compression_tpu_torch.entropy_models import ContinuousBatchedEntropyModel
from compression_tpu_torch.layers import GDN, SignalConv2D
from compression_tpu_torch.layers.priors import DeepFactorizedPrior
from compression_tpu_torch.models import bmshj2018, common
from compression_tpu_torch.models.codec_base import DeviceCodec
from compression_tpu_torch.models.codec_cache import cached
from compression_tpu_torch.parallel.spatial import (
    gather_rows,
    map_shards,
    shard_rows,
    sharded_transform_apply,
)
from compression_tpu_torch.util import PackedTensors
from compression_tpu_torch.util.image import pad_to_multiple_np, to_uint8

__all__ = [
    "Config",
    "BLS2017Model",
    "Codec",
    "SpatialCodec",
    "compress",
    "decompress",
    "load_model",
    "make_codec",
    "make_loss_fn",
    "sharded_analyze",
    "sharded_synthesize",
    "train",
]


@dataclasses.dataclass(frozen=True)
class Config:
    lmbda: float = 0.01
    distortion: str = "mse"        # "mse" | "msssim"
    num_filters: int = 128
    coding_rank: int = 3
    model_name: str = "bls2017"
    downscale: int = 16  # total downsampling of the analysis transform
    # "bls2017": 9x9/4 + 2x 5x5/2 transforms; "bmshj2018": bmshj2018's
    # 4x 5x5/2 pair with the same factorized prior (bmshj2018-factorized).
    arch: str = "bls2017"
    num_latents: int = 0  # bmshj2018 arch: channels of y; 0 = num_filters

    @property
    def latent_channels(self) -> int:
        return self.num_latents or self.num_filters


class LeakyReLU(nn.Module):
    """``where(x >= 0, x, slope * x)``, as ``flax.linen.leaky_relu``: at an
    exact 0 the gradient is 1 (``torch.nn.LeakyReLU`` passes ``slope``)."""

    def __init__(self, slope: float = 0.2):
        super().__init__()
        self.slope = slope

    def forward(self, x):
        return torch.where(x >= 0, x, self.slope * x)


def _activation(name: str, channels: int, inverse: bool) -> nn.Module:
    if name == "gdn":
        return GDN(channels, inverse=inverse)
    if name == "leaky_relu":
        return LeakyReLU(0.2)
    raise ValueError(f"unknown activation {name!r} (gdn | leaky_relu)")


class AnalysisTransform(nn.Module):
    """x -> y: 9x9/4 then two 5x5/2 SignalConvs with GDN (or b2018's
    leaky ReLU) between."""

    def __init__(self, num_filters: int, gen: torch.Generator,
                 activation: str = "gdn"):
        super().__init__()
        self.conv0 = SignalConv2D(3, num_filters, 9, corr=True, strides_down=4,
                                  padding="same_zeros", use_bias=True, generator=gen)
        self.gdn0 = _activation(activation, num_filters, False)
        self.conv1 = bmshj2018._down(num_filters, num_filters, 5, True, gen)
        self.gdn1 = _activation(activation, num_filters, False)
        self.conv2 = bmshj2018._down(num_filters, num_filters, 5, False, gen)

    def forward(self, x):
        return self.conv2(self.gdn1(self.conv1(self.gdn0(self.conv0(x)))))


class SynthesisTransform(nn.Module):
    """y_hat -> x_hat: the mirror of the analysis, with IGDN (or the leaky
    ReLU) and up-sampling (the last convolution at stride 4)."""

    def __init__(self, num_filters: int, gen: torch.Generator,
                 activation: str = "gdn"):
        super().__init__()
        self.conv0 = bmshj2018._up(num_filters, num_filters, 5, gen)
        self.igdn0 = _activation(activation, num_filters, True)
        self.conv1 = bmshj2018._up(num_filters, num_filters, 5, gen)
        self.igdn1 = _activation(activation, num_filters, True)
        self.conv2 = SignalConv2D(num_filters, 3, 9, corr=False, strides_up=4,
                                  padding="same_zeros", use_bias=True, generator=gen)

    def forward(self, y):
        return self.conv2(self.igdn1(self.conv1(self.igdn0(self.conv0(y)))))


class BLS2017Model(nn.Module):
    """Analysis + factorized prior + synthesis.

    Submodule and parameter names follow the JAX package's param tree
    (``analysis.conv0``, ``analysis.gdn0``, ..., ``prior``), so
    :func:`compression_tpu_torch.convert.params_from_numpy` maps a flax
    checkpoint onto ``load_state_dict``. The initial weights are drawn from
    one generator seeded with ``seed``, layer by layer.
    """

    def __init__(self, config: Config = Config(), seed: int = 0):
        super().__init__()
        self.config = cfg = config
        gen = torch.Generator().manual_seed(seed)
        if cfg.arch == "bmshj2018":
            self.analysis = bmshj2018.AnalysisTransform(
                cfg.num_filters, cfg.latent_channels, gen)
            self.synthesis = bmshj2018.SynthesisTransform(
                cfg.num_filters, cfg.latent_channels, gen)
        elif cfg.arch == "bls2017":
            self.analysis = AnalysisTransform(cfg.num_filters, gen)
            self.synthesis = SynthesisTransform(cfg.num_filters, gen)
        else:
            raise ValueError(f"unknown arch {cfg.arch!r} (bls2017 | bmshj2018)")
        self.prior = DeepFactorizedPrior((cfg.latent_channels,), generator=gen)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                training: bool = True):
        """x in [0, 1] (N, H, W, 3) -> ``(x_hat, bits)``, bits per image.
        ``training`` adds U(-1/2, 1/2) noise to y from ``generator`` (on x's
        device); otherwise y is rounded on the prior's offset grid with
        straight-through gradients."""
        y = self.analysis(x)
        em = ContinuousBatchedEntropyModel(self.prior(),
                                           coding_rank=self.config.coding_rank)
        y_tilde, bits = em(y, generator, training)
        return self.synthesis(y_tilde), bits

    def synthesize(self, y_hat):
        return self.synthesis(y_hat)


def make_loss_fn(model: BLS2017Model, training: bool = True):
    """``loss_fn(batch, generator) -> (loss, {"bpp", <metric>})``: bits per
    pixel plus ``lmbda`` times the configured distortion."""
    cfg = model.config

    def loss_fn(x, generator=None):
        x_hat, bits = model(x, generator, training)
        bpp = torch.mean(bits) / (x.shape[1] * x.shape[2])
        dist, mname, mval = common.distortion_loss(x, x_hat, cfg.distortion)
        return bpp + cfg.lmbda * dist, {"bpp": bpp, mname: mval}

    return loss_fn


def train(cfg: Config, train_cfg: common.TrainConfig, params=None,
          device="cuda"):
    """Builds the model (seeded with ``train_cfg.seed``, or from ``params``,
    a state dict), trains it and returns it."""
    model = BLS2017Model(cfg, seed=train_cfg.seed)
    if params is not None:
        model.load_state_dict(params)
    return common.train_model(model, make_loss_fn(model), train_cfg,
                              device=device)


def load_model(path, config: Config = Config()) -> BLS2017Model:
    """Builds the model and loads a flax msgpack checkpoint (on the CPU)."""
    from compression_tpu_torch.convert import load_flax_msgpack, params_from_numpy

    model = BLS2017Model(config)
    model.load_state_dict(params_from_numpy(load_flax_msgpack(path)))
    return model


class Codec(DeviceCodec):
    """The trained model on a device, plus its prior's CDF tables, as a
    one-image codec: the transforms run on the device (on the codec's CUDA
    stream, strict float32), the symbols ``round(y - offset)`` are taken
    there, and the host range coder codes them. A factorized prior's rows
    are fixed per channel, so encoder and decoder derive nothing from the
    latents but the symbols.

    Args:
      model: a :class:`BLS2017Model` (moved to ``device``).
      device: ``"cuda"`` (default; raises if absent) or ``"cpu"``.
      tables: optional ``CdfTables`` of the prior, to use instead of
        building them from the model.
    """

    def __init__(self, model: BLS2017Model, device="cuda", tables=None):
        super().__init__(model, device)
        self.em = ContinuousBatchedEntropyModel(
            model.prior(device="cpu"), coding_rank=self.cfg.coding_rank,
            compression=True, tables=tables,
        )

    def compress(self, image: np.ndarray) -> bytes:
        """uint8 (H, W, 3) image -> 3-field .tfci blob."""
        x, (h, w) = pad_to_multiple_np(np.asarray(image, np.uint8)[None],
                                       self.cfg.downscale)
        with self._on_device():
            with self.timer.stage("enc/analysis"):
                y = self.model.analysis(self._to_device(x).to(torch.float32) / 255.0)
            with self.timer.stage("enc/code"):
                string = self.em.compress(y)[0]
        return self._blob([string, np.array([h, w], np.int32),
                           np.array(y.shape[1:3], np.int32)])

    def decompress(self, data: bytes) -> np.ndarray:
        """3-field .tfci blob -> uint8 (H, W, 3) image."""
        string, xshape, yshape = PackedTensors(data).unpack(
            [object, np.int32, np.int32])
        with self.timer.stage("dec/code"):
            y_hat = self.em.decompress([bytes(string[0])],
                                       tuple(int(v) for v in yshape))
        with self._on_device():
            with self.timer.stage("dec/synth"):
                x_hat = self._synthesize(self._to_device(y_hat)).cpu().numpy()
        return x_hat[0, : int(xshape[0]), : int(xshape[1]), :]


def make_codec(model: BLS2017Model, device="cuda") -> Codec:
    """The model's :class:`Codec` on ``device``, built once for the model,
    its weights and the device
    (:func:`~compression_tpu_torch.models.codec_cache.cached`)."""
    return cached(model, lambda: Codec(model, device), device)


def compress(model: BLS2017Model, image: np.ndarray, device="cuda") -> bytes:
    """uint8 (H, W, 3) image -> 3-field .tfci blob."""
    return make_codec(model, device).compress(image)


def decompress(model: BLS2017Model, data: bytes, device="cuda") -> np.ndarray:
    return make_codec(model, device).decompress(data)


# -- spatially sharded transforms (images too large for one device) -----------


def sharded_analyze(model: BLS2017Model, x, mesh, axis="data"):
    """H-sharded analysis: x (N, H, W, 3) in [0, 1], or its shards -> y's
    shards (H divisible by ``mesh size * 16``). GDN runs on each shard."""
    return sharded_transform_apply(model.analysis, x, mesh, axis)


def sharded_synthesize(model: BLS2017Model, y_hat, mesh, axis="data"):
    """H-sharded synthesis: y_hat or its shards -> x_hat's shards (h
    divisible by the mesh size)."""
    return sharded_transform_apply(model.synthesis, y_hat, mesh, axis)


class SpatialCodec:
    """Giant-image factorized-prior codec: one image, both transforms
    H-sharded over ``mesh``, the host range coder, the standard 3-field
    blob. A factorized prior's rows are fixed per channel: only the
    transforms shard.

    Args:
      model: a :class:`BLS2017Model` (moved to ``mesh.devices[0]``).
      mesh: the shards' devices.
    """

    def __init__(self, model: BLS2017Model, mesh, axis="data"):
        self.codec = make_codec(model, mesh.devices[0])
        self.model, self.cfg = self.codec.model, self.codec.cfg
        self.mesh, self.axis = mesh, axis
        self._mult = self.cfg.downscale * mesh.shape[axis]

    def compress(self, image: np.ndarray) -> bytes:
        """uint8 (H, W, 3) -> 3-field .tfci blob."""
        x, (h, w) = pad_to_multiple_np(np.asarray(image, np.uint8)[None], self._mult,
                                       self.cfg.downscale)
        with torch.inference_mode():
            x = map_shards(lambda s: s.to(torch.float32) / 255.0,
                           shard_rows(torch.from_numpy(x), self.mesh, self.axis))
            y = gather_rows(sharded_analyze(self.model, x, self.mesh, self.axis))
            string = self.codec.em.compress(y)[0]
        return self.codec._blob([string, np.array([h, w], np.int32),
                                 np.array(y.shape[1:3], np.int32)])

    def decompress(self, data: bytes) -> np.ndarray:
        """3-field .tfci blob -> uint8 (H, W, 3)."""
        string, xshape, yshape = PackedTensors(data).unpack([object, np.int32, np.int32])
        y_hat = self.codec.em.decompress([bytes(string[0])], tuple(int(v) for v in yshape))
        with torch.inference_mode():
            y_hat = shard_rows(torch.from_numpy(y_hat), self.mesh, self.axis)
            x_hat = sharded_synthesize(self.model, y_hat, self.mesh, self.axis)
            x_hat = gather_rows(map_shards(to_uint8, x_hat)).cpu().numpy()
        return x_hat[0, : int(xshape[0]), : int(xshape[1]), :]
