"""b2018: the variable-rate factorized codec (counterpart of
``compression_tpu/models/b2018.py``: the transforms, training, and
``Codec`` with the host range coder).

One set of weights serves ``len(cfg.lambdas)`` rate points: per-quality
channel gains scale the analysis output (and inverse gains the synthesis
input), and each (quality, channel) pair has its own DeepFactorized
prior. The transforms are bls2017's shape (9x9/4, then two 5x5/2
convolutions) with GDN or a leaky ReLU between, as the reference's
``b2018-gdn-*`` and ``b2018-leaky_relu-*`` models.

Training: ``model(x, generator, q, training)`` gives ``(x_hat, bits)`` at
a scalar 0-based quality ``q`` or at one quality per example (a vector
``q``); :func:`make_loss_fn` assigns the qualities round-robin with a
random rotation and weighs each example's distortion by its lambda.

Coding: :class:`Codec` takes one image at a time and the quality per call
(1-based); each image becomes a 3-field ``.tfci`` blob ``[string, xshape,
[yh, yw, q]]``, byte-compatible with the JAX package's. Not ported yet:
``make_codec``'s cache and the module-level ``compress``/``decompress``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from compression_tpu_torch.entropy_models import ContinuousBatchedEntropyModel
from compression_tpu_torch.entropy_models.continuous_base import CdfTables, uniform_noise
from compression_tpu_torch.layers.priors import DeepFactorizedPrior
from compression_tpu_torch.models import bls2017, common
from compression_tpu_torch.models.codec_base import DeviceCodec
from compression_tpu_torch.util import PackedTensors
from compression_tpu_torch.util.image import pad_to_multiple_np

__all__ = [
    "Config",
    "B2018Model",
    "Codec",
    "LR_SCALES",
    "load_model",
    "make_loss_fn",
    "train",
]


@dataclasses.dataclass(frozen=True)
class Config:
    # Rate points: quality q (1-based) trains/serves with lambdas[q-1].
    lambdas: Tuple[float, ...] = (0.0016, 0.0075, 0.03, 0.14)
    quality: int = 0              # runtime rate point; 0 = unset (training)
    activation: str = "gdn"       # "gdn" | "leaky_relu"
    num_filters: int = 128
    coding_rank: int = 3
    model_name: str = "b2018-gdn-128"
    downscale: int = 16

    @property
    def num_qualities(self) -> int:
        return len(self.lambdas)


class B2018Model(nn.Module):
    """Analysis + per-quality gains + per-quality factorized prior +
    synthesis.

    Parameter names follow the JAX package's param tree (``analysis.conv0``,
    ``analysis.gdn0``, ..., ``prior``, ``gain``, ``inv_gain``), so
    :func:`compression_tpu_torch.convert.params_from_numpy` maps a flax
    checkpoint onto ``load_state_dict``. The initial weights are drawn from
    one generator seeded with ``seed``; the gains start at
    ``g0 = sqrt(lambda / exp(mean(log lambda)))`` for every channel (the
    inverse gains at ``1 / g0``), the JAX package's init.
    """

    def __init__(self, config: Config = Config(), seed: int = 0):
        super().__init__()
        self.config = cfg = config
        gen = torch.Generator().manual_seed(seed)
        self.analysis = bls2017.AnalysisTransform(cfg.num_filters, gen, cfg.activation)
        self.synthesis = bls2017.SynthesisTransform(cfg.num_filters, gen, cfg.activation)
        q, c = cfg.num_qualities, cfg.num_filters
        self.prior = DeepFactorizedPrior((q, c), generator=gen)
        lam = np.asarray(cfg.lambdas, np.float32)
        g0 = np.sqrt(lam / np.exp(np.mean(np.log(lam))))
        g0 = torch.from_numpy(g0.astype(np.float32))[:, None]
        self.gain = nn.Parameter(g0.expand(q, c).clone())
        self.inv_gain = nn.Parameter((1.0 / g0).expand(q, c).clone())

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                q=0, training: bool = True):
        """x in [0, 1] (N, H, W, 3) at rate point(s) ``q`` -> ``(x_hat,
        bits)``, bits per image. ``q`` is a 0-based index for the whole
        batch (the codec paths) or a vector of one index per example
        (training): each example's y then meets its own quality's gains and
        (C,) prior, the same math as a scalar ``q`` for that example (the
        JAX package ``vmap``s one entropy model per example). ``training``
        adds U(-1/2, 1/2) noise from ``generator``; otherwise y is rounded on
        the prior's offset grid with straight-through gradients."""
        q = torch.as_tensor(q, device=x.device)
        if q.ndim == 0:
            y = self.analyze(x, q)
            em = ContinuousBatchedEntropyModel(self.prior(index=q),
                                               coding_rank=self.config.coding_rank)
            y_tilde, bits = em(y, generator, training)
            return self.synthesize(y_tilde, q), bits
        # One prior row per example, broadcast over its positions: batch
        # shape (N, 1, 1, C) against y's (N, h, w, C).
        y = self.analysis(x) * self.gain[q][:, None, None, :]
        prior = self.prior(index=q[:, None, None])
        em = ContinuousBatchedEntropyModel(prior, coding_rank=y.ndim)
        y_tilde = y + uniform_noise(y, generator) if training else em.quantize(y)
        dims = tuple(range(y.ndim - self.config.coding_rank, y.ndim))
        bits = -torch.sum(em._log2_prob(prior, y_tilde), dim=dims)
        return self.synthesis(y_tilde * self.inv_gain[q][:, None, None, :]), bits

    def analyze(self, x, q):
        return self.analysis(x) * self.gain[q]

    def synthesize(self, y_hat, q):
        return self.synthesis(y_hat * self.inv_gain[q])

    def get_prior(self, device=None):
        """The full (num_qualities, num_filters)-batch noisy prior."""
        return self.prior(device=device)


def make_loss_fn(model: B2018Model, training: bool = True):
    """``loss_fn(batch, generator) -> (loss, {"bpp", "mse"})``: example i
    trains at quality ``(i + offset) % Q`` with ``offset`` drawn from
    ``generator`` (0 without one), so every quality's gains and prior get
    gradient in every step; the loss is ``bpp + mean(lambda[q_i] *
    mse_i)``."""
    cfg = model.config

    def loss_fn(x, generator=None):
        n = x.shape[0]
        if generator is None:
            offset = torch.zeros((), dtype=torch.long, device=x.device)
        else:
            offset = torch.randint(cfg.num_qualities, (), generator=generator,
                                   device=generator.device).to(x.device)
        q_vec = (torch.arange(n, device=x.device) + offset) % cfg.num_qualities
        x_hat, bits = model(x, generator, q_vec, training)
        bpp = torch.mean(bits) / (x.shape[1] * x.shape[2])
        mse_e = torch.mean(torch.square(x - x_hat), dim=(1, 2, 3)) * (255.0**2)
        lambdas = torch.tensor(cfg.lambdas, dtype=x.dtype, device=x.device)
        loss = bpp + torch.mean(lambdas[q_vec] * mse_e)
        return loss, {"bpp": bpp, "mse": torch.mean(mse_e)}

    return loss_fn


# The rate-point parameters' learning-rate multipliers: the priors start 10
# wide and must narrow to the gained latents' scale, and the gains must
# spread ~10x, each ~lr a step under Adam (the JAX package's default).
LR_SCALES = (("params/prior", 10.0), ("params/gain", 10.0), ("params/inv_gain", 10.0))


def train(cfg: Config, train_cfg: common.TrainConfig, params=None,
          device="cuda"):
    """Builds the model (seeded with ``train_cfg.seed``, or from ``params``,
    a state dict), trains it and returns it; without ``lr_scales``, at
    :data:`LR_SCALES`."""
    model = B2018Model(cfg, seed=train_cfg.seed)
    if params is not None:
        model.load_state_dict(params)
    if train_cfg.lr_scales is None:
        train_cfg = dataclasses.replace(train_cfg, lr_scales=LR_SCALES)
    return common.train_model(model, make_loss_fn(model), train_cfg, device=device)


def load_model(path, config: Config = Config()) -> B2018Model:
    """Builds the model and loads a flax msgpack checkpoint (on the CPU)."""
    from compression_tpu_torch.convert import load_flax_msgpack, params_from_numpy

    model = B2018Model(config)
    model.load_state_dict(params_from_numpy(load_flax_msgpack(path)))
    return model


def _slice_tables(tables: CdfTables, q: int, channels: int) -> CdfTables:
    """The rows of quality q in the (num_qualities * channels)-row tables."""
    s = slice(q * channels, (q + 1) * channels)
    return CdfTables(cdf=tables.cdf[s], cdf_length=tables.cdf_length[s],
                     cdf_offset=tables.cdf_offset[s], offset=tables.offset[s],
                     precision=tables.precision)


class Codec(DeviceCodec):
    """The trained model on a device plus its prior's CDF tables, as a
    one-image codec serving every rate point. The tables are built once,
    from the full (quality, channel) prior (Q·C rows, quality-major, on the
    host in float64); each quality's entropy model is a row slice of them.
    The transforms run on the device, the symbols ``round(y - offset)`` are
    taken there, and the host range coder codes them.

    Args:
      model: a :class:`B2018Model` (moved to ``device``).
      device: ``"cuda"`` (default; raises if absent) or ``"cpu"``.
      tables: optional ``CdfTables`` of the full prior, to use instead of
        building them from the model.
    """

    def __init__(self, model: B2018Model, device="cuda", tables=None):
        super().__init__(model, device)
        cfg = self.cfg
        full = ContinuousBatchedEntropyModel(
            model.get_prior(device="cpu"), coding_rank=cfg.coding_rank + 1,
            compression=True, tables=tables)
        self.tables = full.tables
        self.ems = [
            ContinuousBatchedEntropyModel(
                model.prior(device="cpu", index=q), coding_rank=cfg.coding_rank,
                compression=True, tables=_slice_tables(self.tables, q, cfg.num_filters))
            for q in range(cfg.num_qualities)
        ]

    def _quality_index(self, quality: int) -> int:
        if not 1 <= quality <= self.cfg.num_qualities:
            raise ValueError(
                f"b2018 needs a runtime quality 1..{self.cfg.num_qualities} "
                f"(got {quality}); use a quality-suffixed name like "
                f"'{self.cfg.model_name}-2'"
            )
        return quality - 1

    def compress(self, image: np.ndarray, *, quality: int,
                 model_name: Optional[str] = None) -> bytes:
        """uint8 (H, W, 3) image -> 3-field .tfci blob at ``quality``
        (1-based), named ``model_name`` (the config's by default)."""
        q = self._quality_index(quality)
        x, (h, w) = pad_to_multiple_np(np.asarray(image, np.uint8)[None],
                                       self.cfg.downscale)
        with self._on_device():
            with self.timer.stage("enc/analysis"):
                y = self.model.analyze(self._to_device(x).to(torch.float32) / 255.0, q)
            with self.timer.stage("enc/code"):
                string = self.ems[q].compress(y)[0]
        packed = PackedTensors()
        packed.model = model_name or self.cfg.model_name
        packed.pack([string, np.array([h, w], np.int32),
                     np.array(list(y.shape[1:3]) + [q], np.int32)])
        return packed.string

    def decompress(self, data: bytes) -> np.ndarray:
        """3-field .tfci blob -> uint8 (H, W, 3) image, at the blob's
        quality."""
        string, xshape, yq = PackedTensors(data).unpack([object, np.int32, np.int32])
        q = self._quality_index(int(yq[2]) + 1)
        with self.timer.stage("dec/code"):
            y_hat = self.ems[q].decompress([bytes(string[0])], (int(yq[0]), int(yq[1])))
        with self._on_device():
            with self.timer.stage("dec/synth"):
                x_hat = self._synthesize(self._to_device(y_hat), q).cpu().numpy()
        return x_hat[0, : int(xshape[0]), : int(xshape[1]), :]
