"""ms2020: the channel-wise autoregressive entropy model, CHARM
(counterpart of ``compression_tpu/models/ms2020.py``: the model, training,
and ``Codec`` with both entropy coders).

The latent y (320 channels) is split into 10 slices of 32. Each slice's
(mu_i, sigma_i) come from hyper "support" features of z_hat plus the
slices decoded before it (at most ``max_support_slices`` of them), and a
latent-residual-prediction (LRP) transform adds a correction of at most
half a bin to each decoded slice. So decode is 10 serial steps over
slices, not over pixels.

Training uses mixed quantization, as the JAX package does: the rates come
from the noise surrogate, while the conditioning and the synthesis see
``round(y_i - mu_i) + mu_i`` with straight-through gradients.

Coding: :class:`Codec`, with the batch API of
:class:`~compression_tpu_torch.models.codec_base.HyperpriorCodec`:

* ``coder="host"``: each slice range-coded on the host; blobs of
  ``num_slices + 3`` fields ``[slice strings..., z_string, xshape,
  zshape]``;
* ``coder="device"``: each slice K-lane rANS-coded on the card (K3 at
  encode, K2 at decode: once a slice, and a decode's 10-slice chain runs
  with no host sync); ``num_slices + 4`` fields with ``[K]`` last.

Both formats are byte-compatible with the JAX package's. Not ported yet:
``SpatialCodec``, the sharded functions and ``make_codec``'s cache.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
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
from compression_tpu_torch.models import bmshj2018, common, device_coding
from compression_tpu_torch.models.codec_base import HyperpriorCodec
from compression_tpu_torch.models.device_coding import (
    is_device_coded,
    pad_words,
    parse_blobs,
    rans_for,
)
from compression_tpu_torch.ops.math_ops import lower_bound
from compression_tpu_torch.ops.round_ops import round_st
from compression_tpu_torch.parallel.pipeline import staggered_map
from compression_tpu_torch.util.image import pad_to_multiple_np
from compression_tpu_torch.util.numeric import slim_int

__all__ = [
    "Config",
    "MS2020Model",
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
    num_slices: int = 10
    # Each slice conditions on at most this many previously decoded slices
    # (the first ones); bounds the slice transforms' input widths.
    max_support_slices: int = 5
    model_name: str = "ms2020-cc10"
    downscale: int = 64

    @property
    def slice_size(self) -> int:
        assert self.num_latents % self.num_slices == 0
        return self.num_latents // self.num_slices


def _conv(cin, cout, k, gen, activation=None, bias=True):
    return SignalConv2D(cin, cout, k, corr=True, padding="same_zeros",
                        use_bias=bias, activation=activation, generator=gen)


class HyperAnalysisTransform(nn.Module):
    """y -> z at the paper's widths: 320 -> 256 -> hyperlatents (the first
    width is 320 whatever y's depth)."""

    def __init__(self, num_latents: int, num_hyperlatents: int, gen: torch.Generator):
        super().__init__()
        self.conv0 = _conv(num_latents, 320, 3, gen, torch.relu)
        self.conv1 = bmshj2018._down(320, 256, 5, True, gen, torch.relu)
        self.conv2 = bmshj2018._down(256, num_hyperlatents, 5, False, gen)

    def forward(self, y):
        return self.conv2(self.conv1(self.conv0(y)))


class HyperSupportTransform(nn.Module):
    """z_hat -> a support feature field (one for the means, one for the
    scales): two up-convolutions 192 -> 256, then a 3x3 convolution."""

    def __init__(self, num_hyperlatents: int, num_out: int, gen: torch.Generator):
        super().__init__()
        self.conv0 = bmshj2018._up(num_hyperlatents, 192, 5, gen, torch.relu)
        self.conv1 = bmshj2018._up(192, 256, 5, gen, torch.relu)
        self.conv2 = _conv(256, num_out, 3, gen)

    def forward(self, z):
        return self.conv2(self.conv1(self.conv0(z)))


class SliceTransform(nn.Module):
    """A slice's mean, scale or LRP network: 5x5, 5x5, 3x3 convolutions,
    224 -> 128 -> out. ``zero_final`` zeroes the last kernel (the LRP
    transforms: residual prediction starts at exactly zero)."""

    def __init__(self, cin: int, num_out: int, gen: torch.Generator,
                 zero_final: bool = False):
        super().__init__()
        self.conv0 = _conv(cin, 224, 5, gen, torch.relu)
        self.conv1 = _conv(224, 128, 5, gen, torch.relu)
        self.conv2 = _conv(128, num_out, 3, gen)
        if zero_final:
            with torch.no_grad():
                self.conv2.weight.zero_()

    def forward(self, x):
        return self.conv2(self.conv1(self.conv0(x)))


class MS2020Model(nn.Module):
    """The transforms, the 3 x ``num_slices`` slice transforms and the
    factorized hyperprior's parameters.

    Submodule and parameter names follow the JAX package's param tree
    (``analysis``, ``synthesis``, ``hyper_analysis``, ``mean_support``,
    ``scale_support``, ``mean_t0..``, ``scale_t0..``, ``lrp_t0..``,
    ``hyperprior``), so :func:`compression_tpu_torch.convert.params_from_numpy`
    maps a flax checkpoint onto ``load_state_dict``. The initial weights
    are drawn from one generator seeded with ``seed``.
    """

    def __init__(self, config: Config = Config(), seed: int = 0):
        super().__init__()
        self.config = cfg = config
        s = cfg.slice_size
        gen = torch.Generator().manual_seed(seed)
        self.analysis = bmshj2018.AnalysisTransform(cfg.num_filters, cfg.num_latents, gen)
        self.synthesis = bmshj2018.SynthesisTransform(cfg.num_filters, cfg.num_latents, gen)
        self.hyper_analysis = HyperAnalysisTransform(cfg.num_latents, cfg.num_hyperlatents, gen)
        self.mean_support = HyperSupportTransform(cfg.num_hyperlatents, cfg.num_latents, gen)
        self.scale_support = HyperSupportTransform(cfg.num_hyperlatents, cfg.num_latents, gen)
        for i in range(cfg.num_slices):
            cin = cfg.num_latents + s * len(self._support(list(range(i))))
            self.add_module(f"mean_t{i}", SliceTransform(cin, s, gen))
            self.add_module(f"scale_t{i}", SliceTransform(cin, s, gen))
            self.add_module(f"lrp_t{i}", SliceTransform(cin + s, s, gen, zero_final=True))
        self.hyperprior = DeepFactorizedPrior((cfg.num_hyperlatents,), generator=gen)
        self._main_em = LocationScaleIndexedEntropyModel(NoisyNormal, coding_rank=3)

    # -- slice machinery -------------------------------------------------------

    def _support(self, decoded: List) -> List:
        """The context of a slice: the first ``max_support_slices`` decoded
        slices (all of them when it is negative)."""
        m = self.config.max_support_slices
        return decoded if m < 0 else decoded[:m]

    def slice_params(self, i: int, mu_sup, sigma_sup, decoded: List):
        """(mu_i, sigma_i) from the supports and the previously decoded
        slices; sigma through ``lower_bound`` (its gradient pushes sigma up
        where it starts below the scale table's floor)."""
        support = self._support(decoded)
        mu = getattr(self, f"mean_t{i}")(torch.cat([mu_sup] + support, -1))
        sigma = getattr(self, f"scale_t{i}")(torch.cat([sigma_sup] + support, -1))
        return mu, lower_bound(sigma, SCALES_MIN)

    def slice_lrp(self, i: int, mu_sup, decoded_with_current: List):
        """Latent residual prediction, bounded to half a bin: the context is
        the mean support, the (capped) previous slices and the slice just
        decoded, last."""
        ctx = torch.cat([mu_sup] + self._support(decoded_with_current[:-1])
                        + decoded_with_current[-1:], -1)
        return 0.5 * torch.tanh(getattr(self, f"lrp_t{i}")(ctx))

    # -- training forward ------------------------------------------------------

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                training: bool = True):
        """x in [0, 1] (N, H, W, 3) -> ``(x_hat, y_bits, z_bits)``, bits per
        image. With ``training`` the rates are taken under U(-1/2, 1/2) noise
        from ``generator`` (z's, then each slice's), otherwise at the rounded
        values; the supports read z rounded on its prior's offset grid, and
        every later slice and the synthesis read ``round(y_i - mu_i) + mu_i``
        plus the LRP, with straight-through gradients."""
        s = self.config.slice_size
        y = self.analysis(x)
        z = self.hyper_analysis(y)
        side_em = ContinuousBatchedEntropyModel(self.hyperprior(), coding_rank=3)
        _, z_bits = side_em(z, generator, training)
        mu_sup, sigma_sup = self.supports_from_zhat(side_em.quantize(z))
        decoded: List[torch.Tensor] = []
        y_bits = 0.0
        for i in range(self.config.num_slices):
            y_i = y[..., i * s : (i + 1) * s]
            mu, sigma = self.slice_params(i, mu_sup, sigma_sup, decoded)
            _, bits_i = self._main_em(y_i, sigma, loc=mu, generator=generator,
                                      training=training)
            y_bits = y_bits + bits_i
            y_hat_i = round_st(y_i - mu) + mu
            decoded.append(y_hat_i + self.slice_lrp(i, mu_sup, decoded + [y_hat_i]))
        return self.synthesis(torch.cat(decoded, -1)), y_bits, z_bits

    # -- coding entry points ---------------------------------------------------

    def encode_latents(self, x):
        """x in [0, 1] (N, H, W, 3) -> (y, z)."""
        y = self.analysis(x)
        return y, self.hyper_analysis(y)

    def supports_from_zhat(self, z_hat):
        return self.mean_support(z_hat), self.scale_support(z_hat)

    def synthesize(self, y_hat):
        return self.synthesis(y_hat)


def make_loss_fn(model: MS2020Model, training: bool = True):
    """``loss_fn(batch, generator) -> (loss, {"bpp", <metric>})``: bits per
    pixel (y and z) plus ``lmbda`` times the configured distortion."""
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
    model = MS2020Model(cfg, seed=train_cfg.seed)
    if params is not None:
        model.load_state_dict(params)
    return common.train_model(model, make_loss_fn(model), train_cfg, device=device)


def load_model(path, config: Config = Config()) -> MS2020Model:
    """Builds the model and loads a flax msgpack checkpoint (on the CPU)."""
    from compression_tpu_torch.convert import load_flax_msgpack, params_from_numpy

    model = MS2020Model(config)
    model.load_state_dict(params_from_numpy(load_flax_msgpack(path)))
    return model


class Codec(HyperpriorCodec):
    """The trained model on a device, plus its CDF tables (``side`` from
    the hyperprior, ``main`` the NoisyNormal scale-indexed table), as a
    codec with both coders.

    Encode is one asynchronous device chain on the codec's stream (with K3
    once a slice for the device coder), then one wait. Decode runs the batch
    in lockstep, slice by slice: the host coder fetches each slice's rows
    and range-decodes them (a host round trip a slice, not an image); the
    device coder runs K2 once a slice and the whole chain without a host
    sync until the image and the ok flags come back.

    Encode/decode agreement: every value the decoder must reproduce, from
    z_hat to each slice's rows and decoded values, comes from functions
    both sides call, one image at a time, so cuDNN sees the same shapes at
    any batch size: ``_supports``, ``_slice_rows`` (the slice's mean and
    rows), ``_center_round`` / ``_apply_loc``, and ``_finish_slices`` (the
    LRP). A decoded slice feeds every later slice's context, so one ulp of
    difference would corrupt the rest.

    Args:
      model: an :class:`MS2020Model` (moved to ``device``).
      device: ``"cuda"`` (default; raises if absent) or ``"cpu"``.
      tables: optional ``{"side": CdfTables, "main": CdfTables}`` to use
        instead of building them from the model.
    """

    # -- shared device functions ---------------------------------------------

    def _front(self, x_uint8: torch.Tensor):
        """uint8 images on the device -> (y, z symbols, z_hat)."""
        y, z = self.model.encode_latents(x_uint8.to(torch.float32) / 255.0)
        return (y, *self._z_symbols(z))

    def _streams(self, a):
        """One y stream a slice: the channel slices of ``a``."""
        s = self.cfg.slice_size
        return [a[..., i * s : (i + 1) * s] for i in range(self.cfg.num_slices)]

    def _supports(self, z_hat: torch.Tensor) -> list:
        """z_hat -> each image's (mean support, scale support)."""
        return [self.model.supports_from_zhat(z_hat[b : b + 1])
                for b in range(z_hat.shape[0])]

    def _slice_rows(self, i: int, sups: list, decoded: list):
        """Slice i's (mu, uint8 CDF rows) for the batch, from each image's
        supports and decoded slices; encode and decode both call this."""
        mus, sigmas = zip(*(self.model.slice_params(i, mu_sup, sigma_sup, dec)
                            for (mu_sup, sigma_sup), dec in zip(sups, decoded)))
        return torch.cat(mus), self.em.rows(torch.cat(sigmas))

    def _finish_slices(self, i: int, sups: list, decoded: list, y_hat_i) -> None:
        """Adds slice i's LRP to its values ``y_hat_i`` (``values + mu``) and
        appends the result to each image's decoded slices; encode and
        decode both call this."""
        for b, ((mu_sup, _), dec) in enumerate(zip(sups, decoded)):
            y = y_hat_i[b : b + 1]
            dec.append(y + self.model.slice_lrp(i, mu_sup, dec + [y]))

    def _encode_slices(self, images: np.ndarray):
        """Pads and uploads uint8 images and enqueues the whole slice chain:
        ``(symbols, z symbols, rows, (H, W))``, symbols and rows one tensor
        a slice."""
        x, hw = pad_to_multiple_np(np.asarray(images, np.uint8), self.cfg.downscale)
        y, z_sym, z_hat = self._front(self._to_device(x))
        sups = self._supports(z_hat)
        decoded: list = [[] for _ in sups]
        syms, rows = [], []
        for i, y_i in enumerate(self._streams(y)):
            mu, rows_i = self._slice_rows(i, sups, decoded)
            sym = self._center_round(y_i, mu)
            self._finish_slices(i, sups, decoded, self._apply_loc(sym, mu))
            syms.append(sym)
            rows.append(rows_i)
        return syms, z_sym, rows, hw

    # -- encode ----------------------------------------------------------------

    def _dispatch_encode(self, images: np.ndarray):
        """Host coder's device stage: the chain, then one set of copies."""
        with self.timer.stage("enc/dispatch"):
            syms, z_sym, rows, hw = self._encode_slices(images)
            return self._host_coder_work(torch.cat(syms, -1), z_sym,
                                         torch.cat(rows, -1), hw)

    def _dispatch_encode_rans(self, images: np.ndarray):
        """Device coder's device stage: the chain and K3 once a slice; the
        streams stay on the device, their lengths and overflow flags and
        the z symbols start their copies to the host."""
        with self.timer.stage("enc/dispatch"):
            syms, z_sym, rows, hw = self._encode_slices(images)
            n = len(syms[0])
            enc, _dec, K, _cap = rans_for(self, syms[0][0].numel())
            coded = [enc(sym.reshape(n, -1), r.reshape(n, -1)) for sym, r in zip(syms, rows)]
            streams, lengths, overflow = (list(c) for c in zip(*coded))
            return device_coding.rans_work(self, streams, lengths, overflow, z_sym, hw, K)

    # -- decode ----------------------------------------------------------------

    def _is_device_coded(self, blob: bytes) -> bool:
        return is_device_coded(blob, self.cfg.num_slices)

    def _decode_front(self, blobs: List[bytes], device: bool):
        """Parses one coder's blobs, host-decodes z; each image's supports."""
        with self.timer.stage("dec/parse"):
            streams, z_strings, xshape, zshape, K = parse_blobs(
                blobs, self.cfg.num_slices, device)
        with self.timer.stage("dec/code_z"):
            z_hat = self.side_em.decompress(z_strings, tuple(int(v) for v in zshape))
        return streams, self._supports(self._to_device(z_hat)), xshape, K

    def _finish_image(self, decoded: list, xshape, ok=None) -> np.ndarray:
        """Synthesizes the decoded slices and fetches the image (and the
        rANS ok flags); raises on a bad final rANS state."""
        with self.timer.stage("dec/synth"):
            y_hat = torch.cat([torch.cat(dec, -1) for dec in decoded])
            image = self._to_host(self._synthesize(y_hat))
            ok = None if ok is None else self._to_host(torch.stack(ok))
            event = self._event()
        with self.timer.stage("dec/fetch_image"):
            if event is not None:
                event.synchronize()
            image = image.numpy()
        if ok is not None and not ok.cpu().numpy().all():
            raise ValueError("corrupt device-coded bitstream (rANS state)")
        return image[:, : int(xshape[0]), : int(xshape[1]), :]

    def _decompress_host(self, blobs: List[bytes]) -> np.ndarray:
        strings, sups, xshape, _ = self._decode_front(blobs, device=False)
        n = len(blobs)
        decoded: list = [[] for _ in range(n)]
        for i, slice_strings in enumerate(strings):
            with self.timer.stage("dec/slice_rows"):
                mu, rows = self._slice_rows(i, sups, decoded)
                rows = self._to_host(rows)
                event = self._event()
            with self.timer.stage("dec/fetch_rows"):
                if event is not None:
                    event.synchronize()
                rows = rows.numpy()
            with self.timer.stage("dec/code_y"):
                values = self.em.decode_symbols(slice_strings, rows.reshape(n, -1))
            with self.timer.stage("dec/finish_slice"):
                values = self._to_device(slim_int(values.reshape(mu.shape)))
                self._finish_slices(i, sups, decoded, self._apply_loc(values, mu))
        return self._finish_image(decoded, xshape)

    def _decompress_rans(self, blobs: List[bytes]) -> np.ndarray:
        words, sups, xshape, K = self._decode_front(blobs, device=True)
        n = len(blobs)
        decoded: list = [[] for _ in range(n)]
        oks = []
        with self.timer.stage("dec/dispatch"):
            for i, slice_words in enumerate(words):
                mu, rows = self._slice_rows(i, sups, decoded)
                _enc, dec, _K, _cap = rans_for(self, rows[0].numel(), K)
                values, ok = dec(self._to_device(pad_words(slice_words)), rows.reshape(n, -1))
                oks.append(ok)
                self._finish_slices(i, sups, decoded,
                                    self._apply_loc(values.reshape(mu.shape), mu))
        return self._finish_image(decoded, xshape, oks)

    def decompress_batch(self, blobs: List[bytes]) -> np.ndarray:
        """Decodes same-size .tfci blobs in lockstep, slice by slice (either
        coder's format, detected from the blobs)."""
        with self._on_device():
            if self._is_device_coded(blobs[0]):
                return self._decompress_rans(blobs)
            return self._decompress_host(blobs)

    def decompress_iter(self, blob_batches, depth: int = 2):
        """Decodes an iterable of blob lists with ``depth`` batches in flight
        on worker threads: while the host range-decodes one batch's slice,
        the device computes another batch's slice parameters."""
        yield from staggered_map(self.decompress_batch, blob_batches, depth)
