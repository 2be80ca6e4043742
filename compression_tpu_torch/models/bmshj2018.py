"""bmshj2018: the scale-hyperprior image codec (counterpart of
``compression_tpu/models/bmshj2018.py``: the four transforms, training,
and ``Codec`` with both entropy coders).

A 4-layer GDN analysis/synthesis pair for the latent y, and a hyper pair
producing a per-element scale sigma for y. z is coded with a factorized
prior, y with the scale-indexed NoisyNormal tables, by one of two coders:

* ``coder="host"``: the C++ range coder on the host; each image becomes a
  4-field ``.tfci`` blob ``[y_string, z_string, xshape, zshape]``;
* ``coder="device"``: y is K-lane rANS-coded on the card (kernels K3/K2,
  :mod:`compression_tpu_torch.codec.rans`), z on the host; each image
  becomes a 5-field blob ``[y_words, z_string, xshape, zshape, [K]]``.

Both formats are byte-compatible with the JAX package's blobs, and the
decoder detects the format per batch.

Training: ``model(x, generator, training)`` gives ``(x_hat, y_bits,
z_bits)``, :func:`make_loss_fn` the rate-distortion loss and :func:`train`
runs :func:`compression_tpu_torch.models.common.train_model`. In training
the hyper-synthesis runs on the whole batch; the codec runs it one image at
a time for the bitstream's sake.

Layouts at the public boundary are the JAX package's: images NHWC uint8,
latents ``(N, h, w, C)``. :func:`make_codec` keeps one codec per model
and device; the codec reads its tables through the table disk cache
(:mod:`compression_tpu_torch.models.codec_cache`).
``Codec.decompress_batch_jit`` is the JAX package's single-program decode,
its device segments captured as CUDA graphs. The ``sharded_*`` functions
run the transforms with H sharded over a mesh, and :class:`SpatialCodec`
codes one image through them
(:mod:`compression_tpu_torch.parallel.spatial`).
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
from compression_tpu_torch.layers import GDN, SignalConv2D
from compression_tpu_torch.layers.priors import DeepFactorizedPrior
from compression_tpu_torch.models import common
from compression_tpu_torch.models.codec_base import HyperpriorCodec
from compression_tpu_torch.models.codec_cache import cached
from compression_tpu_torch.models.device_coding import (
    StreamOverflow,
    decompress_batch_rans,
    is_device_coded,
    parse_host_blobs,
)
from compression_tpu_torch.ops.math_ops import lower_bound
from compression_tpu_torch.models.spatial_codec import SpatialCodecBase
from compression_tpu_torch.parallel.pipeline import Work
from compression_tpu_torch.parallel.spatial import (
    as_shards,
    map_shards,
    sharded_transform_apply,
)
from compression_tpu_torch.util.graphs import Segment

__all__ = [
    "Config",
    "BMSHJ2018Model",
    "Codec",
    "SpatialCodec",
    "compress",
    "decompress",
    "load_model",
    "make_codec",
    "make_loss_fn",
    "sharded_analyze",
    "sharded_encode_latents",
    "sharded_hyper_analyze",
    "sharded_sigma",
    "sharded_synthesize",
    "train",
]


@dataclasses.dataclass(frozen=True)
class Config:
    lmbda: float = 0.01
    distortion: str = "mse"        # "mse" | "msssim"
    num_filters: int = 192      # transform width
    num_latents: int = 192      # channels of y
    num_hyperlatents: int = 128  # channels of z
    model_name: str = "bmshj2018-hyperprior"
    downscale: int = 64          # 16 (analysis) * 4 (hyper-analysis)


def _down(cin, cout, k, bias, gen, activation=None):
    return SignalConv2D(cin, cout, k, corr=True, strides_down=2,
                        padding="same_zeros", use_bias=bias,
                        activation=activation, generator=gen)


def _up(cin, cout, k, gen, activation=None):
    return SignalConv2D(cin, cout, k, corr=False, strides_up=2,
                        padding="same_zeros", use_bias=True,
                        activation=activation, generator=gen)


class AnalysisTransform(nn.Module):
    def __init__(self, num_filters: int, num_latents: int, gen: torch.Generator):
        super().__init__()
        for i in range(3):
            self.add_module(f"conv{i}", _down(3 if i == 0 else num_filters,
                                              num_filters, 5, True, gen))
            self.add_module(f"gdn{i}", GDN(num_filters))
        self.conv3 = _down(num_filters, num_latents, 5, False, gen)

    def forward(self, x):
        for i in range(3):
            x = getattr(self, f"gdn{i}")(getattr(self, f"conv{i}")(x))
        return self.conv3(x)


class SynthesisTransform(nn.Module):
    def __init__(self, num_filters: int, num_latents: int, gen: torch.Generator):
        super().__init__()
        for i in range(3):
            self.add_module(f"conv{i}", _up(num_latents if i == 0 else num_filters,
                                            num_filters, 5, gen))
            self.add_module(f"igdn{i}", GDN(num_filters, inverse=True))
        self.conv3 = _up(num_filters, 3, 5, gen)

    def forward(self, y):
        for i in range(3):
            y = getattr(self, f"igdn{i}")(getattr(self, f"conv{i}")(y))
        return self.conv3(y)


class HyperAnalysisTransform(nn.Module):
    def __init__(self, num_filters: int, num_latents: int, num_hyperlatents: int,
                 gen: torch.Generator):
        super().__init__()
        self.conv0 = SignalConv2D(num_latents, num_filters, 3, corr=True,
                                  padding="same_zeros", use_bias=True,
                                  activation=torch.relu, generator=gen)
        self.conv1 = _down(num_filters, num_filters, 5, True, gen, torch.relu)
        self.conv2 = _down(num_filters, num_hyperlatents, 5, False, gen)

    def forward(self, y):
        return self.conv2(self.conv1(self.conv0(torch.abs(y))))


class HyperSynthesisTransform(nn.Module):
    """z_hat -> sigma, bounded below by the scale table's lower edge."""

    def __init__(self, num_filters: int, num_latents: int, num_hyperlatents: int,
                 gen: torch.Generator):
        super().__init__()
        self.conv0 = _up(num_hyperlatents, num_filters, 5, gen, torch.relu)
        self.conv1 = _up(num_filters, num_filters, 5, gen, torch.relu)
        self.conv2 = SignalConv2D(num_filters, num_latents, 3, corr=True,
                                  padding="same_zeros", use_bias=True,
                                  generator=gen)

    def forward(self, z):
        sigma = self.conv2(self.conv1(self.conv0(z)))
        # lower_bound (identity-if-towards), not a hard max: at init sigma is
        # below SCALES_MIN almost everywhere, and a max would cut every rate
        # gradient into the hyper-synthesis.
        return lower_bound(sigma, SCALES_MIN)


class BMSHJ2018Model(nn.Module):
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
        self.analysis = AnalysisTransform(cfg.num_filters, cfg.num_latents, gen)
        self.synthesis = SynthesisTransform(cfg.num_filters, cfg.num_latents, gen)
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
        image. ``training`` adds U(-1/2, 1/2) noise to z, then to y, from
        ``generator`` (on x's device); otherwise both are rounded with
        straight-through gradients (z on its prior's offset grid)."""
        y = self.analysis(x)
        z = self.hyper_analysis(y)
        side_em = ContinuousBatchedEntropyModel(self.hyperprior(), coding_rank=3)
        z_tilde, z_bits = side_em(z, generator, training)
        sigma = self.hyper_synthesis(z_tilde)
        y_tilde, y_bits = self._main_em(y, sigma, generator=generator,
                                        training=training)
        return self.synthesis(y_tilde), y_bits, z_bits

    def encode_latents(self, x):
        """x in [0, 1] (N, H, W, 3) -> (y, z)."""
        y = self.analysis(x)
        return y, self.hyper_analysis(y)

    def sigma_from_zhat(self, z_hat):
        return self.hyper_synthesis(z_hat)

    def synthesize(self, y_hat):
        return self.synthesis(y_hat)


def make_loss_fn(model: BMSHJ2018Model, training: bool = True):
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
    model = BMSHJ2018Model(cfg, seed=train_cfg.seed)
    if params is not None:
        model.load_state_dict(params)
    return common.train_model(model, make_loss_fn(model), train_cfg,
                              device=device)


def load_model(path, config: Config = Config()) -> BMSHJ2018Model:
    """Builds the model and loads a flax msgpack checkpoint (on the CPU)."""
    from compression_tpu_torch.convert import load_flax_msgpack, params_from_numpy

    model = BMSHJ2018Model(config)
    model.load_state_dict(params_from_numpy(load_flax_msgpack(path)))
    return model


class Codec(HyperpriorCodec):
    """The trained model on a device, plus its CDF tables, as a codec.

    Structure (as in the JAX package; the batch API, both coders' stages
    and the pipelined iterators come from
    :class:`~compression_tpu_torch.models.codec_base.HyperpriorCodec`):

    * encode: one asynchronous device chain on the codec's CUDA stream
      (transforms -> symbols -> z_hat -> sigma -> CDF rows), ending in
      non-blocking copies to pinned host memory; then the host range-codes
      (``coder="host"``), or the chain goes on through the rANS encoder
      K3 and only the compressed y words come back (``coder="device"``);
    * :meth:`compress_iter` / :meth:`decompress_iter` double-buffer batches
      through :class:`~compression_tpu_torch.parallel.pipeline.Pipeline`;
    * every stage is accounted in ``self.timer``;
    * :meth:`decompress_batch_jit` is the single-program decode: the host
      decodes z and y, and the device segments between them run as CUDA
      graphs, one program a ``(n, zshape)`` key in ``self._jit_decoders``.

    Bit-exactness: what the decoder must reproduce (z_hat -> sigma -> rows)
    goes through one function shared by both paths, ``_rows``, which runs
    the hyper-synthesis one image at a time, so the convolutions see the
    same shapes (and cuDNN the same algorithms) whatever the batch size;
    z_hat is ``int symbols + f32 offset`` on both sides. On CUDA the codec
    pins float32 math (no TF32) and deterministic cuDNN
    (:func:`~compression_tpu_torch.util.device.strict_fp32`).

    Args:
      model: a :class:`BMSHJ2018Model` (moved to ``device``).
      device: ``"cuda"`` (default; raises if absent) or ``"cpu"``.
      tables: optional ``{"side": CdfTables, "main": CdfTables}`` to use
        instead of building them from the model.
    """

    def __init__(self, model: BMSHJ2018Model, device="cuda", tables=None):
        super().__init__(model, device, tables)
        self._jit_decoders: dict = {}

    # -- shared device functions ---------------------------------------------

    def _front(self, x_uint8: torch.Tensor):
        x = x_uint8.to(torch.float32) / 255.0
        y, z = self.model.encode_latents(x)
        z_sym, z_hat = self._z_symbols(z)
        return torch.round(y).to(torch.int32), z_sym, z_hat

    def _rows(self, z_hat: torch.Tensor) -> torch.Tensor:
        """z_hat -> uint8 CDF rows; encode and decode both call this."""
        sigma = torch.cat([
            self.model.sigma_from_zhat(z_hat[i : i + 1])
            for i in range(z_hat.shape[0])
        ])
        return self.em.rows(sigma)

    def _mu_rows(self, z_hat: torch.Tensor):
        return None, self._rows(z_hat)

    # -- device-coded path (rANS on the card; codec/rans.py) -----------------
    #
    # y is entropy-coded on the card by K3 and decoded by K2, so only the
    # compressed words cross to the host (and at decode the symbols never
    # do). z stays host-coded: it is tiny, and the decoder needs it on the
    # host first anyway. The symbols and rows come from the same _front and
    # _rows as the host path, so the two coders agree on every value; only
    # the bitstream differs (see codec/rans_ref.py).

    def _finish_encode_rans(self, w: Work) -> List[bytes]:
        try:
            return super()._finish_encode_rans(w)
        except StreamOverflow:
            # Pathological symbol statistics (e.g. an untrained model
            # escaping everywhere at extreme magnitudes) overflow the
            # stream's capacity: code this batch with the host coder, from
            # the same device symbols and rows, as the JAX package's
            # bmshj2018 does (its mean-scale codecs raise instead).
            return self._finish_encode(
                self._host_coder_work(w.sym, w.z_sym, w.rows, w.hw))

    # -- the single-program decode (JAX's decompress_batch_jit) --------------
    #
    # The JAX package decodes a batch in ONE jitted program: z range-decode
    # -> z_hat -> sigma -> CDF rows -> y range-decode -> synthesis -> uint8,
    # the two range decodes host callbacks over fixed-capacity buffers
    # (codec/jax_ops.py), whose capacity buckets are part of the program's
    # key because XLA needs static shapes. Here the host decodes the strings
    # as they are, so only the device segments between the two decodes
    # have shapes: they are CUDA graphs, captured once per (n, zshape). The
    # rows come from the codec's own _rows (one image at a time), so the
    # bytes are decompress_batch's.

    def decompress_batch_jit(self, blobs: list) -> np.ndarray:
        """Same-size .tfci blobs through the single-program decoder;
        device-coded blobs go to the rANS decode (K2), which is already one
        device program."""
        with self._on_device():
            if is_device_coded(blobs[0]):
                return decompress_batch_rans(self, blobs)
            y_strings, z_strings, xshape, zshape = parse_host_blobs(blobs)
            key = (len(blobs), tuple(int(v) for v in zshape))
            program = self._jit_decoders.get(key)
            if program is None:
                program = self._jit_decoders[key] = _JitDecoder(self, *key)
            x_hat = program(z_strings, y_strings)
        return x_hat[:, : int(xshape[0]), : int(xshape[1]), :]


class _JitDecoder:
    """One decode program for ``n`` images of latent grid ``zshape``
    (counterpart of the JAX ``Codec._build_jit_decoder``'s program): the
    host decodes z, the first device segment (``_rows``) gives the CDF
    rows, the host decodes y, the second (``_synthesize``) gives uint8
    images. On the card both segments are CUDA graphs on the codec's
    stream (:class:`~compression_tpu_torch.util.graphs.Segment`)."""

    def __init__(self, codec: Codec, n: int, zshape):
        self.codec, self.zshape = codec, tuple(zshape)
        dev = codec.device
        z_unit = (n,) + self.zshape + codec.side_em.prior_batch_shape
        yshape = (n, zshape[0] * 4, zshape[1] * 4, codec.cfg.num_latents)
        self.rows = Segment(codec._rows, [torch.empty(z_unit, device=dev)], codec.stream)
        self.synth = Segment(lambda v: codec._synthesize(codec._apply_loc(v, None)),
                             [torch.empty(yshape, dtype=torch.int32, device=dev)],
                             codec.stream)

    def _host_input(self, a: np.ndarray) -> torch.Tensor:
        """A segment's argument: pinned on the card's host, so that the copy
        into the static input does not wait for the whole stream."""
        t = torch.from_numpy(a)
        return t.pin_memory() if self.codec.device.type == "cuda" else t

    def __call__(self, z_strings, y_strings) -> np.ndarray:
        codec = self.codec
        with codec.timer.stage("jit/code_z"):
            # z_hat exactly as the encoder formed it: int symbols + f32 offset.
            z_hat = codec.side_em.decompress(z_strings, self.zshape)
        with codec.timer.stage("jit/rows"):
            rows = codec._to_host(self.rows(self._host_input(z_hat)))
            event = codec._event()
            if event is not None:
                event.synchronize()
        with codec.timer.stage("jit/code_y"):
            rows = rows.numpy()
            values = codec.em.decode_symbols(y_strings, rows).reshape(rows.shape)
        with codec.timer.stage("jit/synth"):
            image = codec._to_host(self.synth(self._host_input(values)))
            event = codec._event()
            if event is not None:
                event.synchronize()
        return image.numpy()


def make_codec(model: BMSHJ2018Model, device="cuda") -> Codec:
    """The model's :class:`Codec` on ``device``, built once for the model,
    its weights and the device
    (:func:`~compression_tpu_torch.models.codec_cache.cached`)."""
    return cached(model, lambda: Codec(model, device), device)


def compress(model: BMSHJ2018Model, image: np.ndarray, coder: str = "host",
             device="cuda") -> bytes:
    """uint8 (H, W, 3) image -> .tfci blob, from the host range coder
    (``"host"``) or the card's rANS (``"device"``)."""
    return make_codec(model, device).compress(image, coder)


def decompress(model: BMSHJ2018Model, data: bytes, device="cuda") -> np.ndarray:
    return make_codec(model, device).decompress(data)


# -- spatially sharded transforms (images too large for one device) -----------


def sharded_analyze(model: BMSHJ2018Model, x, mesh, axis="data"):
    """H-sharded analysis: x (N, H, W, 3) in [0, 1], or its shards -> y's
    shards. H must divide ``mesh size * 16`` (four stride-2 levels)."""
    return sharded_transform_apply(model.analysis, x, mesh, axis)


def sharded_synthesize(model: BMSHJ2018Model, y_hat, mesh, axis="data"):
    """H-sharded synthesis: y_hat (N, h, w, C) or its shards -> x_hat's
    shards (16x up-sampled; h divisible by the mesh size, at least 2 rows
    a shard for the 5x5 halos)."""
    return sharded_transform_apply(model.synthesis, y_hat, mesh, axis)


def sharded_hyper_analyze(model: BMSHJ2018Model, y, mesh, axis="data"):
    """H-sharded hyper-analysis: y -> z's shards (|y| in)."""
    return sharded_transform_apply(
        model.hyper_analysis, map_shards(torch.abs, as_shards(y, mesh, axis)), mesh, axis)


def sharded_sigma(model: BMSHJ2018Model, z_hat, mesh, axis="data"):
    """H-sharded hyper-synthesis: z_hat -> sigma's shards (>= SCALES_MIN)."""
    return map_shards(lambda s: lower_bound(s, SCALES_MIN), sharded_transform_apply(
        model.hyper_synthesis, z_hat, mesh, axis))


def sharded_encode_latents(model: BMSHJ2018Model, x, mesh, axis="data"):
    """The encode front (x -> y -> z) H-sharded over the mesh (H divisible
    by ``mesh size * 64``); returns the shards of y and of z."""
    y = sharded_analyze(model, x, mesh, axis)
    return y, sharded_hyper_analyze(model, y, mesh, axis)


class SpatialCodec(SpatialCodecBase):
    """Giant-image codec: one image, its four transforms H-sharded over
    ``mesh``, the host range coder on the latents; the standard 4-field
    blob (:class:`~compression_tpu_torch.models.spatial_codec.SpatialCodecBase`).
    z_hat -> sigma -> rows is one sharded function on both sides.

    Args:
      model: a :class:`BMSHJ2018Model` (moved to ``mesh.devices[0]``).
      mesh: the shards' devices
        (:func:`~compression_tpu_torch.parallel.data_parallel.make_mesh`).
    """

    def __init__(self, model: BMSHJ2018Model, mesh, axis="data"):
        super().__init__(make_codec(model, mesh.devices[0]), mesh, axis)

    def _front(self, x):
        return sharded_encode_latents(self.model, x, self.mesh, self.axis)

    def _mu_rows(self, z_hat):
        return None, map_shards(self.codec.em.rows,
                                sharded_sigma(self.model, z_hat, self.mesh, self.axis))

    def _synth(self, y_hat):
        return sharded_synthesize(self.model, y_hat, self.mesh, self.axis)
