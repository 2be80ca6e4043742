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
latents ``(N, h, w, C)``. Not ported yet: ``decompress_batch_jit``,
``SpatialCodec``, the sharded transforms, and the table disk cache.
"""

from __future__ import annotations

import contextlib
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
from compression_tpu_torch.models.device_coding import (
    fetch_streams,
    is_device_coded,
    pad_words,
    parse_device_blobs,
    parse_host_blobs,
    rans_for,
)
from compression_tpu_torch.ops.math_ops import lower_bound
from compression_tpu_torch.parallel.pipeline import Pipeline, stream_context
from compression_tpu_torch.util import PackedTensors
from compression_tpu_torch.util.device import resolve_device, strict_fp32
from compression_tpu_torch.util.image import pad_to_multiple_np
from compression_tpu_torch.util.numeric import slim_int
from compression_tpu_torch.util.profiling import StageTimer

__all__ = [
    "Config",
    "BMSHJ2018Model",
    "Codec",
    "load_model",
    "make_loss_fn",
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


class _EncodeWork:
    """In-flight encode: host copies (filled once ``event`` fires) and the
    device symbols kept for the rare wider refetch."""

    __slots__ = ("y8", "z16", "rows", "fits", "y32", "z32", "event", "hw", "n")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


class _DecodeWork:
    __slots__ = ("rows", "event", "y_strings", "shape", "xshape")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


class _RansEncodeWork:
    """In-flight device-coded encode: the rANS stream on the device, host
    copies of its lengths/overflow flags and of z, and the device symbols
    and rows kept for the host-coder fall-back on overflow."""

    __slots__ = ("stream", "lengths", "overflow", "z16", "fit16", "y32",
                 "z32", "rows", "event", "hw", "K")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


class _RansDecodeWork:
    __slots__ = ("image", "ok", "event", "xshape")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


class Codec:
    """The trained model on a device, plus its CDF tables, as a codec.

    Structure (as in the JAX package):

    * encode: one asynchronous device chain on the codec's CUDA stream
      (transforms -> symbols -> z_hat -> sigma -> CDF rows), ending in
      non-blocking copies to pinned host memory; then the host range-codes
      (``coder="host"``), or the chain goes on through the rANS encoder
      K3 and only the compressed y words come back (``coder="device"``);
    * :meth:`compress_iter` / :meth:`decompress_iter` double-buffer batches
      through :class:`~compression_tpu_torch.parallel.pipeline.Pipeline`;
    * every stage is accounted in ``self.timer``.

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
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            strict_fp32()
            self.stream = torch.cuda.Stream(self.device)
        else:
            self.stream = None
        self.cfg = model.config
        self.model = model.to(self.device).eval()
        self.timer = StageTimer(self.device)
        tables = tables or {}
        self.side_em = ContinuousBatchedEntropyModel(
            model.hyperprior(device="cpu"), coding_rank=3, compression=True,
            tables=tables.get("side"),
        )
        self.em = LocationScaleIndexedEntropyModel(
            NoisyNormal, coding_rank=3, compression=True,
            tables=tables.get("main"),
        )
        self._z_off = self.side_em.symbol_offset(self.device)

    @contextlib.contextmanager
    def _on_device(self):
        with stream_context(self.stream), torch.inference_mode():
            yield

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """Starts a non-blocking upload from pinned host memory (CUDA). A
        pageable copy would wait for the whole stream, including the other
        pipeline stage's work."""
        t = torch.from_numpy(a)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        """Starts a non-blocking copy into pinned host memory (CUDA)."""
        if self.device.type != "cuda":
            return t
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return out.copy_(t, non_blocking=True)

    def _event(self):
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record()
        return event

    # -- shared device functions ---------------------------------------------

    def _front(self, x_uint8: torch.Tensor):
        x = x_uint8.to(torch.float32) / 255.0
        y, z = self.model.encode_latents(x)
        z_sym = torch.round(z - self._z_off).to(torch.int32)
        y_sym = torch.round(y).to(torch.int32)
        # z_hat exactly as the decoder forms it: int symbols + f32 offset.
        z_hat = z_sym.to(torch.float32) + self._z_off
        return y_sym, z_sym, z_hat

    def _rows(self, z_hat: torch.Tensor) -> torch.Tensor:
        """z_hat -> uint8 CDF rows; encode and decode both call this."""
        sigma = torch.cat([
            self.model.sigma_from_zhat(z_hat[i : i + 1])
            for i in range(z_hat.shape[0])
        ])
        return self.em.rows(sigma)

    def _synthesize(self, y_hat: torch.Tensor) -> torch.Tensor:
        x = self.model.synthesize(y_hat.to(torch.float32))
        return torch.clamp(torch.round(x * 255.0), 0, 255).to(torch.uint8)

    # -- encode pipeline stages ----------------------------------------------

    def _dispatch_encode(self, images: np.ndarray) -> _EncodeWork:
        """Device stage: pad, upload, enqueue the encode chain and the
        copies of its results to the host. Returns without waiting."""
        x, hw = pad_to_multiple_np(np.asarray(images, np.uint8),
                                   self.cfg.downscale)
        with self.timer.stage("enc/dispatch"):
            y_sym, z_sym, z_hat = self._front(self._to_device(x))
            work = self._host_coder_work(y_sym, z_sym, self._rows(z_hat), hw)
        return work

    def _host_coder_work(self, y_sym, z_sym, rows, hw) -> _EncodeWork:
        """Enqueues the copies the host coder needs: symbols in the
        narrowest type that holds them, rows, and the range checks."""
        fit8 = torch.all(torch.abs(y_sym) <= 127)
        fit16 = torch.all(torch.abs(y_sym) <= 32767) & torch.all(
            torch.abs(z_sym) <= 32767)
        return _EncodeWork(
            y8=self._to_host(y_sym.to(torch.int8)),
            z16=self._to_host(z_sym.to(torch.int16)),
            rows=self._to_host(rows),
            fits=self._to_host(torch.stack([fit8, fit16])),
            y32=y_sym, z32=z_sym, event=self._event(), hw=hw,
            n=y_sym.shape[0],
        )

    def _finish_encode(self, w: _EncodeWork) -> List[bytes]:
        """Host stage: wait for the device chain, range-code, pack blobs."""
        with self.timer.stage("enc/fetch"):
            if w.event is not None:
                w.event.synchronize()
            fit8, fit16 = (bool(v) for v in w.fits.cpu().numpy())
            if not fit16:
                y_sym = w.y32.cpu().numpy()
                z_sym = w.z32.cpu().numpy()
            else:
                y_sym = (w.y8 if fit8 else w.y32).cpu().numpy().astype(np.int32)
                z_sym = w.z16.cpu().numpy().astype(np.int32)
            rows = w.rows.cpu().numpy()
        n = w.n
        zshape = z_sym.shape[1:3]
        with self.timer.stage("enc/code_z"):
            z_strings = self.side_em.compress_symbols(z_sym)
        with self.timer.stage("enc/code_y"):
            y_strings = self.em.compress_symbols(
                y_sym.reshape(n, -1), rows.reshape(n, -1)
            )
        with self.timer.stage("enc/pack"):
            return self._pack(y_strings, z_strings, w.hw, zshape)

    def _pack(self, y_streams, z_strings, hw, zshape, K=None) -> List[bytes]:
        """One blob an image: 4 fields, plus ``[K]`` for a rANS y stream."""
        blobs = []
        for y, z in zip(y_streams, z_strings):
            fields = [y, z, np.array(hw, np.int32), np.array(zshape, np.int32)]
            if K is not None:
                fields.append(np.array([K], np.int32))
            packed = PackedTensors()
            packed.model = self.cfg.model_name
            packed.pack(fields)
            blobs.append(packed.string)
        return blobs

    # -- decode pipeline stages ----------------------------------------------

    def _dispatch_decode(self, blobs: List[bytes]) -> _DecodeWork:
        """Parse blobs, host-decode z, enqueue z_hat -> sigma -> rows and
        the copy of the rows to the host."""
        with self.timer.stage("dec/parse"):
            y_strings, z_strings, xshape, zshape = parse_host_blobs(blobs)
        with self.timer.stage("dec/code_z"):
            z_hat = self.side_em.decompress(
                z_strings, tuple(int(v) for v in zshape)
            )
        with self.timer.stage("dec/dispatch"):
            rows = self._rows(self._to_device(z_hat))
            work = _DecodeWork(
                rows=self._to_host(rows), event=self._event(),
                y_strings=y_strings, shape=tuple(rows.shape), xshape=xshape,
            )
        return work

    def _finish_decode(self, w: _DecodeWork) -> np.ndarray:
        """Host stage: wait for the rows, range-decode y, synthesize, fetch
        the reconstruction."""
        with self.timer.stage("dec/fetch_rows"):
            if w.event is not None:
                w.event.synchronize()
            rows = w.rows.cpu().numpy()
        n = len(w.y_strings)
        with self.timer.stage("dec/code_y"):
            values = self.em.decode_symbols(w.y_strings, rows.reshape(n, -1))
        with self.timer.stage("dec/synth"):
            y_hat = self._to_device(slim_int(values.reshape(w.shape)))
            x_hat = self._to_host(self._synthesize(y_hat))
            event = self._event()
        with self.timer.stage("dec/fetch_image"):
            if event is not None:
                event.synchronize()
            x_hat = x_hat.numpy()
        return x_hat[:, : int(w.xshape[0]), : int(w.xshape[1]), :]

    # -- device-coded path (rANS on the card; codec/rans.py) -----------------
    #
    # y is entropy-coded on the card by K3 and decoded by K2, so only the
    # compressed words cross to the host (and at decode the symbols never
    # do). z stays host-coded: it is tiny, and the decoder needs it on the
    # host first anyway. The symbols and rows come from the same _front and
    # _rows as the host path, so the two coders agree on every value; only
    # the bitstream differs (see codec/rans_ref.py).

    def _dispatch_encode_rans(self, images: np.ndarray) -> _RansEncodeWork:
        x, hw = pad_to_multiple_np(np.asarray(images, np.uint8),
                                   self.cfg.downscale)
        with self.timer.stage("enc/dispatch"):
            y_sym, z_sym, z_hat = self._front(self._to_device(x))
            rows = self._rows(z_hat)
            n = x.shape[0]
            enc, _dec, K, _cap = rans_for(self, y_sym[0].numel())
            stream, lengths, overflow = enc(y_sym.reshape(n, -1),
                                            rows.reshape(n, -1))
            work = _RansEncodeWork(
                stream=stream, lengths=self._to_host(lengths),
                overflow=self._to_host(overflow),
                z16=self._to_host(z_sym.to(torch.int16)),
                fit16=self._to_host(torch.all(torch.abs(z_sym) <= 32767)),
                y32=y_sym, z32=z_sym, rows=rows, event=self._event(), hw=hw,
                K=K,
            )
        return work

    def _finish_encode_rans(self, w: _RansEncodeWork) -> List[bytes]:
        with self.timer.stage("enc/fetch"):
            if w.event is not None:
                w.event.synchronize()
            lengths = w.lengths.cpu().numpy()
            overflow = w.overflow.cpu().numpy()
            z_sym = (w.z16 if bool(w.fit16) else w.z32).cpu().numpy().astype(np.int32)
        if overflow.any():
            # Pathological symbol statistics (e.g. an untrained model
            # escaping everywhere at extreme magnitudes) overflow the
            # stream's capacity: code this batch with the host coder, from
            # the same device symbols and rows.
            return self._finish_encode(
                self._host_coder_work(w.y32, w.z32, w.rows, w.hw))
        zshape = z_sym.shape[1:3]
        with self.timer.stage("enc/code_z"):
            z_strings = self.side_em.compress_symbols(z_sym)
        with self.timer.stage("enc/fetch_stream"):
            streams = fetch_streams(w.stream, lengths)
        with self.timer.stage("enc/pack"):
            return self._pack(streams, z_strings, w.hw, zshape, w.K)

    def _dispatch_decode_rans(self, blobs: List[bytes]) -> _RansDecodeWork:
        with self.timer.stage("dec/parse"):
            y_words, z_strings, xshape, zshape, K = parse_device_blobs(blobs)
        with self.timer.stage("dec/code_z"):
            z_hat = self.side_em.decompress(
                z_strings, tuple(int(v) for v in zshape)
            )
        with self.timer.stage("dec/dispatch"):
            rows = self._rows(self._to_device(z_hat))
            n = len(blobs)
            _enc, dec, _K, _cap = rans_for(self, rows[0].numel(), K)
            values, ok = dec(self._to_device(pad_words(y_words)),
                             rows.reshape(n, -1))
            image = self._synthesize(values.reshape(rows.shape))
            work = _RansDecodeWork(image=self._to_host(image),
                                   ok=self._to_host(ok), event=self._event(),
                                   xshape=xshape)
        return work

    def _finish_decode_rans(self, w: _RansDecodeWork) -> np.ndarray:
        with self.timer.stage("dec/fetch_image"):
            if w.event is not None:
                w.event.synchronize()
            image, ok = w.image.numpy(), w.ok.cpu().numpy()
        if not ok.all():
            raise ValueError("corrupt device-coded bitstream (rANS state)")
        return image[:, : int(w.xshape[0]), : int(w.xshape[1]), :]

    def _dispatch_decode_any(self, blobs: List[bytes]):
        if is_device_coded(blobs[0]):
            return self._dispatch_decode_rans(blobs)
        return self._dispatch_decode(blobs)

    def _finish_decode_any(self, w) -> np.ndarray:
        if isinstance(w, _RansDecodeWork):
            return self._finish_decode_rans(w)
        return self._finish_decode(w)

    # -- streaming paths (double-buffered device/host overlap) ---------------

    def _enc_stages(self, coder: str):
        if coder == "device":
            return self._dispatch_encode_rans, self._finish_encode_rans
        if coder != "host":
            raise ValueError(f"unknown coder {coder!r} (host|device)")
        return self._dispatch_encode, self._finish_encode

    def compress_iter(self, batches, depth: int = 2, coder: str = "host"):
        """Pipelined encode over an iterable of uint8 (N, H, W, 3) stacks;
        yields a list of .tfci blobs per batch, in order. ``coder="device"``
        rANS-codes y on the card."""
        dispatch, finish = self._enc_stages(coder)
        yield from Pipeline(dispatch, finish, depth, self.stream).run(batches)

    def decompress_iter(self, blob_batches, depth: int = 2):
        """Pipelined decode over an iterable of blob lists (each decoded as
        one batch, its coder detected from the blobs); yields uint8
        (N, H, W, 3) stacks."""
        yield from Pipeline(self._dispatch_decode_any, self._finish_decode_any,
                            depth, self.stream).run(blob_batches)

    # -- one-shot wrappers ---------------------------------------------------

    def compress(self, image: np.ndarray, coder: str = "host") -> bytes:
        return self.compress_batch(np.asarray(image, np.uint8)[None], coder)[0]

    def compress_batch(self, images: np.ndarray, coder: str = "host") -> list:
        """Compresses a uint8 (N, H, W, 3) stack; one .tfci blob each, from
        the host range coder (``"host"``) or the card's rANS (``"device"``)."""
        dispatch, finish = self._enc_stages(coder)
        with self._on_device():
            return finish(dispatch(images))

    def decompress_batch(self, blobs: list) -> np.ndarray:
        """Decompresses same-size .tfci blobs as one batch (either coder's
        format, detected from the blobs)."""
        with self._on_device():
            return self._finish_decode_any(self._dispatch_decode_any(blobs))

    def decompress(self, data: bytes) -> np.ndarray:
        return self.decompress_batch([data])[0]
