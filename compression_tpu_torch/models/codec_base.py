"""What the codecs share: the device, its stream and the stage timer, the
pinned copies between host and card, and, for the two-stream hyperprior
codecs (bmshj2018, mbt2018), the batch API and the host coder's stages.

* :class:`DeviceCodec`: a model on a device (``"cuda"`` unless the caller
  asks for ``"cpu"``; strict float32 on the card), a CUDA stream of its
  own, non-blocking copies through pinned memory, events, ``.tfci`` blobs
  and the synthesis to uint8. bls2017's one-image codec is one.
* :class:`HyperpriorCodec`: z coded with the factorized hyperprior on the
  host, y with the scale-indexed tables by either coder (around a predicted
  mean where the family has one), as one stream an image or, in ms2020, one
  a channel slice (``_streams``); ``compress_batch``
  / ``decompress_batch``, the pipelined ``compress_iter`` /
  ``decompress_iter``, and both coders' stages (the device coder's from
  :mod:`compression_tpu_torch.models.device_coding`). A family gives
  ``_front`` (uint8 images on the device -> y, z symbols, z_hat) and
  ``_mu_rows`` (z_hat -> the location, or None, and the CDF rows: the one
  function encode and decode both call).
"""

from __future__ import annotations

import contextlib
from typing import List

import numpy as np
import torch

from compression_tpu_torch.distributions.uniform_noise import NoisyNormal
from compression_tpu_torch.entropy_models import (
    ContinuousBatchedEntropyModel,
    LocationScaleIndexedEntropyModel,
)
from compression_tpu_torch.models import device_coding
from compression_tpu_torch.models.codec_cache import tables_via_disk
from compression_tpu_torch.models.device_coding import is_device_coded, parse_host_blobs
from compression_tpu_torch.parallel.pipeline import Pipeline, Work, stream_context
from compression_tpu_torch.util import PackedTensors
from compression_tpu_torch.util.device import resolve_device, strict_fp32
from compression_tpu_torch.util.image import to_uint8
from compression_tpu_torch.util.numeric import slim_int
from compression_tpu_torch.util.profiling import StageTimer

__all__ = ["DeviceCodec", "HyperpriorCodec"]


class DeviceCodec:
    """A model on ``device`` (moved there, in eval mode) with its own CUDA
    stream and a :class:`~compression_tpu_torch.util.profiling.StageTimer`.
    On CUDA it pins float32 math (no TF32) and deterministic cuDNN
    (:func:`~compression_tpu_torch.util.device.strict_fp32`)."""

    def __init__(self, model: torch.nn.Module, device="cuda"):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            strict_fp32()
            self.stream = torch.cuda.Stream(self.device)
        else:
            self.stream = None
        self.cfg = model.config
        self.model = model.to(self.device).eval()
        self.timer = StageTimer(self.device)

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

    def _blob(self, fields) -> bytes:
        """One ``.tfci`` blob: ``fields`` packed under the model's name."""
        packed = PackedTensors()
        packed.model = self.cfg.model_name
        packed.pack(fields)
        return packed.string

    def _synthesize(self, y_hat: torch.Tensor, *args) -> torch.Tensor:
        """y_hat (and what else the model's ``synthesize`` takes) -> uint8."""
        return to_uint8(self.model.synthesize(y_hat.to(torch.float32), *args))


class HyperpriorCodec(DeviceCodec):
    """The batch API and both coders' stages of the two-stream codecs.

    Encode is one asynchronous device chain on the codec's stream, ending in
    non-blocking copies to pinned host memory; then the host range-codes
    (``coder="host"``, 4-field blobs ``[y_string, z_string, xshape,
    zshape]``), or y is rANS-coded on the card and only its words come back
    (``coder="device"``, 5-field blobs with ``[K]`` last). The decoder
    detects the format per batch. z_hat is ``int symbols + f32 offset`` on
    both sides.

    Args:
      model: the family's model (moved to ``device``); it has
        ``hyperprior`` and ``synthesize``.
      device: ``"cuda"`` (default; raises if absent) or ``"cpu"``.
      tables: optional ``{"side": CdfTables, "main": CdfTables}`` to use
        instead of the ones from the table file registered for the model
        (:func:`~compression_tpu_torch.models.codec_cache.tables_via_disk`),
        or built from it.
    """

    def __init__(self, model: torch.nn.Module, device="cuda", tables=None):
        super().__init__(model, device)
        hyperprior = model.hyperprior(device="cpu")
        if tables is None:
            tables = tables_via_disk(lambda: {
                "side": ContinuousBatchedEntropyModel(
                    hyperprior, coding_rank=3).build_tables(),
                "main": LocationScaleIndexedEntropyModel(
                    NoisyNormal, coding_rank=3, compression=True).tables,
            }, model)
        self.side_em = ContinuousBatchedEntropyModel(
            hyperprior, coding_rank=3, compression=True, tables=tables["side"],
        )
        self.em = LocationScaleIndexedEntropyModel(
            NoisyNormal, coding_rank=3, compression=True, tables=tables["main"],
        )
        self._z_off = self.side_em.symbol_offset(self.device)

    # -- shared device functions ---------------------------------------------

    def _z_symbols(self, z: torch.Tensor):
        """z -> (int32 symbols, z_hat exactly as the decoder forms it)."""
        z_sym = torch.round(z - self._z_off).to(torch.int32)
        return z_sym, z_sym.to(torch.float32) + self._z_off

    def _mu_rows(self, z_hat: torch.Tensor):
        """z_hat -> (location or None, uint8 CDF rows): the one function the
        encoder and the decoder both call. A family defines it."""
        raise NotImplementedError

    @staticmethod
    def _center_round(y: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
        """y -> int32 symbols around the location: ``round(y - mu)``."""
        return torch.round(y - mu).to(torch.int32)

    @staticmethod
    def _apply_loc(values: torch.Tensor, mu) -> torch.Tensor:
        """Decoded integer values -> y_hat (``values + mu``, or the values
        where the family codes no location)."""
        values = values.to(torch.float32)
        return values if mu is None else values + mu

    def _streams(self, a):
        """The y streams of a blob, as parts of an (n, h, w, C) array of
        symbols or rows: one stream of all C channels here (ms2020 codes one
        a channel slice)."""
        return [a]

    def _pack(self, y_streams, z_strings, hw, zshape, K=None) -> List[bytes]:
        """One blob an image: its y streams (``y_streams[b]``, one bytes
        object for each), z, the shapes, and ``[K]`` for rANS y streams."""
        blobs = []
        for ys, z in zip(y_streams, z_strings):
            fields = [*ys, z, np.array(hw, np.int32), np.array(zshape, np.int32)]
            if K is not None:
                fields.append(np.array([K], np.int32))
            blobs.append(self._blob(fields))
        return blobs

    # -- host-coder stages ---------------------------------------------------

    def _dispatch_encode(self, images: np.ndarray) -> Work:
        """Device stage: pad, upload, enqueue the encode chain and the
        copies of its results to the host. Returns without waiting."""
        with self.timer.stage("enc/dispatch"):
            return self._host_coder_work(*device_coding.encode_symbols(self, images))

    def _host_coder_work(self, y_sym, z_sym, rows, hw) -> Work:
        """Enqueues the copies the host coder needs: symbols in the
        narrowest type that holds them, rows, and the range checks."""
        fit8 = torch.all(torch.abs(y_sym) <= 127)
        fit16 = torch.all(torch.abs(y_sym) <= 32767) & torch.all(
            torch.abs(z_sym) <= 32767)
        return Work(
            y8=self._to_host(y_sym.to(torch.int8)),
            z16=self._to_host(z_sym.to(torch.int16)),
            rows=self._to_host(rows),
            fits=self._to_host(torch.stack([fit8, fit16])),
            y32=y_sym, z32=z_sym, event=self._event(), hw=hw,
            n=y_sym.shape[0],
        )

    def _finish_encode(self, w: Work) -> List[bytes]:
        """Host stage: wait for the device chain, range-code, pack blobs."""
        y_sym, z_sym, rows = self._fetch_symbols(w)
        n = w.n
        zshape = z_sym.shape[1:3]
        with self.timer.stage("enc/code_z"):
            z_strings = self.side_em.compress_symbols(z_sym)
        with self.timer.stage("enc/code_y"):
            streams = [self.em.compress_symbols(s.reshape(n, -1), r.reshape(n, -1))
                       for s, r in zip(self._streams(y_sym), self._streams(rows))]
        with self.timer.stage("enc/pack"):
            return self._pack(list(zip(*streams)), z_strings, w.hw, zshape)

    def _fetch_symbols(self, w: Work):
        """Waits for the encode chain; the y and z symbols (int32) and the
        rows as NumPy arrays."""
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
        return y_sym, z_sym, rows

    def _dispatch_decode(self, blobs: List[bytes]) -> Work:
        """Parse blobs, host-decode z, enqueue z_hat -> (mu, rows) and the
        copy of the rows to the host."""
        with self.timer.stage("dec/parse"):
            y_strings, z_strings, xshape, zshape = parse_host_blobs(blobs)
        with self.timer.stage("dec/code_z"):
            z_hat = self.side_em.decompress(
                z_strings, tuple(int(v) for v in zshape)
            )
        with self.timer.stage("dec/dispatch"):
            mu, rows = self._mu_rows(self._to_device(z_hat))
            work = Work(
                coder="host", rows=self._to_host(rows), event=self._event(),
                y_strings=y_strings, shape=tuple(rows.shape), xshape=xshape,
                mu=mu,
            )
        return work

    def _finish_decode(self, w: Work) -> np.ndarray:
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
            values = self._to_device(slim_int(values.reshape(w.shape)))
            x_hat = self._to_host(self._synthesize(self._apply_loc(values, w.mu)))
            event = self._event()
        with self.timer.stage("dec/fetch_image"):
            if event is not None:
                event.synchronize()
            x_hat = x_hat.numpy()
        return x_hat[:, : int(w.xshape[0]), : int(w.xshape[1]), :]

    # -- device-coded stages (rANS on the card; models/device_coding.py) -----

    def _dispatch_encode_rans(self, images: np.ndarray) -> Work:
        """The device coder's device stage (ms2020 codes one stream a
        slice)."""
        return device_coding.dispatch_encode_rans(self, images)

    def _finish_encode_rans(self, w: Work) -> List[bytes]:
        """The device coder's host stage; a family may override it (bmshj2018
        codes an overflowed batch with the host coder)."""
        return device_coding.finish_encode_rans(self, w)

    def _dispatch_decode_any(self, blobs: List[bytes]) -> Work:
        if is_device_coded(blobs[0]):
            return device_coding.dispatch_decode_rans(self, blobs)
        return self._dispatch_decode(blobs)

    def _finish_decode_any(self, w: Work) -> np.ndarray:
        if w.coder == "device":
            return device_coding.finish_decode_rans(self, w)
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
