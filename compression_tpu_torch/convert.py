"""Weight bridge from the JAX package's flax checkpoints to the port.

* :func:`load_flax_msgpack` reads a flax ``serialization.to_bytes``
  checkpoint (e.g. ``ckpt/bmshj2018.msgpack``) into nested dicts of NumPy
  arrays, with a small msgpack reader of its own (maps, arrays, strings,
  binaries, ints, floats, and flax's ext types 1 = ndarray ``(shape, dtype
  name, bytes)`` and 3 = NumPy scalar), so the port needs no ``msgpack``.
* :func:`params_from_numpy` maps such a tree (``params/params/...`` or any
  suffix of it) onto :class:`~compression_tpu_torch.models.bmshj2018.
  BMSHJ2018Model`'s state dict: conv kernels ``(kh, kw, cin, cout)`` become
  OIHW ``(cout, cin, kh, kw)``; GDN ``beta``/``gamma`` stay raw (sqrt
  space, reparameterized at call time); the DeepFactorized ``matrices`` /
  ``biases`` / ``factors`` lists map as they are.
"""

from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np
import torch

__all__ = ["load_flax_msgpack", "unpack_msgpack", "params_from_numpy",
           "kernel_to_torch"]

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    """Decoder for the msgpack subset flax checkpoints use."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def _ext(self, code: int, size: int):
        payload = bytes(self._take(size))
        if code == _EXT_NDARRAY:
            shape, dtype, buf = unpack_msgpack(payload)
            arr = np.frombuffer(buf, dtype=np.dtype(dtype))
            return arr.reshape(tuple(shape)).copy()
        if code == _EXT_NPSCALAR:
            dtype, buf = unpack_msgpack(payload)
            return np.frombuffer(buf, dtype=np.dtype(dtype))[0]
        raise ValueError(f"unsupported msgpack ext type {code}")

    def read(self) -> Any:
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return bytes(self._take(b & 0x1F)).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in lengths:  # bin 8/16/32
            return bytes(self._take(self._unpack(lengths[b])))
        ext_lengths = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in ext_lengths:  # ext 8/16/32
            size = self._unpack(ext_lengths[b])
            return self._ext(self._unpack(">b"), size)
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self._unpack(scalars[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            code = self._unpack(">b")
            return self._ext(code, 1 << (b - 0xD4))
        str_lengths = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in str_lengths:
            return bytes(self._take(self._unpack(str_lengths[b]))).decode("utf-8")
        if b in (0xDC, 0xDD):
            return self._array(self._unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self._map(self._unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out


def unpack_msgpack(data: bytes) -> Any:
    """Decodes one msgpack object (flax's ext types become NumPy values)."""
    reader = _Reader(data)
    obj = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return obj


def load_flax_msgpack(path) -> Dict[str, Any]:
    """Reads a flax msgpack checkpoint into nested dicts of NumPy arrays."""
    with open(path, "rb") as f:
        return unpack_msgpack(f.read())


def kernel_to_torch(kernel: np.ndarray) -> torch.Tensor:
    """``(kh, kw, cin, cout)`` -> OIHW ``(cout, cin, kh, kw)`` float32."""
    k = np.asarray(kernel, np.float32)
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


def _as_list(value):
    """A flax tuple is a dict {"0": ..., "1": ...}; a list stays a list."""
    if isinstance(value, dict):
        return [value[str(i)] for i in range(len(value))]
    return list(value)


_TRANSFORMS = ("analysis", "synthesis", "hyper_analysis", "hyper_synthesis")


def params_from_numpy(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Maps a bmshj2018 JAX param tree onto the port's state dict."""
    while "params" in tree:  # {"params": {"params": {...}}, "step": ...}
        tree = tree["params"]
    state: Dict[str, torch.Tensor] = {}
    for name in _TRANSFORMS:
        for layer, leaves in tree[name].items():
            for leaf, value in leaves.items():
                key = f"{name}.{layer}"
                if leaf == "kernel":
                    state[f"{key}.weight"] = kernel_to_torch(value)
                elif leaf in ("bias", "beta", "gamma"):
                    state[f"{key}.{leaf}"] = torch.from_numpy(
                        np.array(value, np.float32)
                    )
                else:
                    raise KeyError(f"unexpected leaf {name}/{layer}/{leaf}")
    prior = tree["hyperprior"]["deep_factorized"]
    for field in ("matrices", "biases", "factors"):
        for i, value in enumerate(_as_list(prior[field])):
            state[f"hyperprior.{field}.{i}"] = torch.from_numpy(
                np.array(value, np.float32)
            )
    return state
