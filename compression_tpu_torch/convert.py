"""Weight bridge between the JAX package's flax checkpoints and the port,
in both directions.

* :func:`load_flax_msgpack` reads a flax ``serialization.to_bytes``
  checkpoint (e.g. ``ckpt/bmshj2018.msgpack``) into nested dicts of NumPy
  arrays, with a small msgpack reader of its own (maps, arrays, strings,
  binaries, ints, floats, and flax's ext types 1 = ndarray ``(shape, dtype
  name, bytes)`` and 3 = NumPy scalar), so the port needs no ``msgpack``.
  :func:`pack_msgpack` is the matching writer: what it writes, flax's
  ``serialization.from_bytes`` reads.
* :func:`params_from_numpy` maps such a tree (``params/params/...`` or any
  suffix of it) onto a model's state dict. Each holder is recognised by its
  structure, not its name, at any depth: a dict with a ``deep_factorized``
  child is a prior (``prior``, ``hyperprior``); a dict of ``kernel`` /
  ``bias`` / ``beta`` / ``gamma`` leaves is a layer (``analysis.conv0``,
  HiFiC's ``generator.res0.norm0``, the discriminator's top-level
  ``conv0``, LPIPS's ``vgg.conv0_0``); any other dict holds further
  holders (``analysis``, ``generator``, ``generator.res0``); a bare array
  is a parameter of its own (b2018's ``gain``, LPIPS's ``lin0``). Conv
  kernels ``(kh, kw, cin, cout)``, of ``SignalConv2D`` and flax ``nn.Conv``
  alike, become OIHW ``(cout, cin, kh, kw)``; GDN ``beta``/``gamma`` stay
  raw (sqrt space, reparameterized at call time), as do ChannelNorm's
  vectors; the DeepFactorized ``matrices`` / ``biases`` / ``factors`` lists
  map as they are. :func:`params_to_numpy` is its inverse, the flax param
  tree of a state dict (also used for per-parameter optimizer moments), by
  the same rule on the state dict's keys.
* :func:`variables_from_numpy` / :func:`variables_to_numpy` add the
  ``batch_stats`` of flax's ``SpectralNorm`` (HiFiC's discriminator): the
  i-th spectral-normalized layer ``conv0`` keeps ``SpectralNorm_{i}/
  {"conv0/kernel/u", "conv0/kernel/sigma"}`` there, the port keeps the
  buffers ``conv0.u`` and ``conv0.sigma``.
"""

from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np
import torch

__all__ = ["load_flax_msgpack", "unpack_msgpack", "pack_msgpack",
           "params_from_numpy", "params_to_numpy", "variables_from_numpy",
           "variables_to_numpy", "kernel_to_torch", "flax_key_path"]

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
        if code == _EXT_NPSCALAR:  # a 0-d array's (shape, dtype, bytes)
            shape, dtype, buf = unpack_msgpack(payload)
            return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(tuple(shape))[()]
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


def _write(obj: Any, out: bytearray) -> None:
    """Appends the msgpack encoding of ``obj``: dicts (string keys), lists,
    strings, bytes, ints, and NumPy arrays as flax's ext type 1. Lengths
    always take their 32-bit forms and ints their 64-bit ones (valid
    msgpack that flax and :func:`unpack_msgpack` read; not the shortest)."""
    if isinstance(obj, dict):
        out += struct.pack(">BI", 0xDF, len(obj))
        for key, value in obj.items():
            _write(key, out)
            _write(value, out)
    elif isinstance(obj, list):
        out += struct.pack(">BI", 0xDD, len(obj))
        for item in obj:
            _write(item, out)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        out += struct.pack(">BI", 0xDB, len(data)) + data
    elif isinstance(obj, bytes):
        out += struct.pack(">BI", 0xC6, len(obj)) + obj
    elif isinstance(obj, int):
        out += struct.pack(">Bq", 0xD3, obj) if obj < 0 else struct.pack(">BQ", 0xCF, obj)
    elif isinstance(obj, np.ndarray):
        payload = _array_payload(obj)
        out += struct.pack(">BIb", 0xC9, len(payload), _EXT_NDARRAY) + payload
    else:
        raise TypeError(f"cannot msgpack {type(obj).__name__}")


def _array_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject:
        raise ValueError("object arrays cannot be serialized")
    return pack_msgpack([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def pack_msgpack(obj: Any) -> bytes:
    """Encodes one object for flax's ``msgpack_restore`` (NumPy arrays as
    its ext type 1)."""
    out = bytearray()
    _write(obj, out)
    return bytes(out)


def load_flax_msgpack(path) -> Dict[str, Any]:
    """Reads a flax msgpack checkpoint into nested dicts of NumPy arrays."""
    with open(path, "rb") as f:
        return unpack_msgpack(f.read())


def kernel_to_torch(kernel: np.ndarray) -> torch.Tensor:
    """``(kh, kw, cin, cout)`` -> OIHW ``(cout, cin, kh, kw)`` float32."""
    k = np.asarray(kernel, np.float32)
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


def kernel_from_torch(weight: torch.Tensor) -> np.ndarray:
    """OIHW ``(cout, cin, kh, kw)`` -> ``(kh, kw, cin, cout)`` float32."""
    w = weight.detach().to("cpu", torch.float32).numpy()
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))


def _as_list(value):
    """A flax tuple is a dict {"0": ..., "1": ...}; a list stays a list."""
    if isinstance(value, dict):
        return [value[str(i)] for i in range(len(value))]
    return list(value)


_PRIOR_FIELDS = ("matrices", "biases", "factors")  # DeepFactorized lists
_LAYER_LEAVES = ("kernel", "bias", "beta", "gamma")


def _is_prior_key(parts) -> bool:
    """A state-dict key of a DeepFactorized holder: ``<holder>.<field>.<i>``."""
    return len(parts) == 3 and parts[1] in _PRIOR_FIELDS


def _is_layer(node) -> bool:
    """A dict of a layer's leaves (kernel, bias, GDN's or ChannelNorm's
    beta and gamma), each an array."""
    return bool(node) and set(node) <= set(_LAYER_LEAVES) and not any(
        isinstance(v, dict) for v in node.values())


def _array(value) -> torch.Tensor:
    return torch.from_numpy(np.array(value, np.float32))


def _numpy(value: torch.Tensor) -> np.ndarray:
    return value.detach().to("cpu", torch.float32).numpy().copy()


def _holder_to_state(key: str, node, state: Dict[str, torch.Tensor]) -> None:
    if not isinstance(node, dict):  # a parameter array of its own
        state[key] = _array(node)
    elif "deep_factorized" in node:
        prior = node["deep_factorized"]
        for field in _PRIOR_FIELDS:
            for i, value in enumerate(_as_list(prior[field])):
                state[f"{key}.{field}.{i}"] = _array(value)
    elif _is_layer(node):
        for leaf, value in node.items():
            if leaf == "kernel":
                state[f"{key}.weight"] = kernel_to_torch(value)
            else:
                state[f"{key}.{leaf}"] = _array(value)
    elif node:
        for name, child in node.items():
            _holder_to_state(f"{key}.{name}", child, state)
    else:
        raise KeyError(f"unexpected parameter holder {key!r}")


def params_from_numpy(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Maps a JAX param tree onto the port's state dict (see the module
    docstring); raises on an empty holder."""
    while "params" in tree:  # {"params": {"params": {...}}, "step": ...}
        tree = tree["params"]
    state: Dict[str, torch.Tensor] = {}
    for name, holder in tree.items():
        _holder_to_state(name, holder, state)
    return state


def params_to_numpy(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`params_from_numpy`: the flax param tree
    (``{"analysis": {"conv0": {"kernel": HWIO, "bias": ...}, ...},
    "hyperprior": {"deep_factorized": {"matrices": {"0": ...}}}}``) of a
    state dict, or of any per-parameter dict with its keys."""
    tree: Dict[str, Any] = {}
    for key, value in state.items():
        parts = key.split(".")
        if len(parts) == 1:
            tree[key] = _numpy(value)
        elif _is_prior_key(parts):
            name, field, i = parts
            prior = tree.setdefault(name, {}).setdefault("deep_factorized", {})
            prior.setdefault(field, {})[i] = _numpy(value)
        elif parts[-1] in ("weight",) + _LAYER_LEAVES[1:]:
            node = tree
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            if parts[-1] == "weight":
                node["kernel"] = kernel_from_torch(value)
            else:
                node[parts[-1]] = _numpy(value)
        else:
            raise KeyError(f"unexpected parameter {key}")
    return tree


_SPECTRAL_STATE = ("u", "sigma")  # the buffers of a spectral-normalized layer


def variables_to_numpy(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """A state dict with spectral-norm buffers (``conv0.u``,
    ``conv0.sigma``) as flax variables ``{"params": ..., "batch_stats":
    {"SpectralNorm_0": {"conv0/kernel/u": ..., "conv0/kernel/sigma": ...},
    ...}}``, the layers numbered in the state dict's order (the order flax
    names the wrappers in)."""
    params, stats, layers = {}, {}, []
    for key, value in state.items():
        layer, _, leaf = key.rpartition(".")
        if leaf not in _SPECTRAL_STATE:
            params[key] = value
            continue
        if layer not in layers:
            layers.append(layer)
        name = f"SpectralNorm_{layers.index(layer)}"
        flax_layer = layer.replace(".", "/")
        stats.setdefault(name, {})[f"{flax_layer}/kernel/{leaf}"] = _numpy(value)
    out = {"params": params_to_numpy(params)}
    if stats:
        out["batch_stats"] = stats
    return out


def variables_from_numpy(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`variables_to_numpy`: flax variables (params
    and the spectral norms' ``batch_stats``) as one state dict."""
    state = params_from_numpy(tree["params"])
    for entries in tree.get("batch_stats", {}).values():
        for path, value in entries.items():
            *layer, kernel, leaf = path.split("/")
            if kernel != "kernel" or leaf not in _SPECTRAL_STATE:
                raise KeyError(f"unexpected batch_stats entry {path!r}")
            state[".".join(layer) + "." + leaf] = _array(value)
    return state


def flax_key_path(name: str) -> str:
    """The JAX package's key path of a parameter, as its optimizer renders
    it (``"params/analysis/conv0/kernel"``; a DeepFactorized field by its
    index: ``"params/hyperprior/deep_factorized/0/2"`` for matrices[2])."""
    parts = name.split(".")
    if _is_prior_key(parts):
        holder, field, i = parts
        return f"params/{holder}/deep_factorized/{_PRIOR_FIELDS.index(field)}/{i}"
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return "params/" + "/".join(parts)
