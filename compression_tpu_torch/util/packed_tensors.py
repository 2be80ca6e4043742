"""PackedTensors: the self-describing bitstream container (.tfci files).

The port's own copy of ``compression_tpu/util/packed_tensors.py`` (NumPy
only; importing the JAX package would load JAX), so blobs written by either
package are byte-identical and parse in the other.

Byte-compatible re-implementation of the reference container (reference:
tensorflow_compression/python/util/packed_tensors.py:1-110), which stores a
model identifier plus a list of tensors inside a `tf.train.Example`
protocol buffer. This framework has no TensorFlow dependency, so the
Example wire format is implemented directly (~100 lines of protobuf
varint/length-delimited framing below); `tests/test_packed_tensors.py`
cross-checks byte equality against `tf.train.Example` when TF is available.

Wire schema (proto3):

    Example        { Features features = 1; }
    Features       { map<string, Feature> feature = 1; }
    Feature        { oneof { BytesList bytes_list = 1;
                             FloatList float_list = 2;
                             Int64List int64_list = 3; } }
    BytesList      { repeated bytes value = 1; }
    FloatList      { repeated float value = 1 [packed]; }
    Int64List      { repeated int64 value = 1 [packed]; }

The model identifier lives under feature key ``"MD"`` (bytes); tensor i
lives under key ``str(i)`` — bytes for string tensors, packed int64 for
integer tensors, packed float for float tensors.
"""

from __future__ import annotations

import struct
from typing import List, Sequence

import numpy as np

__all__ = ["PackedTensors"]


# --- minimal protobuf wire helpers -----------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(data: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("corrupt varint")


def _field(tag: int, wire: int, payload: bytes) -> bytes:
    return _varint((tag << 3) | wire) + payload


def _len_delim(tag: int, payload: bytes) -> bytes:
    return _field(tag, 2, _varint(len(payload)) + payload)


def _zigzag_free_int64(v: int) -> int:
    # int64 values are two's-complement in protobuf varints (10 bytes when
    # negative).
    return v & 0xFFFFFFFFFFFFFFFF


def _iter_fields(data: bytes, start: int = 0, end: int | None = None):
    pos = start
    end = len(data) if end is None else end
    while pos < end:
        key, pos = _read_varint(data, pos)
        tag, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(data, pos)
            yield tag, wire, val
        elif wire == 2:
            n, pos = _read_varint(data, pos)
            yield tag, wire, data[pos : pos + n]
            pos += n
        elif wire == 5:
            yield tag, wire, data[pos : pos + 4]
            pos += 4
        elif wire == 1:
            yield tag, wire, data[pos : pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")


# --- Feature encode/decode --------------------------------------------------


def _encode_bytes_feature(values: Sequence[bytes]) -> bytes:
    inner = b"".join(_len_delim(1, v) for v in values)
    return _len_delim(1, inner)  # Feature.bytes_list = 1


def _encode_int64_feature(values: np.ndarray) -> bytes:
    packed = b"".join(_varint(_zigzag_free_int64(int(v))) for v in values)
    inner = _len_delim(1, packed)  # Int64List.value packed
    return _len_delim(3, inner)  # Feature.int64_list = 3


def _encode_float_feature(values: np.ndarray) -> bytes:
    packed = struct.pack(f"<{len(values)}f", *[float(v) for v in values])
    inner = _len_delim(1, packed)  # FloatList.value packed
    return _len_delim(2, inner)  # Feature.float_list = 2


def _decode_feature(feature: bytes):
    """Returns (kind, values) with kind in {'bytes', 'float', 'int64'}."""
    for tag, wire, payload in _iter_fields(feature):
        if tag == 1:  # bytes_list
            vals = [p for t, w, p in _iter_fields(payload) if t == 1]
            return "bytes", vals
        if tag == 2:  # float_list
            out: List[float] = []
            for t, w, p in _iter_fields(payload):
                if t == 1 and w == 2:
                    out.extend(struct.unpack(f"<{len(p)//4}f", p))
                elif t == 1 and w == 5:
                    out.append(struct.unpack("<f", p)[0])
            return "float", out
        if tag == 3:  # int64_list
            out = []
            for t, w, p in _iter_fields(payload):
                if t == 1 and w == 2:
                    pos = 0
                    while pos < len(p):
                        v, pos = _read_varint(p, pos)
                        if v >= 1 << 63:
                            v -= 1 << 64
                        out.append(v)
                elif t == 1 and w == 0:
                    v = p
                    if v >= 1 << 63:
                        v -= 1 << 64
                    out.append(v)
            return "int64", out
    return "bytes", []


class PackedTensors:
    """Packs/unpacks a model id + tensor list into Example bytes."""

    def __init__(self, string: bytes | None = None):
        self._features: dict[str, bytes] = {}
        if string:
            self.string = string

    # -- serialization --------------------------------------------------------

    @property
    def string(self) -> bytes:
        entries = []
        # Deterministic order: model id first, then numeric keys.
        for key in sorted(self._features, key=lambda k: (k != "MD", k)):
            kv = _len_delim(1, key.encode("utf-8")) + _len_delim(
                2, self._features[key]
            )
            entries.append(_len_delim(1, kv))  # Features.feature map entry
        features = b"".join(entries)
        return _len_delim(1, features)  # Example.features = 1

    @string.setter
    def string(self, value: bytes):
        self._features = {}
        for tag, _wire, payload in _iter_fields(value):
            if tag != 1:
                continue
            for t2, _w2, entry in _iter_fields(payload):
                if t2 != 1:
                    continue
                key, feat = None, b""
                for t3, _w3, p3 in _iter_fields(entry):
                    if t3 == 1:
                        key = p3.decode("utf-8")
                    elif t3 == 2:
                        feat = p3  # the Feature message bytes
                if key is not None:
                    self._features[key] = feat

    # -- model id -------------------------------------------------------------

    @property
    def model(self) -> str:
        feat = self._features.get("MD")
        if feat is None:
            raise KeyError("no model identifier packed")
        _kind, vals = _decode_feature(feat)
        return vals[0].decode("utf-8")

    @model.setter
    def model(self, name: str):
        self._features["MD"] = _encode_bytes_feature([name.encode("utf-8")])

    def __delattr__(self, name):
        if name == "model":
            self._features.pop("MD", None)
        else:
            super().__delattr__(name)

    # -- tensors --------------------------------------------------------------

    def pack(self, tensors: Sequence) -> None:
        """Packs arrays/bytes; dtype decides the encoding."""
        for key in [k for k in self._features if k != "MD"]:
            del self._features[key]
        for i, tensor in enumerate(tensors):
            key = str(i)
            if isinstance(tensor, (bytes, bytearray)):
                self._features[key] = _encode_bytes_feature([bytes(tensor)])
                continue
            arr = np.asarray(tensor)
            if arr.dtype.kind in "SO" or (
                arr.dtype.kind == "U"
            ):
                vals = [
                    v if isinstance(v, bytes) else str(v).encode("utf-8")
                    for v in arr.reshape(-1)
                ]
                self._features[key] = _encode_bytes_feature(vals)
            elif arr.dtype.kind in "iu":
                self._features[key] = _encode_int64_feature(arr.reshape(-1))
            elif arr.dtype.kind == "f":
                self._features[key] = _encode_float_feature(arr.reshape(-1))
            else:
                raise TypeError(f"cannot pack dtype {arr.dtype}")

    def describe(self) -> List[tuple]:
        """Introspection for the `dump` CLI verb: returns
        ``(key, kind, count, total_bytes)`` per packed feature."""
        out = []
        for key in sorted(
            self._features, key=lambda k: (k == "MD", k.zfill(8))
        ):
            kind, vals = _decode_feature(self._features[key])
            if kind == "bytes":
                size = sum(len(v) for v in vals)
            else:
                size = len(vals) * (8 if kind == "int64" else 4)
            out.append((key, kind, len(vals), size))
        return out

    def unpack_one(self, index: int, dtype) -> np.ndarray:
        """Unpacks a single tensor by position — decoding only that field
        (the batching front ends group blobs by their tiny shape fields;
        decoding every multi-megabyte slice string just to read two ints
        would double the parse work on the decode hot path)."""
        feat = self._features.get(str(index))
        if feat is None:
            raise KeyError(f"no tensor {index} packed")
        _kind, vals = _decode_feature(feat)
        dtype = np.dtype(dtype) if not isinstance(dtype, np.dtype) else dtype
        if dtype.kind == "S" or dtype == object:
            return np.array(vals, dtype=object)
        return np.array(vals, dtype=dtype)

    def unpack(self, dtypes: Sequence) -> List[np.ndarray]:
        """Unpacks tensors as 1-D arrays of the given NumPy dtypes."""
        out = []
        for i, dtype in enumerate(dtypes):
            feat = self._features.get(str(i))
            if feat is None:
                raise KeyError(f"no tensor {i} packed")
            _kind, vals = _decode_feature(feat)
            dtype = np.dtype(dtype) if not isinstance(dtype, np.dtype) else dtype
            if dtype.kind == "S" or dtype == object:
                out.append(np.array(vals, dtype=object))
            else:
                out.append(np.array(vals, dtype=dtype))
        return out


