"""The reference's readers of the two file formats it meets: a ``.tfci``
blob (tensorflow_compression's PackedTensors: a ``tf.train.Example`` whose
feature ``"MD"`` is the model name and feature ``str(i)`` the i-th tensor,
bytes for strings and packed int64 for integers) and a flax msgpack
checkpoint (maps, arrays, and flax's ndarray extension ``(shape, dtype,
bytes)``)."""

from __future__ import annotations

import struct

import numpy as np


# -- .tfci blobs ---------------------------------------------------------------


def _varint(data, pos):
    value, shift = 0, 0
    while True:
        b = data[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, pos
        shift += 7


def _fields(data):
    pos = 0
    while pos < len(data):
        key, pos = _varint(data, pos)
        tag, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(data, pos)
        elif wire == 2:
            n, pos = _varint(data, pos)
            value, pos = data[pos : pos + n], pos + n
        elif wire == 5:
            value, pos = data[pos : pos + 4], pos + 4
        elif wire == 1:
            value, pos = data[pos : pos + 8], pos + 8
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield tag, wire, value


def _feature(payload):
    for tag, _wire, inner in _fields(payload):
        if tag == 1:  # bytes_list
            return [v for t, _w, v in _fields(inner) if t == 1]
        if tag == 3:  # int64_list, packed
            out = []
            for t, w, v in _fields(inner):
                if t == 1 and w == 2:
                    pos = 0
                    while pos < len(v):
                        x, pos = _varint(v, pos)
                        out.append(x - (1 << 64) if x >= 1 << 63 else x)
                elif t == 1 and w == 0:
                    out.append(v - (1 << 64) if v >= 1 << 63 else v)
            return np.asarray(out, np.int64)
        if tag == 2:  # float_list, packed
            return np.concatenate([np.frombuffer(v, "<f4") for t, _w, v in _fields(inner)
                                   if t == 1])
    return []


def read_blob(blob: bytes):
    """(model name, [tensor 0, tensor 1, ...]); a string tensor is its
    bytes, an integer one an int64 array."""
    features = {}
    for tag, _w, feats in _fields(bytes(blob)):
        if tag != 1:
            continue
        for t, _w2, entry in _fields(feats):
            if t != 1:
                continue
            key = value = None
            for t3, _w3, v in _fields(entry):
                if t3 == 1:
                    key = bytes(v).decode()
                elif t3 == 2:
                    value = _feature(v)
            features[key] = value
    model = bytes(features.pop("MD")[0]).decode()
    tensors = [features[str(i)] for i in range(len(features))]
    return model, [bytes(t[0]) if isinstance(t, list) else t for t in tensors]


def blob_fields(blob: bytes, streams: int):
    """A codec blob of ``streams`` y streams: ``(y streams, z string,
    zshape, K)``, K the rANS lanes where the blob holds ``streams + 4``
    fields (the device coder's) and None otherwise."""
    fields = read_blob(blob)[1]
    K = int(fields[streams + 3][0]) if len(fields) == streams + 4 else None
    return fields[:streams], fields[streams], fields[streams + 2], K


# -- flax msgpack checkpoints ---------------------------------------------------

_EXT_NDARRAY, _EXT_SCALAR = 1, 3


class _Msgpack:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n):
        out = self.data[self.pos : self.pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return out

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def ext(self, code, size):
        payload = bytes(self.take(size))
        if code not in (_EXT_NDARRAY, _EXT_SCALAR):
            raise ValueError(f"unsupported msgpack extension {code}")
        shape, dtype, buf = _Msgpack(payload).read()
        arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(tuple(shape))
        return arr.copy() if code == _EXT_NDARRAY else arr[()]

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return {self.read(): self.read() for _ in range(b & 0x0F)}
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return bytes(self.take(b & 0x1F)).decode()
        if b in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[b]
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])))
        if b in (0xC7, 0xC8, 0xC9):
            size = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(self.unpack(">b"), size)
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])
        if 0xD4 <= b <= 0xD8:
            code = self.unpack(">b")
            return self.ext(code, 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return bytes(self.take(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b]))).decode()
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            n = self.unpack(">H" if b == 0xDE else ">I")
            return {self.read(): self.read() for _ in range(n)}
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def read_checkpoint(path) -> dict:
    """A flax checkpoint's parameters as a flat ``{"a/b/leaf": array}``
    dict (the ``params`` wrappers and the step dropped; a DeepFactorized
    prior's ``deep_factorized`` level folded away)."""
    with open(path, "rb") as f:
        tree = _Msgpack(f.read()).read()
    while isinstance(tree, dict) and "params" in tree:
        tree = tree["params"]
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, prefix if k == "deep_factorized" else f"{prefix}/{k}" if prefix else k)
        else:
            flat[prefix] = np.asarray(node)
    walk(tree, "")
    return flat
