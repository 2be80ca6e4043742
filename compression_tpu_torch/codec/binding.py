"""ctypes binding for the native range coder (counterpart of
``compression_tpu/codec/binding.py``).

``cc/tpc_codec.cc`` and ``cc/range_coder.h`` are byte-identical copies of
the JAX package's sources, so both packages write the same bitstream. The
shared library is compiled with g++ at first use into ``cc/build/`` (listed
in .gitignore), under a name that embeds a hash of the sources. This is
host code: the range coder runs on the CPU in both packages.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

_CC_DIR = pathlib.Path(__file__).parent / "cc"
_SOURCES = ["tpc_codec.cc"]
_HEADERS = ["range_coder.h"]

_lock = threading.Lock()
_lib = None


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in _SOURCES + _HEADERS:
        h.update((_CC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def _build(out_path: pathlib.Path) -> None:
    cmd = [
        "g++", "-std=c++17", "-O3", "-fPIC", "-shared", "-pthread",
        "-Wall", "-Werror",
        str(_CC_DIR / "tpc_codec.cc"),
        "-o", str(out_path),
    ]
    subprocess.run(cmd, check=True, capture_output=True, text=True)


def get_lib() -> ctypes.CDLL:
    """Returns the loaded library, building it if necessary."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        build_dir = _CC_DIR / "build"
        build_dir.mkdir(exist_ok=True)
        so_path = build_dir / f"libtpc_codec_{_source_hash()}.so"
        if not so_path.exists():
            tmp = so_path.with_suffix(".so.tmp%d" % os.getpid())
            _build(tmp)
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(str(so_path))
        _declare(lib)
        _lib = lib
        return _lib


_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_f64p = ctypes.POINTER(ctypes.c_double)


def _declare(lib: ctypes.CDLL) -> None:
    lib.tpc_entropy_encode.restype = ctypes.c_int
    lib.tpc_entropy_encode.argtypes = [
        _i32p, _i32p, ctypes.c_int64, ctypes.c_int64,
        _i32p, _i32p, _i32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        _u8p, ctypes.c_int64, _i64p, ctypes.c_int32,
    ]
    lib.tpc_entropy_decode.restype = ctypes.c_int
    lib.tpc_entropy_decode.argtypes = [
        _u8p, _i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _i32p,
        _i32p, _i32p, _i32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        _i32p, ctypes.c_int32,
    ]
    lib.tpc_pmf_to_quantized_cdf.restype = ctypes.c_int
    lib.tpc_pmf_to_quantized_cdf.argtypes = [
        _f64p, ctypes.c_int64, ctypes.c_int64, _i32p, ctypes.c_int32, _i32p,
        ctypes.c_int32,
    ]
    lib.tpc_run_length_gamma_encode.restype = ctypes.c_int
    lib.tpc_run_length_gamma_encode.argtypes = [
        _i32p, ctypes.c_int64, _u8p, ctypes.c_int64, _i64p,
    ]
    lib.tpc_run_length_gamma_decode.restype = ctypes.c_int
    lib.tpc_run_length_gamma_decode.argtypes = [
        _u8p, ctypes.c_int64, ctypes.c_int64, _i32p,
    ]


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctype)


_ERRORS = {1: "output capacity exceeded", 2: "bad arguments", 3: "corrupt bitstream"}


def _check(rc: int):
    if rc != 0:
        raise ValueError(f"codec error: {_ERRORS.get(rc, rc)}")


def default_num_threads() -> int:
    return min(os.cpu_count() or 1, 32)
