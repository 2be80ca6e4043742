"""Builds the port's CUDA sources (``csrc/*.cu``) into shared libraries.

Each source is compiled on its own with nvcc for ``sm_90a`` into
``csrc/build/`` (listed in .gitignore), as a shared library with a plain C
interface that the kernel's wrapper loads with ctypes. The library's name
embeds a hash of the source and the target flags, so an edited source is
rebuilt and a built one is reused. ``build_logs[source]`` keeps ptxas's
register/shared-memory/spill report of the last compile in this process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Callable, Dict

__all__ = ["ARCH", "CSRC", "build", "build_logs", "load"]

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

build_logs: Dict[str, str] = {}
_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build(source: str) -> pathlib.Path:
    """Compiles ``csrc/<source>`` (if not built yet) and returns the
    library path. Safe to call from several threads at once for different
    sources: each writes a temporary file and renames it into place."""
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes() + ARCH.encode()).hexdigest()
    out_dir = CSRC / "build"
    out_dir.mkdir(exist_ok=True)
    so_path = out_dir / f"libtpc_{src.stem}_{digest[:16]}.so"
    if not so_path.exists():
        tmp = so_path.with_suffix(".so.tmp%d.%d" % (os.getpid(), threading.get_ident()))
        cmd = [
            _nvcc(), ARCH, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            str(src), "-o", str(tmp),
        ]
        res = subprocess.run(cmd, capture_output=True, text=True)
        build_logs[source] = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{build_logs[source]}")
        os.replace(tmp, so_path)
    return so_path


def load(source: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """Builds and loads ``csrc/<source>`` once per process; ``declare`` sets
    the C functions' ``argtypes``/``restype``."""
    lib = _libs.get(source)
    if lib is not None:
        return lib
    with _lock:
        if source not in _libs:
            lib = ctypes.CDLL(str(build(source)))
            declare(lib)
            _libs[source] = lib
    return _libs[source]
