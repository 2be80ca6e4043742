"""Per-model codec cache and the table disk cache (counterpart of
``compression_tpu/models/codec_cache.py``).

The coding path needs two one-time artifacts per trained model: the codec
(the model on its device, its stream) and the integer CDF tables, seconds
of host math. Each family's module-level ``compress``/``decompress`` builds
a codec once per model and device through :func:`cached`, and each codec
reads its tables through :func:`tables_via_disk`, so every process after
the first loads them from the file registered for the model.

A ``torch.nn.Module`` keeps its identity while its weights change in place
(an optimizer step, ``load_state_dict``), where the JAX package gets a new
params pytree. So every entry here is keyed on the module and on the state
of its tensors, each one's storage address and ``_version`` counter: an
entry whose tensors have moved or changed is a miss.
"""

from __future__ import annotations

import itertools
import os
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from compression_tpu_torch.entropy_models.continuous_base import load_tables, save_tables

__all__ = ["cached", "invalidate", "register_table_cache", "tables_via_disk"]

# (id(module), device) -> (module, tensor state, codec). The module is held
# so that its id cannot be recycled while the entry lives.
_CACHE: Dict[Tuple[int, Optional[str]], Tuple[Any, tuple, Any]] = {}

# id(module) -> (module, tensor state, table file). Checkpoint loaders bind
# each model to ITS OWN table file: a process-global path would serve model
# A's tables to model B in a process that loads several checkpoints.
# $TPC_TABLE_CACHE_FILE remains as a single-model fallback for scripts.
_TABLE_PATHS: Dict[int, Tuple[Any, tuple, str]] = {}


def _state(module: torch.nn.Module) -> tuple:
    """Each tensor's storage address and version: both stay put until the
    weights are moved or changed in place."""
    return tuple((t.data_ptr(), t._version)
                 for t in itertools.chain(module.parameters(), module.buffers()))


def register_table_cache(module: torch.nn.Module, path: str) -> None:
    """Binds an on-disk CDF-table file to ``module`` in its current state."""
    if len(_TABLE_PATHS) > 16:
        _TABLE_PATHS.pop(next(iter(_TABLE_PATHS)))
    _TABLE_PATHS[id(module)] = (module, _state(module), path)


def tables_via_disk(build: Callable[[], Dict[str, Any]],
                    module: Optional[torch.nn.Module] = None) -> Dict[str, Any]:
    """Loads the named CDF tables from the file bound to ``module`` (see
    :func:`register_table_cache`; $TPC_TABLE_CACHE_FILE where none is, or
    where the module's weights changed since), or builds them with
    ``build()`` and saves them there.

    The tables are a pure function of the checkpoint, and the file holds
    them under the JAX package's names and keys, so either package reads
    what the other wrote.
    """
    path: Optional[str] = None
    if module is not None:
        entry = _TABLE_PATHS.get(id(module))
        if entry is not None and entry[0] is module and entry[1] == _state(module):
            path = entry[2]
    if path is None:
        path = os.environ.get("TPC_TABLE_CACHE_FILE")
    if path and os.path.exists(path):
        return load_tables(path)
    tables = build()
    if path:
        save_tables(path, tables)
    return tables


def invalidate(module: torch.nn.Module) -> None:
    """Drops the codecs and the table file bound to ``module``: the caches
    hold strong references, which pin the module's device memory until
    then (a server swapping checkpoints calls this)."""
    for key in [k for k in _CACHE if k[0] == id(module)]:
        del _CACHE[key]
    _TABLE_PATHS.pop(id(module), None)


def cached(module: torch.nn.Module, builder: Callable, device=None):
    """Returns ``builder()`` memoized on ``module``, its tensors' state
    and ``device``; bounded by FIFO eviction. The state is read after the
    build, which may move the module to ``device``."""
    key = (id(module), None if device is None else str(torch.device(device)))
    entry = _CACHE.get(key)
    if entry is not None and entry[0] is module and entry[1] == _state(module):
        return entry[2]
    value = builder()
    if len(_CACHE) > 8:
        _CACHE.pop(next(iter(_CACHE)))
    _CACHE[key] = (module, _state(module), value)
    return value
