"""A configuration's weights, as the benchmark hands them to both sides: a
flat ``{"layer/path/leaf": tensor}`` dict in the flax layout (kernels
``(kh, kw, cin, cout)``) on the device.

* ``"origin": "checkpoint"``: read from the file named by ``path`` (a flax
  msgpack file in the repository) with the reference's own reader.
* ``"origin": "seed"``: drawn on the device from ``--seed`` in a few large
  calls, at the shapes the family's reference file lists
  (``weight_shapes``). Every kernel N(0, 1/fan_in) (fan_in = kh * kw * cin), biases and
  ChannelNorm's offsets 0, ChannelNorm's scales 1; GDN at
  tensorflow_compression's initial values (beta 1, gamma 0.1 I, stored as
  the square roots of the values plus the pedestal, as a checkpoint
  stores them); the factorized prior at tensorflow_compression's initial
  values (matrices ``log(expm1(1 / scale / d_out))`` with ``scale =
  10^(1/4)``, factors 0) with its biases drawn U(-1/2, 1/2).

:func:`to_tree` nests the dict the way a flax checkpoint does, so the
program loads it through its own checkpoint converter.
"""

from __future__ import annotations

import math
import pathlib
from typing import Dict, Tuple

import torch

from benchmark.reference.entropy import PRIOR_FILTERS
from benchmark.reference.formats import read_checkpoint
from benchmark.reference.layers import _PEDESTAL
from benchmark.reference.models import family

ROOT = pathlib.Path(__file__).resolve().parent.parent

def _is_gdn(name: str) -> bool:
    """Whether a leaf is a GDN's or an inverse GDN's (``.../gdn0/beta``,
    ``.../igdn2/gamma``)."""
    layer = name.split("/")[-2]
    return layer.rstrip("0123456789") in ("gdn", "igdn")


def draw(shapes: Dict[str, Tuple[int, ...]], seed: int, device) -> Dict[str, torch.Tensor]:
    g = torch.Generator(device).manual_seed(int(seed))
    kernels = {k: s for k, s in shapes.items() if k.endswith("/kernel")}
    sizes = [math.prod(s) for s in kernels.values()]
    normal = torch.randn(sum(sizes), generator=g, device=device)
    out, at = {}, 0
    for (name, shape), size in zip(kernels.items(), sizes):
        fan_in = math.prod(shape[:-1])
        out[name] = normal[at : at + size].view(shape) * (1.0 / math.sqrt(fan_in))
        at += size
    prior_biases = {k: s for k, s in shapes.items() if "/biases/" in k}
    uniform = torch.rand(sum(math.prod(s) for s in prior_biases.values()),
                         generator=g, device=device) - 0.5
    at = 0
    for name, shape in prior_biases.items():
        out[name] = uniform[at : at + math.prod(shape)].view(shape)
        at += math.prod(shape)
    scale = 10.0 ** (1.0 / (len(PRIOR_FILTERS) + 1))
    for name, shape in shapes.items():
        if name in out:
            continue
        if _is_gdn(name):
            value = (torch.eye(shape[0], device=device) * 0.1 if name.endswith("/gamma")
                     else torch.ones(shape, device=device))
            out[name] = torch.sqrt(value + _PEDESTAL)
            continue
        if "/matrices/" in name:
            value = math.log(math.expm1(1.0 / scale / shape[1]))
        elif name.endswith("/gamma"):
            value = 1.0
        else:  # biases, ChannelNorm's beta, the prior's factors
            value = 0.0
        out[name] = torch.full(shape, value, device=device)
    return out


def load(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    spec = cfg["weights"]
    if spec["origin"] == "checkpoint":
        flat = read_checkpoint(ROOT / spec["path"])
        return {k: torch.as_tensor(v, dtype=torch.float32).to(device) for k, v in flat.items()}
    if spec["origin"] == "seed":
        fam = family(cfg)
        if not hasattr(fam, "weight_shapes"):
            raise ValueError(f"the family {cfg['family']!r} lists no weight shapes to draw")
        return draw(fam.weight_shapes(cfg["widths"]), seed, device)
    raise ValueError(f"unknown weights origin {spec['origin']!r}")


def to_tree(flat: Dict[str, torch.Tensor]) -> dict:
    """The flat dict nested as a flax checkpoint nests it (host NumPy), the
    factorized prior's fields under ``deep_factorized``."""
    tree: dict = {}
    for name, value in flat.items():
        parts = name.split("/")
        if parts[0] == "hyperprior":
            parts = parts[:1] + ["deep_factorized"] + parts[1:]
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value.detach().cpu().numpy()
    return tree
