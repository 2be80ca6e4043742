"""The reference's model of a configuration, found by its ``family``: the
file ``reference/families/<family>.py`` holds the family's four transforms
on a flat parameter dict (see :mod:`benchmark.reference.layers`),
channels-last, and, where the family has them, its training loss
(``rd_loss``), the shapes of weights drawn from the seed
(``weight_shapes``), the layers that the roofline counts (``layers``) and
the transforms each phase runs (``PHASES``), and the widths the CPU tests
shrink it to (``small_widths``). A family whose y is coded otherwise than
as one stream around ``hyper_synthesis``'s (mu, sigma) gives ``y_model``
and ``y_streams``. A configuration adds its family by adding that file.
"""

from __future__ import annotations

import importlib
import pathlib

import torch

FAMILIES = pathlib.Path(__file__).resolve().parent / "families"


def family(cfg: dict):
    """The module of ``cfg``'s family; raises for a family with no file."""
    name = cfg["family"]
    if not (FAMILIES / f"{name}.py").is_file():
        raise ValueError(f"no reference for the family {name!r} "
                         f"(benchmark/reference/families/{name}.py)")
    return importlib.import_module(f"benchmark.reference.families.{name}")


def y_streams(cfg: dict) -> int:
    """How many y streams a blob of ``cfg`` holds: the family's
    ``y_streams(widths)``, else one."""
    fam = family(cfg)
    return fam.y_streams(cfg["widths"]) if hasattr(fam, "y_streams") else 1


def one_stream(fam, p, y, z_hat, widths):
    """The default y model of one image: (mu or None, sigma) from
    ``hyper_synthesis``, one stream of all of y's channels holding
    ``round(y - mu)`` (``round(y)`` where the family predicts no mean), and
    ``symbols + mu`` for the synthesis."""
    mu, sigma = fam.hyper_synthesis(p, z_hat, widths)
    y_sym = torch.round(y if mu is None else y - mu).to(torch.int32)
    y_hat = y_sym.to(torch.float32)
    if mu is not None:
        y_hat = y_hat + mu
    return [(y_sym, sigma)], y_hat


class Transforms:
    """The transforms of a configuration, each ``(p, x) -> ...``;
    ``hyper_synthesis`` gives ``(mu or None, sigma)``, and ``y_model(p, y,
    z_hat)`` of one image gives its y streams in blob order, each
    ``(int32 symbols, sigma)``, and the y_hat that the synthesis reads."""

    def __init__(self, cfg: dict):
        fam, widths = family(cfg), cfg["widths"]
        self.analysis = lambda p, x: fam.analysis(p, x, widths)
        self.synthesis = lambda p, y: fam.synthesis(p, y, widths)
        self.hyper_analysis = lambda p, y: fam.hyper_analysis(p, y, widths)
        self.hyper_synthesis = lambda p, z: fam.hyper_synthesis(p, z, widths)
        if hasattr(fam, "y_model"):
            self.y_model = lambda p, y, z_hat: fam.y_model(p, y, z_hat, widths)
        else:
            self.y_model = lambda p, y, z_hat: one_stream(fam, p, y, z_hat, widths)
