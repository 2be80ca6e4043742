"""The reference's model of a configuration, found by its ``family``: the
file ``reference/families/<family>.py`` holds the family's four transforms
on a flat parameter dict (see :mod:`benchmark.reference.layers`),
channels-last, and, where the family has them, its training loss
(``rd_loss``), the shapes of weights drawn from the seed
(``weight_shapes``) and the layers that the roofline counts (``layers``).
A configuration adds its family by adding that file.
"""

from __future__ import annotations

import importlib
import pathlib

FAMILIES = pathlib.Path(__file__).resolve().parent / "families"


def family(cfg: dict):
    """The module of ``cfg``'s family; raises for a family with no file."""
    name = cfg["family"]
    if not (FAMILIES / f"{name}.py").is_file():
        raise ValueError(f"no reference for the family {name!r} "
                         f"(benchmark/reference/families/{name}.py)")
    return importlib.import_module(f"benchmark.reference.families.{name}")


class Transforms:
    """The four transforms of a configuration, each ``(p, x) -> ...``;
    ``hyper_synthesis`` gives ``(mu or None, sigma)``."""

    def __init__(self, cfg: dict):
        fam, widths = family(cfg), cfg["widths"]
        self.analysis = lambda p, x: fam.analysis(p, x, widths)
        self.synthesis = lambda p, y: fam.synthesis(p, y, widths)
        self.hyper_analysis = lambda p, y: fam.hyper_analysis(p, y, widths)
        self.hyper_synthesis = lambda p, z: fam.hyper_synthesis(p, z, widths)
