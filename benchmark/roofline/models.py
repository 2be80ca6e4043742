"""The layers of each configuration's four transforms, from its widths and
the image size: what the per-layer metrics count. Each family's file
(``reference/families/<family>.py``) lists its layers with :class:`Stack`.

A layer is ``(kind, name, n, h, w, cin, cout, k, stride, up)`` at the
input's ``h x w``: kind ``conv`` (FLOPs and bytes from :mod:`conv`),
``gdn`` (rows of the input's grid; 2 C^2 + 3 C FLOPs a row, its products
and the norm's add, root and multiply), ``channelnorm`` (7 FLOPs an
element: the two means, the centring, the square, the scale by the root
and the affine pair) or ``add`` (the residual sum, 1 an element).
"""

from __future__ import annotations

from typing import List, NamedTuple

from benchmark.roofline import conv as conv_cost
from benchmark.roofline import k1


class Layer(NamedTuple):
    kind: str
    name: str
    n: int
    h: int
    w: int
    cin: int
    cout: int = 0
    k: int = 0
    stride: int = 1
    up: bool = False
    bias: bool = True

    def out_hw(self):
        if self.kind != "conv":
            return self.h, self.w
        return (conv_cost.out_size(self.h, self.stride, self.up),
                conv_cost.out_size(self.w, self.stride, self.up))

    def flops(self) -> float:
        if self.kind == "conv":
            return conv_cost.conv_flops(self.n, self.h, self.w, self.cin, self.cout,
                                        self.k, self.stride, self.up)
        elements = self.n * self.h * self.w * self.cin
        if self.kind == "gdn":
            return k1.gdn_flops(self.n * self.h * self.w, self.cin) + 3.0 * elements
        return {"channelnorm": 7.0, "add": 1.0}[self.kind] * elements

    def bytes(self) -> float:
        return conv_cost.conv_bytes(self.n, self.h, self.w, self.cin, self.cout, self.k,
                                    self.stride, self.up, self.bias)


class Stack:
    """Layers appended in order, each at the size the previous one left."""

    def __init__(self, n, h, w, c):
        self.n, self.h, self.w, self.c = n, h, w, c
        self.layers: List[Layer] = []

    def conv(self, name, cout, k, stride=1, up=False, bias=True):
        layer = Layer("conv", name, self.n, self.h, self.w, self.c, cout, k, stride, up, bias)
        self.layers.append(layer)
        self.h, self.w = layer.out_hw()
        self.c = cout

    def pointwise(self, kind, name):
        self.layers.append(Layer(kind, name, self.n, self.h, self.w, self.c))


# The transforms each phase runs: encoding ends in the hyper-synthesis (the
# CDF rows of y), decoding starts there. A family's file may give its own
# ``PHASES``, with parts of its own that its ``layers`` lists.
PHASES = {
    "compress": ("analysis", "hyper_analysis", "hyper_synthesis"),
    "decompress": ("hyper_synthesis", "synthesis"),
    "train": ("analysis", "hyper_analysis", "hyper_synthesis", "synthesis"),
}


def layers(cfg: dict, part: str, n: int, h: int, w: int) -> List[Layer]:
    """The layers of one transform of ``cfg`` for ``n`` images of h x w, as
    its family's file lists them."""
    from benchmark.reference.models import family

    return family(cfg).layers(cfg["widths"], part, n, h, w)


def phases(cfg: dict) -> dict:
    """The transforms each phase of ``cfg`` runs: its family's ``PHASES``,
    else :data:`PHASES`."""
    from benchmark.reference.models import family

    return getattr(family(cfg), "PHASES", PHASES)


def phase_layers(cfg: dict, phase: str, n: int, h: int, w: int) -> List[Layer]:
    return [layer for part in phases(cfg)[phase] for layer in layers(cfg, part, n, h, w)]


def model_flops(cfg: dict, phase: str, n: int, h: int, w: int) -> float:
    """The phase's model FLOPs; a training step counts its backward as
    twice its forward."""
    forward = sum(layer.flops() for layer in phase_layers(cfg, phase, n, h, w))
    return 3.0 * forward if phase == "train" else forward
