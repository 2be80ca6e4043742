"""The port's counterpart of ``__graft_entry__.entry``: bmshj2018's loss step
at full width, with example arguments.

    fn, (model, x, generator) = entry()
    loss, metrics = fn(model, x, generator)
"""

from __future__ import annotations

import torch

from compression_tpu_torch.models import bmshj2018
from compression_tpu_torch.util.device import resolve_device, strict_fp32

__all__ = ["entry"]


def entry(device="cuda"):
    """Returns ``(fn, (model, x, generator))``: ``fn(model, batch,
    generator) -> (loss, metrics)`` is the training loss of bmshj2018 at
    192/192/128 filters, the model is seeded, ``x`` is one 256x256 zero
    image and ``generator`` the noise source, all on ``device`` (the card
    unless the caller asks for the CPU)."""
    device = resolve_device(device)
    if device.type == "cuda":
        strict_fp32()
    cfg = bmshj2018.Config(num_filters=192, num_latents=192, num_hyperlatents=128)
    model = bmshj2018.BMSHJ2018Model(cfg, seed=0).to(device)
    x = torch.zeros((1, 256, 256, 3), dtype=torch.float32, device=device)
    generator = torch.Generator(device).manual_seed(2)

    def fn(model, batch, generator):
        return bmshj2018.make_loss_fn(model)(batch, generator)

    return fn, (model, x, generator)
