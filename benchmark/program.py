"""The system under test: the PyTorch/CUDA port's models, codecs and
training step, built for a configuration through the port's own entry
points, and its spans and launch counters. This module and the family files it finds by name
(``families/<family>.py``: ``build_model``, ``build_codec`` and, for a
family that trains, ``make_loss_fn``) are the benchmark's only code that
imports the port. A configuration adds its family by adding that file."""

from __future__ import annotations

import pathlib

import torch

from benchmark import harness, weights

FAMILIES = pathlib.Path(__file__).resolve().parent / "families"


def family(cfg: dict):
    """The port's adapter of ``cfg``'s family; raises for a family with no
    file."""
    path = FAMILIES / f"{cfg['family']}.py"
    if not path.is_file():
        raise ValueError(f"no program adapter for the family {cfg['family']!r} "
                         f"(benchmark/families/{cfg['family']}.py)")
    return harness.load_module(path)


def _load_tree(model, flat: dict):
    from compression_tpu_torch.convert import params_from_numpy

    model.load_state_dict(params_from_numpy(weights.to_tree(flat)))


def build_model(cfg: dict, flat: dict):
    """The port's model of ``cfg`` holding the weights ``flat`` (the
    benchmark's flat dict; a checkpoint is loaded from its file by the
    port's own reader)."""
    spec = dict(cfg["weights"])
    if spec["origin"] == "checkpoint":
        spec["file"] = weights.ROOT / spec["path"]
    return family(cfg).build_model({**cfg, "weights": spec}, flat, _load_tree)


def build_codec(cfg: dict, model, device):
    return family(cfg).build_codec(model, device)


def spans():
    """The port's ``recording()``: a context that yields the list of the
    spans that every thread of the port closes meanwhile, whatever their
    names."""
    from compression_tpu_torch.util import profiling

    return profiling.recording()


def launches() -> dict:
    """The port's launch counters of K1, the general GDN kernel, K3 and K2."""
    from compression_tpu_torch.codec import rans
    from compression_tpu_torch.layers import gdn_kernel

    return {"K1": gdn_kernel.fused_gdn.launches,
            "gdn_general": gdn_kernel.fused_gdn_general.launches,
            "K3": rans.rans_encode.launches, "K2": rans.rans_decode.launches}


class Training:
    """One training state of the port: the model in train mode on the
    device, Adam from the port's ``make_optimizer`` and its schedule, and
    the loss from the family's ``make_loss_fn``; :meth:`step` is the
    port's ``train_step`` on a uint8 batch copied to the card as the port's
    loop copies it."""

    def __init__(self, cfg: dict, model, device, generator):
        from compression_tpu_torch.models import common
        from compression_tpu_torch.util.device import strict_fp32

        fam = family(cfg)
        if not hasattr(fam, "make_loss_fn"):
            raise ValueError(f"the family {cfg['family']!r} gives no training loss")
        tc = cfg["training"]
        self.common = common
        self.device = torch.device(device)
        if self.device.type == "cuda":
            strict_fp32()
        self.model = model.to(self.device).train()
        self.tcfg = common.TrainConfig(batch_size=tc["batch_size"], patch_size=tc["patch_size"],
                                       learning_rate=tc["learning_rate"],
                                       lr_schedule="constant", augment=True)
        self.optimizer = common.make_optimizer(self.model, self.tcfg)
        self.schedule = common.lr_schedule(self.tcfg)
        self.loss_fn = fam.make_loss_fn(self.model)
        self.generator = generator

    def upload(self, batch):
        t = torch.from_numpy(batch)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def step(self, batch):
        return self.common.train_step(self.model, self.optimizer, self.loss_fn,
                                      self.upload(batch), self.generator, self.schedule)
