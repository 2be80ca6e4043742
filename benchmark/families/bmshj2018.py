"""The port's bmshj2018: its model (from the checkpoint by the port's own
reader, or from the benchmark's weights), its codec and its training
loss."""

from __future__ import annotations


def build_model(cfg: dict, flat: dict, load_tree):
    from compression_tpu_torch.models import bmshj2018

    if cfg["weights"]["origin"] == "checkpoint":
        return bmshj2018.load_model(str(cfg["weights"]["file"]))
    model = bmshj2018.BMSHJ2018Model(bmshj2018.Config(**cfg["program_config"]))
    load_tree(model, flat)
    return model


def build_codec(model, device):
    from compression_tpu_torch.models import bmshj2018

    return bmshj2018.Codec(model, device=device)


def make_loss_fn(model):
    from compression_tpu_torch.models import bmshj2018

    return bmshj2018.make_loss_fn(model)
