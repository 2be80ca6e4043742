"""The port's HiFiC (the G side: encoder, generator, mbt2018's hyper pair):
its model at the configuration's widths holding the benchmark's weights,
and its codec. No cell trains it, so it gives no loss."""

from __future__ import annotations


def build_model(cfg: dict, flat: dict, load_tree):
    from compression_tpu_torch.models.hific import configs, model as hific

    base = configs.get_config(cfg["program_config"]["name"])
    overrides = {k: v for k, v in cfg["widths"].items() if getattr(base, k, None) != v}
    model = hific.HificModel(configs.HificConfig(**{**base.__dict__, **overrides}))
    load_tree(model, flat)
    return model


def build_codec(model, device):
    from compression_tpu_torch.models.hific import model as hific

    return hific.Codec(model, device=device)
