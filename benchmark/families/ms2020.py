"""The port's ms2020-cc10 (CHARM): its model at the configuration's widths
holding the benchmark's weights, and its codec. Its y rows come slice by
slice from ``Codec._slice_rows``, which its encoder and its decoder both
call. No cell trains it, so it gives no loss."""

from __future__ import annotations

# The codec's method that gives (mu, CDF rows) to both sides.
ROWS = "_slice_rows"


def build_model(cfg: dict, flat: dict, load_tree):
    from compression_tpu_torch.models import ms2020

    model = ms2020.MS2020Model(ms2020.Config(**{**cfg.get("program_config", {}),
                                                **cfg["widths"]}))
    load_tree(model, flat)
    return model


def build_codec(model, device):
    from compression_tpu_torch.models import ms2020

    return ms2020.Codec(model, device=device)
