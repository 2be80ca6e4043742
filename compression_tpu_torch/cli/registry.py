"""Model registry: names -> (model family, config, checkpoint)
(counterpart of ``compression_tpu/cli/registry.py``, name for name).

Model *names* are stable identifiers embedded in .tfci files; the registry
resolves them to the port's seeded module, whose weights the CLI then loads
from a flax msgpack checkpoint in the model directory (``TPC_MODEL_DIR``,
default ``~/.cache/compression_tpu``). Both packages resolve a name to the
same checkpoint file, so they share one model directory, its checkpoints
and their table files.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Callable, Dict, Optional, Tuple

__all__ = [
    "ModelEntry",
    "REGISTRY",
    "VARIABLE_RATE",
    "checkpoint_path",
    "resolve",
    "model_dir",
    "list_models",
]


@dataclasses.dataclass(frozen=True)
class ModelEntry:
    family: str                 # module name under compression_tpu_torch/models
    make_model: Callable        # () -> seeded torch module
    compress: Callable          # (model, image, [coder=], device=) -> bytes
    decompress: Callable        # (model, data, device=) -> image
    description: str = ""
    config: object = None       # the family Config used by make_model


def _tiny_overrides() -> dict:
    """TPC_TINY_MODELS=1 shrinks every registry model (CI / smoke tests)."""
    if os.environ.get("TPC_TINY_MODELS") == "1":
        # num_slices must divide num_latents (ms2020).
        return dict(
            num_filters=8, num_latents=8, num_hyperlatents=4, num_slices=4
        )
    return {}


def _filter_kwargs(cfg_cls, kw: dict) -> dict:
    import dataclasses as _dc

    names = {f.name for f in _dc.fields(cfg_cls)}
    return {k: v for k, v in kw.items() if k in names}


def _bls2017(lmbda: float = 0.01, name: Optional[str] = None,
         distortion: str = "mse"):
    from compression_tpu_torch.models import bls2017

    cfg = bls2017.Config(
        lmbda=lmbda, distortion=distortion,
        **_filter_kwargs(bls2017.Config, _tiny_overrides()),
    )
    if name:
        cfg = dataclasses.replace(cfg, model_name=name)
    return ModelEntry(
        "bls2017",
        lambda: bls2017.BLS2017Model(cfg),
        bls2017.compress,
        bls2017.decompress,
        "factorized prior (Ballé et al. 2017)",
        config=cfg,
    )


def _bmshj2018(lmbda: float = 0.01, name: Optional[str] = None,
         distortion: str = "mse"):
    from compression_tpu_torch.models import bmshj2018

    cfg = bmshj2018.Config(
        lmbda=lmbda, distortion=distortion,
        **_filter_kwargs(bmshj2018.Config, _tiny_overrides()),
    )
    if name:
        cfg = dataclasses.replace(cfg, model_name=name)
    return ModelEntry(
        "bmshj2018",
        lambda: bmshj2018.BMSHJ2018Model(cfg),
        bmshj2018.compress,
        bmshj2018.decompress,
        "scale hyperprior (Ballé et al. 2018)",
        config=cfg,
    )


def _mbt2018(lmbda: float = 0.01, name: Optional[str] = None,
         distortion: str = "mse"):
    from compression_tpu_torch.models import mbt2018

    cfg = mbt2018.Config(
        lmbda=lmbda, distortion=distortion,
        **_filter_kwargs(mbt2018.Config, _tiny_overrides()),
    )
    if name:
        cfg = dataclasses.replace(cfg, model_name=name)
    return ModelEntry(
        "mbt2018",
        lambda: mbt2018.MBT2018Model(cfg),
        mbt2018.compress,
        mbt2018.decompress,
        "mean-scale hyperprior (Minnen et al. 2018)",
        config=cfg,
    )


def _ms2020(lmbda: float = 0.01, name: Optional[str] = None,
         distortion: str = "mse"):
    from compression_tpu_torch.models import ms2020

    cfg = ms2020.Config(
        lmbda=lmbda, distortion=distortion,
        **_filter_kwargs(ms2020.Config, _tiny_overrides()),
    )
    if name:
        cfg = dataclasses.replace(cfg, model_name=name)
    return ModelEntry(
        "ms2020",
        lambda: ms2020.MS2020Model(cfg),
        ms2020.compress,
        ms2020.decompress,
        "channel-wise autoregressive, CHARM (Minnen & Singh 2020)",
        config=cfg,
    )


def _bmshj2018_factorized(lmbda: float = 0.01, name: Optional[str] = None,
         distortion: str = "mse"):
    """bmshj2018's factorized-prior baseline: the 4x 5x5/2 transform pair
    with a DeepFactorized prior directly on y, no hyperprior (reference zoo
    `bmshj2018-factorized-*`, models/tfci.py model list)."""
    from compression_tpu_torch.models import bls2017

    kw = dict(num_filters=192, num_latents=192)
    kw.update(_filter_kwargs(bls2017.Config, _tiny_overrides()))
    cfg = bls2017.Config(
        lmbda=lmbda, distortion=distortion, arch="bmshj2018",
        model_name="bmshj2018-factorized", **kw,
    )
    if name:
        cfg = dataclasses.replace(cfg, model_name=name)
    return ModelEntry(
        "bls2017",
        lambda: bls2017.BLS2017Model(cfg),
        bls2017.compress,
        bls2017.decompress,
        "factorized prior over bmshj2018 transforms (Ballé et al. 2018)",
        config=cfg,
    )


def _b2018(activation: str, base: str, num_filters: int = 128):
    """Variable-rate family: ONE checkpoint serves all rate points; the
    quality suffix selects a runtime conditioning input, not a separate
    per-lambda checkpoint (reference: models/tfci.py b2018-* models +
    --rd_parameter)."""

    def make(quality, name: Optional[str] = None) -> ModelEntry:
        from compression_tpu_torch.models import b2018

        kw = dict(num_filters=num_filters)
        kw.update(_filter_kwargs(b2018.Config, _tiny_overrides()))
        cfg = b2018.Config(activation=activation, model_name=base, **kw)
        # First positional arg is the runtime quality for this family; other
        # callers (cmd_models listing) pass a lambda-shaped float: ignore it.
        if quality and isinstance(quality, int):
            if not 1 <= quality <= cfg.num_qualities:
                raise KeyError(
                    f"{base} quality {quality} out of range "
                    f"1..{cfg.num_qualities}"
                )
            cfg = dataclasses.replace(cfg, quality=quality)
        if name:
            cfg = dataclasses.replace(cfg, model_name=name)
        return ModelEntry(
            "b2018",
            lambda: b2018.B2018Model(cfg),
            b2018.compress,
            b2018.decompress,
            f"variable-rate factorized, {activation} "
            f"(Ballé 2018); one checkpoint, {cfg.num_qualities} rate points",
            config=cfg,
        )

    return make


def _hific(name: str):
    def make(_lmbda: float, requested: Optional[str] = None) -> ModelEntry:
        from compression_tpu_torch.models import hific

        cfg = hific.get_config(name)
        if requested and requested != cfg.name:
            # Keep the self-describing .tfci name equal to the resolved
            # registry name so decompress round-trips to this checkpoint.
            cfg = dataclasses.replace(cfg, name=requested)
        return ModelEntry(
            "hific",
            lambda: hific.HificModel(cfg),
            hific.compress,
            hific.decompress,
            f"generative codec @ {cfg.target_rate} bpp (Mentzer et al. 2020)",
        )

    return make


# Quality index -> lambda, approximating the reference's quality ladders
# (reference: models/bmshj2018.py λ sweep for qualities 1-8). MS-SSIM
# models weight `1 - MS-SSIM` instead of 255^2-MSE, so their lambdas live
# on a different scale (the standard 8-point msssim ladder).
_LAMBDA_LADDER = (0.0016, 0.0032, 0.0075, 0.015, 0.03, 0.045, 0.08, 0.14)
_MSSSIM_LADDER = (2.40, 4.58, 8.73, 16.64, 31.73, 60.50, 115.37, 220.0)


def _ladder_lambda(quality: int, base: str) -> float:
    ladder = _MSSSIM_LADDER if base.endswith("msssim") else _LAMBDA_LADDER
    if not 1 <= quality <= len(ladder):
        raise KeyError(f"quality {quality} out of range 1..{len(ladder)}")
    return ladder[quality - 1]


# Base builders (lmbda, requested_name) -> ModelEntry; quality-suffixed
# names resolve through `resolve`.
import functools as _ft

REGISTRY: Dict[str, Callable[..., ModelEntry]] = {
    "bls2017-factorized-mse": _bls2017,
    "bls2017-factorized-msssim": _ft.partial(_bls2017, distortion="msssim"),
    "bmshj2018-hyperprior-msssim": _ft.partial(
        _bmshj2018, distortion="msssim"
    ),
    "mbt2018-mean-msssim": _ft.partial(_mbt2018, distortion="msssim"),
    "ms2020-cc10-msssim": _ft.partial(_ms2020, distortion="msssim"),
    "bmshj2018-hyperprior": _bmshj2018,
    "bmshj2018-hyperprior-mse": _bmshj2018,
    "mbt2018-mean": _mbt2018,
    "mbt2018-mean-mse": _mbt2018,
    "ms2020-cc10": _ms2020,
    "ms2020-cc10-mse": _ms2020,
    "hific-lo": _hific("hific-lo"),
    "hific-mi": _hific("hific-mi"),
    "hific-hi": _hific("hific-hi"),
    "bmshj2018-factorized-mse": _bmshj2018_factorized,
    "bmshj2018-factorized-msssim": _ft.partial(
        _bmshj2018_factorized, distortion="msssim"
    ),
    "bmshj2018-factorized": _bmshj2018_factorized,
    "b2018-gdn-128": _b2018("gdn", "b2018-gdn-128"),
    "b2018-leaky_relu-128": _b2018("leaky_relu", "b2018-leaky_relu-128"),
    "b2018-gdn-192": _b2018("gdn", "b2018-gdn-192", num_filters=192),
    "b2018-leaky_relu-192": _b2018(
        "leaky_relu", "b2018-leaky_relu-192", num_filters=192
    ),
    # Short aliases.
    "bls2017": _bls2017,
    "bmshj2018": _bmshj2018,
    "mbt2018": _mbt2018,
    "ms2020": _ms2020,
    "b2018": _b2018("gdn", "b2018-gdn-128"),
}

# Families whose quality suffix is a RUNTIME input to one shared checkpoint
# (everything else resolves a quality suffix to its own per-lambda ckpt).
VARIABLE_RATE = {
    "b2018-gdn-128", "b2018-leaky_relu-128",
    "b2018-gdn-192", "b2018-leaky_relu-192", "b2018",
}

# Alias -> canonical checkpoint stem: `tfci train b2018` and
# `tfci compress b2018-gdn-128-2` must hit the SAME checkpoint file (the
# alias is the same model; without this they silently trained/served
# separate weights).
_CANONICAL_STEM = {"b2018": "b2018-gdn-128"}


def model_dir() -> str:
    return os.environ.get(
        "TPC_MODEL_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "compression_tpu"),
    )


def list_models():
    return sorted(set(REGISTRY))


def _split_name(name: str) -> Tuple[str, Optional[int]]:
    base, quality = name, None
    m = re.fullmatch(r"(.+)-(\d+)", name)
    if m and m.group(1) in REGISTRY:
        base, quality = m.group(1), int(m.group(2))
    if base not in REGISTRY:
        raise KeyError(
            f"unknown model {name!r}; known: {', '.join(list_models())}"
        )
    return base, quality


def checkpoint_path(name: str) -> str:
    """The canonical checkpoint file for a model name: variable-rate
    families share one checkpoint under their base name; everything else
    keeps a per-name (per-lambda) checkpoint."""
    base, _ = _split_name(name)
    stem = _CANONICAL_STEM.get(base, base) if base in VARIABLE_RATE else name
    return os.path.join(model_dir(), f"{stem}.msgpack")


def resolve(name: str) -> Tuple[ModelEntry, Optional[str]]:
    """Resolves a model name (optionally quality-suffixed, e.g.
    ``bmshj2018-hyperprior-mse-6``) to an entry + checkpoint path (or None
    if no checkpoint exists yet)."""
    base, quality = _split_name(name)
    # Propagate the *requested* name into the config: compress() packs
    # config.model_name into the self-describing .tfci blob, and decompress()
    # resolves that packed name back to a checkpoint, so the packed name
    # must always equal the name the user encoded with, or aliases and
    # quality-suffixed names desync from their checkpoints.
    if base in VARIABLE_RATE:
        # One checkpoint serves every rate point; the suffix is a runtime
        # conditioning input (reference: tfci.py b2018 --rd_parameter).
        entry = REGISTRY[base](quality, name)
    else:
        if quality is not None:
            lmbda = _ladder_lambda(quality, base)
        else:
            lmbda = 31.73 if base.endswith("msssim") else 0.01
        entry = REGISTRY[base](lmbda, name)
    ckpt = checkpoint_path(name)
    return entry, (ckpt if os.path.exists(ckpt) else None)
