"""tfci-compatible CLI: compress / decompress / models / dump / eval / train
(counterpart of ``compression_tpu/cli/tfci.py``, verb for verb).

Model names resolve through the registry to a flax-layout msgpack
checkpoint in the model directory (``TPC_MODEL_DIR``), which both packages
read and write; so are the ``.tfci`` blobs (self-describing: ``decompress``
needs no model argument), the ``.train.msgpack`` resume states, the
``<ckpt>.<mtime_ns>.<size>.tables.npz`` table files and ``dump --output``'s
``.npz``. Everything runs on the card unless ``--device cpu`` is given.

Usage:
  python -m compression_tpu_torch.cli.tfci models
  python -m compression_tpu_torch.cli.tfci compress bmshj2018-hyperprior-mse-6 in.png [out.tfci]
  python -m compression_tpu_torch.cli.tfci decompress out.tfci [out.png] [--jit]
  python -m compression_tpu_torch.cli.tfci dump out.tfci
  python -m compression_tpu_torch.cli.tfci train bls2017 --steps 1000 --glob 'data/*.png'
  python -m compression_tpu_torch.cli.tfci --device cpu eval bls2017 'data/*.png'
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from compression_tpu_torch.cli import registry
from compression_tpu_torch.util import PackedTensors
from compression_tpu_torch.util import image as image_util
from compression_tpu_torch.util.device import resolve_device, strict_fp32

_DEVICE_CODER_FAMILIES = ("bmshj2018", "ms2020", "mbt2018", "hific")


def _load_model(name: str, allow_random: bool = False, device="cuda"):
    """Resolves ``name``, loads its checkpoint into the seeded module, moves
    it to ``device`` and binds its table file to it. Returns (entry,
    model)."""
    from compression_tpu_torch.models.codec_cache import register_table_cache
    from compression_tpu_torch.models.common import load_checkpoint

    entry, ckpt = registry.resolve(name)
    if ckpt is None and not allow_random:
        # Fail fast, before the (expensive) model build.
        raise FileNotFoundError(
            f"no checkpoint for {name!r} in {registry.model_dir()} — train "
            f"one (tfci train {name}) or pass --allow-random for testing"
        )
    model = entry.make_model()
    if ckpt is not None:
        params, _, _ = load_checkpoint(ckpt)
        model.load_state_dict(params)
    model.to(device)
    if ckpt is not None:
        # Range-coder tables live next to the checkpoint, keyed by its
        # mtime and size so that retraining invalidates them; the JAX
        # package names the file the same way, so either package reads the
        # other's. Bound to THIS module in its loaded state (after the move:
        # the binding holds the tensors' storage).
        st = os.stat(ckpt)
        register_table_cache(
            model, f"{ckpt}.{st.st_mtime_ns}.{st.st_size}.tables.npz"
        )
    return entry, model


def cmd_models(args) -> int:
    for name in registry.list_models():
        entry = registry.REGISTRY[name](0.01)
        print(f"{name:32s} {entry.description}")
    return 0


def _spatial_codec(entry, model, n: int, device):
    """The family's giant-image SpatialCodec over a mesh of ``n`` devices
    (the visible cards, or ``n`` virtual shards of the CPU with ``--device
    cpu``; transforms H-sharded, see ``models/<family>.SpatialCodec``)."""
    import importlib

    from compression_tpu_torch.parallel.data_parallel import make_mesh

    if entry.family not in ("bls2017", "bmshj2018", "mbt2018", "ms2020", "hific"):
        raise SystemExit(
            f"--spatial needs one of the codec families bls2017/bmshj2018/"
            f"mbt2018/ms2020/hific; got {entry.family!r}"
        )
    kind = resolve_device(device).type
    ndev = torch.cuda.device_count() if kind == "cuda" else os.cpu_count()
    if not 1 <= n <= ndev:
        raise SystemExit(f"--spatial {n}: this process sees {ndev} device(s)")
    mod = importlib.import_module(
        "compression_tpu_torch.models.hific.model" if entry.family == "hific"
        else f"compression_tpu_torch.models.{entry.family}"
    )
    return mod.SpatialCodec(model, make_mesh(n, device=device))


def cmd_compress(args) -> int:
    name = args.model
    if args.rd_parameter is not None:
        # A runtime rate point for variable-rate models, equivalent to the
        # quality suffix: `compress b2018-gdn-128 --rd_parameter 2` ==
        # `compress b2018-gdn-128-2`.
        base, quality = registry._split_name(name)
        if base not in registry.VARIABLE_RATE:
            raise SystemExit(
                f"--rd_parameter only applies to variable-rate models "
                f"({', '.join(sorted(registry.VARIABLE_RATE))}); {name!r} selects "
                f"its rate via per-quality checkpoints"
            )
        if quality is not None and quality != int(args.rd_parameter):
            raise SystemExit(
                f"conflicting rate points: name says {quality}, "
                f"--rd_parameter says {args.rd_parameter}"
            )
        name = f"{base}-{int(args.rd_parameter)}"
    entry, model = _load_model(name, args.allow_random, args.device)
    image = image_util.read_png(args.input)
    if args.device_coder:
        # y is rANS-coded on the card (kernels K3/K2); decompress detects
        # the format.
        if entry.family not in _DEVICE_CODER_FAMILIES:
            raise SystemExit(
                f"--device-coder needs a hyperprior family (bmshj2018/"
                f"mbt2018/ms2020/hific); {name!r} is {entry.family}"
            )
        data = entry.compress(model, image, coder="device", device=args.device)
    elif args.spatial:
        # Giant-image mode: the transforms H-sharded over a mesh.
        data = _spatial_codec(entry, model, args.spatial, args.device).compress(image)
    else:
        data = entry.compress(model, image, device=args.device)
    out = args.output or args.input + ".tfci"
    with open(out, "wb") as f:
        f.write(data)
    bpp = len(data) * 8 / (image.shape[0] * image.shape[1])
    print(f"{out}: {len(data)} bytes, {bpp:.4f} bpp")
    return 0


def cmd_decompress(args) -> int:
    with open(args.input, "rb") as f:
        data = f.read()
    name = PackedTensors(data).model
    entry, model = _load_model(name, args.allow_random, args.device)
    if args.jit:
        # The single-program decode: the host range-decodes the streams,
        # the device segments between run as CUDA graphs; byte-equal to
        # the staged decode.
        if entry.family != "bmshj2018":
            raise SystemExit(
                f"--jit decode is implemented for the bmshj2018 family; "
                f"{name!r} is {entry.family}"
            )
        from compression_tpu_torch.models import bmshj2018

        codec = bmshj2018.make_codec(model, args.device)
        image = codec.decompress_batch_jit([data])[0]
    elif args.spatial:
        image = _spatial_codec(entry, model, args.spatial, args.device).decompress(data)
    else:
        image = entry.decompress(model, data, device=args.device)
    out = args.output or os.path.splitext(args.input)[0] + ".png"
    image_util.write_png(out, image)
    print(f"{out}: {image.shape[1]}x{image.shape[0]} (model {name})")
    return 0


def cmd_dump(args) -> int:
    with open(args.input, "rb") as f:
        packed = PackedTensors(f.read())
    print(f"model: {packed.model}")
    for key, kind, count, size in packed.describe():
        if key == "MD":
            continue
        print(f"tensor {key}: {kind:6s} x{count:<8d} {size} bytes")
    if args.output:
        # One .npz holds every tensor: int64/float features as 1-D arrays
        # under their positional key; bytes features as uint8 arrays (key
        # "<i>" for a single string, "<i>.<j>" per element otherwise) so
        # the raw bitstreams are recoverable with .tobytes().
        arrays = {"model": np.array(packed.model)}
        for key, kind, count, _size in packed.describe():
            if key == "MD":
                continue
            if kind == "bytes":
                vals = packed.unpack_one(int(key), object)
                if count == 1:
                    arrays[key] = np.frombuffer(vals[0], np.uint8)
                else:
                    for j, v in enumerate(vals):
                        arrays[f"{key}.{j}"] = np.frombuffer(v, np.uint8)
            else:
                arrays[key] = packed.unpack_one(
                    int(key), np.int64 if kind == "int64" else np.float32
                )
        np.savez(args.output, **arrays)
        print(f"wrote {args.output} ({len(arrays)} arrays)")
    return 0


# Config fields that are training or rate knobs: --init-from may differ in
# these, and must match in every other (architecture) field.
_NON_ARCH = {
    "lmbda", "distortion", "model_name", "quality", "name",
    "target_rate", "lambda_a", "lambda_b", "gan_warmup_steps",
    "rate_probe_glob", "rate_probe_every", "lr", "disc_lr",
    "hinge_boundary_ring", "hinge_softness", "probe_ema",
    "hinge_integral", "k_mse_scale",
}


def _warm_start(args, entry):
    """--init-from: the state dict of another trained model of the same
    family and architecture (fine-tuning, e.g. -msssim from its -mse
    twin)."""
    import dataclasses

    src_entry, src_ckpt = registry.resolve(args.init_from)
    if src_entry.family != entry.family:
        raise SystemExit(
            f"--init-from {args.init_from!r} is family "
            f"{src_entry.family}, target is {entry.family} — architectures "
            f"must match to transfer parameters"
        )
    if src_ckpt is None:
        raise SystemExit(
            f"--init-from {args.init_from!r}: no checkpoint in "
            f"{registry.model_dir()}"
        )
    src_cfg, dst_cfg = src_entry.config, entry.config
    if src_cfg is not None and dst_cfg is not None:
        mismatches = [
            f"{f.name}: {getattr(src_cfg, f.name)!r} != "
            f"{getattr(dst_cfg, f.name)!r}"
            for f in dataclasses.fields(type(dst_cfg))
            if f.name not in _NON_ARCH
            and hasattr(src_cfg, f.name)
            and getattr(src_cfg, f.name) != getattr(dst_cfg, f.name)
        ]
        if mismatches:
            raise SystemExit(
                f"--init-from {args.init_from!r}: architecture differs "
                f"from {args.model!r} — " + "; ".join(mismatches)
            )
    _, model = _load_model(args.init_from, device="cpu")
    print(f"warm-start from {args.init_from} ({src_ckpt})")
    return model.state_dict()


def _hific_config(args, warm):
    import dataclasses

    from compression_tpu_torch.models import hific

    if args.lmbda is not None:
        raise SystemExit(
            "--lmbda does not apply to HiFiC (it uses target_rate + "
            "loss weights from its named config; edit "
            "models/hific/configs.py or pick hific-lo/mi/hi)"
        )
    hcfg = hific.get_config(args.model)
    if args.gan_warmup:
        hcfg = dataclasses.replace(hcfg, gan_warmup_steps=args.gan_warmup)
    if args.rate_probe_glob:
        hcfg = dataclasses.replace(
            hcfg,
            rate_probe_glob=args.rate_probe_glob,
            rate_probe_every=args.rate_probe_every,
        )
    if args.hinge_softness:
        hcfg = dataclasses.replace(hcfg, hinge_softness=args.hinge_softness)
    if args.probe_ema:
        hcfg = dataclasses.replace(hcfg, probe_ema=args.probe_ema)
    if args.hinge_integral:
        if not hcfg.rate_probe_glob:
            raise SystemExit(
                "--hinge-integral requires --rate-probe-glob (the "
                "integrator consumes the probe's measured rate)"
            )
        hcfg = dataclasses.replace(hcfg, hinge_integral=args.hinge_integral)
    if args.k_mse_scale != 1.0:
        hcfg = dataclasses.replace(hcfg, k_mse_scale=args.k_mse_scale)
    # --init-from warm-starts the GENERATOR only (the checkpoint holds G);
    # the discriminator restarts fresh, so --gan-warmup lets G settle at
    # the new patch statistics before the new D's gradients reach it.
    if warm is not None and not args.gan_warmup:
        print(
            "note: --init-from with a fresh discriminator and no "
            "--gan-warmup; consider --gan-warmup to let G settle first"
        )
    return hcfg


def cmd_train(args) -> int:
    import dataclasses
    import importlib

    from compression_tpu_torch.models.common import TrainConfig, save_checkpoint

    entry, _ = registry.resolve(args.model)
    family = entry.family
    # The training checkpoint shares its stem with the eval checkpoint
    # (registry.checkpoint_path): aliases and variable-rate quality
    # suffixes canonicalize there, so `train b2018` and `train
    # b2018-gdn-128` resume one training state, the one eval reads.
    stem = os.path.splitext(
        os.path.basename(registry.checkpoint_path(args.model))
    )[0]
    tc = TrainConfig(
        train_glob=args.glob,
        batch_size=args.batch_size,
        patch_size=args.patch_size,
        steps=args.steps,
        checkpoint_dir=registry.model_dir(),
        checkpoint_name=f"{stem}.train.msgpack",
        checkpoint_every=args.checkpoint_every,
        num_devices=args.num_devices,
        learning_rate=args.lr,
        lr_schedule=args.lr_schedule,
        lr_final_scale=args.lr_final_scale,
    )
    warm = _warm_start(args, entry) if args.init_from else None
    if family == "hific":
        from compression_tpu_torch.models import hific

        # hific.train returns (G, D); the checkpoint holds G alone, the tree
        # the JAX package's loader expects.
        model, _ = hific.train(_hific_config(args, warm), tc, params=warm,
                               device=args.device)
    else:
        mod = importlib.import_module(f"compression_tpu_torch.models.{family}")
        # The registry's config (quality lambdas, TPC_TINY_MODELS), with the
        # CLI lambda taking precedence.
        cfg = entry.config
        if args.lmbda is not None:
            if not any(f.name == "lmbda" for f in dataclasses.fields(cfg)):
                raise SystemExit(
                    f"--lmbda does not apply to {family} (variable-rate: "
                    f"its rate points come from the config's lambdas "
                    f"ladder; pick a quality at compress time instead)"
                )
            cfg = dataclasses.replace(cfg, lmbda=args.lmbda)
        model = mod.train(cfg, tc, params=warm, device=args.device)
    # Variable-rate families save under their base name (one checkpoint
    # serves all rate points): checkpoint_path knows.
    path = registry.checkpoint_path(args.model)
    save_checkpoint(path, model, tc.steps)
    print(f"saved {path}")
    return 0


def cmd_eval(args) -> int:
    """R-D evaluation over an image glob: per-image bpp / PSNR / MS-SSIM +
    means."""
    import glob as globlib

    entry, model = _load_model(args.model, args.allow_random, args.device)
    paths = sorted(globlib.glob(args.glob))
    if not paths:
        raise FileNotFoundError(f"no images match {args.glob!r}")
    # Metric choice is made once for the whole set: MS-SSIM needs >= 176px
    # at the smallest dim; mixing single-scale SSIM rows into an MS-SSIM
    # column (and its mean) would blend incompatible metrics.
    sizes = [image_util.read_png(p).shape[:2] for p in paths]
    use_ms = all(min(h, w) >= 176 for h, w in sizes)
    metric_name = "msssim" if use_ms else "ssim"
    if not use_ms:
        print(
            "note: images below 176px present — reporting single-scale "
            "SSIM for the whole set instead of MS-SSIM"
        )
    lpips_fn = None
    if args.lpips:
        # The HiFiC eval metric. Without converted weights the random-VGG
        # fallback is a smoke-grade proxy, and make_lpips says so.
        from compression_tpu_torch.models.hific.lpips import make_lpips

        lp = make_lpips().to(args.device)

        def lpips_fn(a, b):
            with torch.no_grad():
                return float(lp(a[None] / 255.0, b[None] / 255.0)[0])
    # Rate-targeted models (HiFiC): each image's bpp against the config's
    # target, so the rate controller's tracking shows at eval time.
    target_rate = None
    if entry.family == "hific":
        from compression_tpu_torch.models import hific

        target_rate = hific.get_config(
            registry._split_name(args.model)[0]
        ).target_rate
    rows = []
    for path in paths:
        image = image_util.read_png(path)
        data = entry.compress(model, image, device=args.device)
        recon = entry.decompress(model, data, device=args.device)
        bpp = len(data) * 8 / (image.shape[0] * image.shape[1])
        a = torch.from_numpy(image).to(args.device, torch.float32)
        b = torch.from_numpy(recon).to(args.device, torch.float32)
        with torch.no_grad():
            psnr = float(image_util.psnr(a, b))
            ms = float(image_util.msssim(a, b) if use_ms else image_util.ssim(a, b))
        row = [os.path.basename(path), bpp, psnr, ms]
        extra = ""
        if lpips_fn is not None:
            row.append(lpips_fn(a, b))
            extra = f" lpips={row[-1]:.4f}"
        rows.append(tuple(row))
        tgt = (
            f" (target {target_rate:.2f}, x{bpp / target_rate:.2f})"
            if target_rate else ""
        )
        print(
            f"{rows[-1][0]:24s} bpp={bpp:.4f}{tgt} psnr={psnr:.2f} "
            f"{metric_name}={ms:.4f}" + extra
        )
    mean = np.mean(np.array([r[1:] for r in rows], np.float64), axis=0)
    extra = f" lpips={mean[3]:.4f}" if lpips_fn is not None else ""
    tgt = (
        f" (target {target_rate:.2f}, x{mean[0] / target_rate:.2f})"
        if target_rate else ""
    )
    print(
        f"{'MEAN':24s} bpp={mean[0]:.4f}{tgt} psnr={mean[1]:.2f} "
        f"{metric_name}={mean[2]:.4f}" + extra
    )
    if args.csv:
        lp_col = ",lpips" if lpips_fn is not None else ""
        with open(args.csv, "w") as f:
            f.write(f"image,bpp,psnr,{metric_name}{lp_col}\n")
            for row in rows:
                f.write(
                    row[0] + "," + ",".join(f"{v:.6f}" for v in row[1:])
                    + "\n"
                )
            f.write(
                "mean," + ",".join(f"{v:.6f}" for v in mean) + "\n"
            )
        print(f"wrote {args.csv}")
    return 0


_SPATIAL_HELP = (
    "giant-image mode: run the transforms H-sharded over an N-device mesh "
    "(N cards, or N virtual CPU shards with --device cpu); entropy coding "
    "stays on the host. Decode a spatially-coded stream with the same mesh "
    "size for guaranteed bit-exact row math"
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tfci", description=__doc__)
    p.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the transforms run: the card (default; raises without "
        "CUDA) or the CPU",
    )
    p.add_argument(
        "--strict-f32", action="store_true",
        default=os.environ.get("TPC_STRICT_F32") == "1",
        help="accepted for the JAX CLI's sake: this package always runs "
        "float32-strict (no TF32, deterministic cuDNN)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("models", help="list available models")
    sp.set_defaults(fn=cmd_models)

    sp = sub.add_parser("compress", help="compress a PNG to .tfci")
    sp.add_argument("model")
    sp.add_argument("input")
    sp.add_argument("output", nargs="?")
    sp.add_argument("--allow-random", action="store_true")
    sp.add_argument(
        "--rd_parameter", type=int, default=None,
        help="runtime rate point for variable-rate models (b2018-*); "
        "equivalent to the -N quality suffix",
    )
    sp.add_argument(
        "--device-coder", action="store_true",
        help="entropy-code the main latent ON the card (K-lane rANS) "
        "instead of the host range coder; only compressed words cross to "
        "the host (hyperprior families; decompress detects the format)",
    )
    sp.add_argument("--spatial", type=int, default=None, metavar="N",
                    help=_SPATIAL_HELP)
    sp.set_defaults(fn=cmd_compress)

    sp = sub.add_parser("decompress", help="decompress a .tfci to PNG")
    sp.add_argument("input")
    sp.add_argument("output", nargs="?")
    sp.add_argument("--allow-random", action="store_true")
    sp.add_argument(
        "--jit", action="store_true",
        help="single-program decode (bmshj2018 family): the host range-"
             "decodes the streams, the device segments run as CUDA graphs; "
             "byte-identical to the staged decode",
    )
    sp.add_argument("--spatial", type=int, default=None, metavar="N",
                    help=_SPATIAL_HELP)
    sp.set_defaults(fn=cmd_decompress)

    sp = sub.add_parser("dump", help="inspect a .tfci container")
    sp.add_argument("input")
    sp.add_argument(
        "--output", default=None,
        help="also extract every packed tensor to this .npz (bytes "
        "features land as uint8 arrays)",
    )
    sp.set_defaults(fn=cmd_dump)

    sp = sub.add_parser("eval", help="R-D evaluation over an image glob")
    sp.add_argument("model")
    sp.add_argument("glob")
    sp.add_argument("--csv", default=None)
    sp.add_argument("--allow-random", action="store_true")
    sp.add_argument(
        "--lpips", action="store_true",
        help="add an LPIPS column (needs converted weights for parity; "
        "random-VGG fallback is smoke-grade and warns)",
    )
    sp.set_defaults(fn=cmd_eval)

    sp = sub.add_parser("train", help="train a model into the local registry")
    sp.add_argument("model")
    sp.add_argument("--glob", default=None)
    sp.add_argument("--steps", type=int, default=10000)
    sp.add_argument("--batch-size", type=int, default=8)
    sp.add_argument("--patch-size", type=int, default=256)
    sp.add_argument("--lmbda", type=float, default=None)
    sp.add_argument("--num-devices", type=int, default=1)
    sp.add_argument("--checkpoint-every", type=int, default=500)
    sp.add_argument("--lr", type=float, default=1e-4)
    sp.add_argument(
        "--lr-schedule", default="constant",
        choices=("constant", "step", "cosine"),
        help="lr over [0, steps]: step = 10x drop at 85%% (reference "
             "recipe), cosine = smooth decay to lr * lr-final-scale",
    )
    sp.add_argument("--lr-final-scale", type=float, default=0.1)
    sp.add_argument(
        "--gan-warmup", type=int, default=0, metavar="N",
        help="HiFiC only: train the generator on mse+lpips+rate for the "
             "first N steps before enabling the GAN term and the "
             "discriminator updates (HificConfig.gan_warmup_steps)",
    )
    sp.add_argument(
        "--rate-probe-glob", default=None, metavar="GLOB",
        help="HiFiC only: hinge the rate controller on the measured bpp "
             "of these full-resolution TRAIN-distribution images instead "
             "of the training-patch bpp (HificConfig.rate_probe_glob)",
    )
    sp.add_argument("--rate-probe-every", type=int, default=100)
    sp.add_argument(
        "--hinge-softness", type=float, default=0.0, metavar="S",
        help="HiFiC only: log-proportional rate controller — lambda "
             "interpolates lambda_b -> lambda_a geometrically over rate in "
             "[target/2^S, target*2^S]; 0 = reference two-lambda bang-bang "
             "(HificConfig.hinge_softness)",
    )
    sp.add_argument(
        "--probe-ema", type=float, default=0.0, metavar="A",
        help="HiFiC only: EMA smoothing of the rate-probe sensor, "
             "0 <= A < 1 (HificConfig.probe_ema)",
    )
    sp.add_argument(
        "--hinge-integral", type=float, default=0.0, metavar="KI",
        help="HiFiC only: integral rate controller — at every probe "
             "refresh lambda *= (ema_rate/target)^KI, clipped to "
             "[lambda_b, lambda_a]; requires --rate-probe-glob "
             "(HificConfig.hinge_integral)",
    )
    sp.add_argument(
        "--k-mse-scale", type=float, default=1.0, metavar="S",
        help="HiFiC only: scale the MSE loss weight by S "
             "(HificConfig.k_mse_scale)",
    )
    sp.add_argument(
        "--init-from", default=None, metavar="MODEL",
        help="warm-start parameters from another trained model of the "
             "same family (fine-tuning, e.g. -msssim from its -mse twin)",
    )
    sp.set_defaults(fn=cmd_train)

    args = p.parse_args(argv)
    if args.cmd in ("compress", "decompress", "eval", "train"):
        args.device = resolve_device(args.device)
        if args.device.type == "cuda":
            strict_fp32()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
