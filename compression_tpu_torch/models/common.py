"""Training machinery shared by the models (counterpart of
``compression_tpu/models/common.py``): the distortion term, the crop
dataset, the metrics CSV, checkpoints and the train loop.

* :func:`crop_dataset` draws the same batches as the JAX package's for the
  same seed (the same NumPy ``RandomState`` calls in the same order);
  image-backed batches are uint8 and normalised on the device.
* Checkpoints are flax msgpack files in the JAX package's layout,
  ``{"params": {"params": tree}, "step": n, "opt_state": ...}`` with the
  Adam state where ``optax.adam`` keeps it, so either package resumes the
  other's checkpoints (:mod:`compression_tpu_torch.convert` reads and
  writes them).
* :func:`train_model` runs Adam (``torch.optim.Adam``: optax's update,
  ``eps`` outside the square root) with optax's learning-rate schedules,
  on the card unless the caller passes ``device="cpu"``; with
  ``num_devices > 1`` each step is data-parallel over a mesh of that many
  devices (:func:`compression_tpu_torch.parallel.make_dp_step`) and writes
  the same checkpoints. As in the JAX package, a resumed run restarts its
  noise generators and its data stream from ``cfg.seed``.
"""

from __future__ import annotations

import dataclasses
import glob as globlib
import math
import os
import time
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from compression_tpu_torch import convert
from compression_tpu_torch.ops.math_ops import clip
from compression_tpu_torch.util import image as image_util
from compression_tpu_torch.util.device import resolve_device, strict_fp32

__all__ = [
    "TrainConfig",
    "distortion_loss",
    "crop_dataset",
    "write_metrics_row",
    "lr_schedule",
    "make_optimizer",
    "save_checkpoint",
    "load_checkpoint",
    "restore_checkpoint",
    "train_step",
    "train_model",
]


def distortion_loss(x: torch.Tensor, x_hat: torch.Tensor, kind: str = "mse"):
    """Distortion term of the R-D losses. Returns ``(loss_term, metric_name,
    metric_value)``:

      mse:    255^2-scaled mean squared error (metric = the same).
      msssim: ``1 - MS-SSIM`` on the [0, 1] images (single-scale SSIM when
              the patch is below MS-SSIM's 176 px minimum); the metric is
              the similarity itself.
    """
    if kind == "mse":
        mse = torch.mean(torch.square(x - x_hat)) * (255.0**2)
        return mse, "mse", mse
    if kind == "msssim":
        fn = (image_util.msssim if min(x.shape[1], x.shape[2]) >= 176
              else image_util.ssim)
        sim = torch.mean(fn(x, clip(x_hat, 0.0, 1.0), max_val=1.0))
        return 1.0 - sim, "msssim", sim
    raise ValueError(f"unknown distortion {kind!r} (mse | msssim)")


@dataclasses.dataclass
class TrainConfig:
    train_glob: Optional[str] = None   # image file glob; None = synthetic
    batch_size: int = 8
    patch_size: int = 256
    learning_rate: float = 1e-4
    # Learning-rate schedule over [0, steps]: "constant" | "step" | "cosine".
    # "step" drops the lr by lr_final_scale at lr_drop_frac * steps;
    # "cosine" decays smoothly to learning_rate * lr_final_scale.
    lr_schedule: str = "constant"
    lr_final_scale: float = 0.1
    lr_drop_frac: float = 0.85
    steps: int = 1_000_000
    log_every: int = 100
    checkpoint_every: int = 5000
    checkpoint_dir: Optional[str] = None
    checkpoint_name: str = "checkpoint.msgpack"  # per-model to avoid clashes
    seed: int = 0
    num_devices: int = 1               # data-parallel width
    # Optional per-parameter-group lr multipliers: ((path_prefix, scale),
    # ...) matched against the JAX package's "params/..." key paths (the
    # last matching prefix wins).
    lr_scales: Optional[tuple] = None
    # Dihedral augmentation of each crop (flips + transpose). Square
    # patches only.
    augment: bool = True


def write_metrics_row(
    checkpoint_dir: str, checkpoint_name: str, step: int, m: dict, rate: float
) -> None:
    """Appends one row to the metrics CSV next to the checkpoints. If the
    metric set changed since the file was started, the old file is rotated
    to ``.prev`` rather than appending misaligned rows."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    csv_path = os.path.join(checkpoint_dir, checkpoint_name + ".metrics.csv")
    keys = sorted(m)
    header = "step," + ",".join(keys) + ",img_per_s\n"
    new_file = not os.path.exists(csv_path)
    if not new_file:
        with open(csv_path) as f:
            old_header = f.readline()
        if old_header != header:
            os.replace(csv_path, csv_path + ".prev")
            new_file = True
    with open(csv_path, "a") as f:
        if new_file:
            f.write(header)
        f.write(
            f"{step},"
            + ",".join(f"{m[k]:.6g}" for k in keys)
            + f",{rate:.2f}\n"
        )


def _load_images(pattern: str, max_images: int = 2000):
    paths = sorted(globlib.glob(pattern))[:max_images]
    if not paths:
        raise FileNotFoundError(f"no images match {pattern!r}")
    return [image_util.read_png(p) for p in paths]


def crop_dataset(cfg: TrainConfig) -> Iterator[np.ndarray]:
    """Yields training batches of shape (B, P, P, 3), forever: uint8 crops
    of the images matching ``cfg.train_glob``, or, with no glob, float32
    smooth random fields in [0, 1] (the synthetic fallback)."""
    rng = np.random.RandomState(cfg.seed)
    p = cfg.patch_size
    images = None
    if cfg.train_glob:
        images = [
            im for im in _load_images(cfg.train_glob)
            if im.shape[0] >= p and im.shape[1] >= p
        ]
        if not images:
            raise ValueError(f"no images >= {p}x{p} in {cfg.train_glob!r}")
    while True:
        if images is None:
            batch = np.empty((cfg.batch_size, p, p, 3), np.float32)
            for b in range(cfg.batch_size):
                base = rng.randn(p // 8, p // 8, 3).astype(np.float32)
                up = np.kron(base, np.ones((8, 8, 1), np.float32))
                batch[b] = 1 / (1 + np.exp(-up))
            yield batch
            continue
        batch = np.empty((cfg.batch_size, p, p, 3), np.uint8)
        for b in range(cfg.batch_size):
            im = images[rng.randint(len(images))]
            y = rng.randint(im.shape[0] - p + 1)
            x = rng.randint(im.shape[1] - p + 1)
            crop = im[y : y + p, x : x + p]
            if cfg.augment:
                if rng.rand() < 0.5:
                    crop = crop[::-1]
                if rng.rand() < 0.5:
                    crop = crop[:, ::-1]
                if crop.shape[0] == crop.shape[1] and rng.rand() < 0.5:
                    crop = crop.transpose(1, 0, 2)
            batch[b] = crop
        yield batch


# -- learning rate and optimizer ----------------------------------------------


def lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """The learning rate after ``count`` updates, as optax's constant,
    ``piecewise_constant_schedule`` (scaled from ``count >= boundary``) and
    ``cosine_decay_schedule`` compute it."""
    if cfg.lr_schedule == "constant":
        return lambda count: cfg.learning_rate
    if cfg.lr_schedule == "step":
        boundary = int(cfg.steps * cfg.lr_drop_frac)
        return lambda count: cfg.learning_rate * (
            cfg.lr_final_scale if count >= boundary else 1.0)
    if cfg.lr_schedule == "cosine":
        def cosine(count):
            t = min(float(count), float(cfg.steps))
            decay = 0.5 * (1.0 + math.cos(math.pi * t / cfg.steps))
            return cfg.learning_rate * (
                (1.0 - cfg.lr_final_scale) * decay + cfg.lr_final_scale)
        return cosine
    raise ValueError(
        f"unknown lr_schedule {cfg.lr_schedule!r} (constant|step|cosine)"
    )


def _lr_scale(name: str, scales) -> float:
    key, s = convert.flax_key_path(name), 1.0
    for prefix, sc in scales or ():
        if key.startswith(prefix):
            s = sc
    return s


def make_optimizer(model: torch.nn.Module, cfg: TrainConfig) -> torch.optim.Adam:
    """Adam over the model's parameters, one group for each ``lr_scales``
    multiplier (``group["scale"]``; one group without ``lr_scales``)."""
    groups: Dict[float, list] = {}
    for name, p in model.named_parameters():
        groups.setdefault(_lr_scale(name, cfg.lr_scales), []).append(p)
    return torch.optim.Adam(
        [{"params": ps, "scale": sc} for sc, ps in groups.items()],
        lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8)


def _set_lr(optimizer: torch.optim.Adam, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr * group["scale"]


def _updates_done(optimizer: torch.optim.Adam) -> int:
    """Adam's update count (optax's ``count``), 0 before the first step."""
    for state in optimizer.state.values():
        return int(state["step"])
    return 0


# -- checkpoints --------------------------------------------------------------


def _opt_state_tree(cfg: TrainConfig, count: int, mu: dict, nu: dict) -> dict:
    """The optax state of the JAX package's optimizer for ``cfg``, as flax
    serializes it: ``adam(lr)`` is ``(ScaleByAdamState, EmptyState)``, a
    schedule keeps its own count in the second entry, and ``lr_scales``
    chains one more (stateless) transform around it."""
    adam = {"count": np.array(count, np.int32), "mu": {"params": mu},
            "nu": {"params": nu}}
    schedule_state = {} if cfg.lr_schedule == "constant" else {
        "count": np.array(count, np.int32)}
    state = {"0": adam, "1": schedule_state}
    if cfg.lr_scales:
        state = {"0": state, "1": {}}
    return state


def _find_adam(tree) -> Optional[dict]:
    """The ``{"count", "mu", "nu"}`` node of a serialized optax state."""
    if not isinstance(tree, dict):
        return None
    if {"count", "mu", "nu"} <= set(tree):
        return tree
    for value in tree.values():
        found = _find_adam(value)
        if found is not None:
            return found
    return None


def save_checkpoint(path: str, model: torch.nn.Module, step: int,
                    optimizer: Optional[torch.optim.Adam] = None,
                    cfg: Optional[TrainConfig] = None) -> None:
    """Writes params (and, with ``optimizer``, the Adam state in the layout
    the JAX package's optimizer for ``cfg`` has) as a flax msgpack file.
    Written whole to a temporary file and renamed, so a crash never leaves
    a partial file under ``path``."""
    state = {"params": {"params": convert.params_to_numpy(model.state_dict())},
             "step": int(step)}
    if optimizer is not None:
        names = dict(model.named_parameters())
        mu, nu = {}, {}
        for name, p in names.items():
            st = optimizer.state.get(p)
            mu[name] = st["exp_avg"] if st else torch.zeros_like(p)
            nu[name] = st["exp_avg_sq"] if st else torch.zeros_like(p)
        state["opt_state"] = _opt_state_tree(
            cfg or TrainConfig(), _updates_done(optimizer),
            convert.params_to_numpy(mu), convert.params_to_numpy(nu))
    blob = convert.pack_msgpack(state)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)


def load_checkpoint(path: str):
    """Reads a checkpoint of either package. Returns ``(params, step,
    adam)``: the state dict, the step, and ``{"count", "mu", "nu"}`` (mu
    and nu as state dicts) or None for a params-only file."""
    tree = convert.load_flax_msgpack(path)
    params = convert.params_from_numpy(tree["params"])
    adam = _find_adam(tree.get("opt_state"))
    if adam is not None:
        adam = {"count": int(adam["count"]),
                "mu": convert.params_from_numpy(adam["mu"]),
                "nu": convert.params_from_numpy(adam["nu"])}
    return params, int(tree["step"]), adam


def restore_checkpoint(path: str, model: torch.nn.Module,
                       optimizer: torch.optim.Adam) -> Tuple[int, bool]:
    """Loads a checkpoint into ``model`` and, where it has them, Adam's
    moments and count into ``optimizer``. Returns ``(step, with_moments)``;
    a params-only file leaves the optimizer fresh."""
    params, step, adam = load_checkpoint(path)
    model.load_state_dict(params)
    if adam is None:
        return step, False
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(float(adam["count"])),
            "exp_avg": adam["mu"][name].to(p.device),
            "exp_avg_sq": adam["nu"][name].to(p.device),
        }
    return step, True


# -- train loop ---------------------------------------------------------------


def train_step(model: torch.nn.Module, optimizer: torch.optim.Adam,
               loss_fn: Callable, batch: torch.Tensor,
               generator: Optional[torch.Generator],
               schedule: Callable[[int], float]):
    """One update: the loss on ``batch`` (float32, or uint8 normalised here,
    on the device), its gradients, and Adam at ``schedule(updates done)``.
    Returns ``(loss, metrics)`` as device tensors (no host sync)."""
    if batch.dtype == torch.uint8:
        batch = batch.to(torch.float32) / 255.0
    loss, metrics = loss_fn(batch, generator)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    _set_lr(optimizer, schedule(_updates_done(optimizer)))
    optimizer.step()
    return loss, metrics


def train_model(
    model: torch.nn.Module,
    loss_fn: Callable,
    cfg: TrainConfig,
    *,
    hooks: Optional[Callable] = None,
    device="cuda",
) -> torch.nn.Module:
    """Generic training loop.

    Args:
      model: the module to train (moved to ``device``).
      loss_fn: ``(batch, generator) -> (loss, metrics dict)``, on
        ``model``; batch is float32 NHWC in [0, 1] on the device.
      cfg: TrainConfig; ``num_devices > 1`` shards each batch over
        ``make_mesh(num_devices, device=device)`` (the batch size must
        divide), with shard d's noise from ``(cfg.seed, d)``.
      hooks: optional ``callable(step, metrics)`` at every logged step.
      device: ``"cuda"`` (default; raises if absent) or ``"cpu"``.

    Returns the trained model.
    """
    if cfg.num_devices > 1 and cfg.batch_size % cfg.num_devices:
        raise ValueError(
            f"batch_size ({cfg.batch_size}) must be divisible by "
            f"num_devices ({cfg.num_devices}) for data parallelism"
        )
    device = resolve_device(device)
    if device.type == "cuda":
        strict_fp32()
    model.to(device).train()
    data = crop_dataset(cfg)
    # The JAX package draws one batch to trace its init; so does this loop,
    # so that step k trains on the same batch in both packages.
    next(data)
    generator = torch.Generator(device).manual_seed(cfg.seed)
    schedule = lr_schedule(cfg)
    optimizer = make_optimizer(model, cfg)
    start_step = 0
    if cfg.checkpoint_dir:
        resume_path = os.path.join(cfg.checkpoint_dir, cfg.checkpoint_name)
        if os.path.exists(resume_path):
            start_step, with_moments = restore_checkpoint(
                resume_path, model, optimizer)
            print(f"resumed {'' if with_moments else '(params only) '}"
                  f"from {resume_path} @ step {start_step}")

    dp_step = None
    if cfg.num_devices > 1:
        from compression_tpu_torch.parallel.data_parallel import (
            make_dp_step,
            make_mesh,
            shard_generators,
        )

        mesh = make_mesh(cfg.num_devices, device=device)
        # loss_fn closes over model: the step runs it on each replica.
        dp_step = make_dp_step(lambda _model, x, gen: loss_fn(x, gen), optimizer,
                               mesh=mesh)
        generators = shard_generators(cfg.seed, mesh)

    t0 = time.time()
    for step in range(start_step + 1, cfg.steps + 1):
        batch = torch.from_numpy(next(data))
        if dp_step is not None:
            _set_lr(optimizer, schedule(_updates_done(optimizer)))
            metrics = dp_step(model, batch, generators)
            loss = metrics.pop("loss")
        else:
            if device.type == "cuda":
                batch = batch.pin_memory().to(device, non_blocking=True)
            loss, metrics = train_step(model, optimizer, loss_fn, batch, generator,
                                       schedule)
        if step % cfg.log_every == 0 or step == cfg.steps:
            m = {k: v.item() for k, v in {"loss": loss, **metrics}.items()}
            rate = (step - start_step) * cfg.batch_size / (time.time() - t0)
            line = " ".join(f"{k}={v:.4f}" for k, v in sorted(m.items()))
            print(f"step {step}: {line} ({rate:.1f} img/s)")
            if cfg.checkpoint_dir:
                write_metrics_row(
                    cfg.checkpoint_dir, cfg.checkpoint_name, step, m, rate
                )
            if hooks:
                hooks(step, m)
        if cfg.checkpoint_dir and (
            step % cfg.checkpoint_every == 0 or step == cfg.steps
        ):
            save_checkpoint(
                os.path.join(cfg.checkpoint_dir, cfg.checkpoint_name),
                model, step, optimizer, cfg,
            )
    return model
