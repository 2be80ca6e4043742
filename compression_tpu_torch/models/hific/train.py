"""HiFiC's training driver (counterpart of
``compression_tpu/models/hific/train.py``): joint G/D steps on
``crop_dataset``'s batches, with the rate controller's probe and
integrator on the host, metrics rows and G-only checkpoints."""

from __future__ import annotations

import glob as globlib
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from compression_tpu_torch.models import common
from compression_tpu_torch.models.hific import archs
from compression_tpu_torch.models.hific.configs import HificConfig
from compression_tpu_torch.models.hific.lpips import make_lpips
from compression_tpu_torch.models.hific.model import HificModel, make_train_steps
from compression_tpu_torch.util import image as image_util
from compression_tpu_torch.util.device import resolve_device, strict_fp32

__all__ = ["train"]


def _probe_batch(pattern: str):
    """The rate probe's images (one shape) padded to a multiple of 64, as
    one float32 batch in [0, 1], and the padded-over-original pixel ratio
    (the probe regulates bits per original pixel)."""
    paths = sorted(globlib.glob(pattern))
    if not paths:
        raise ValueError(f"rate_probe_glob matched no files: {pattern!r}")
    images = [image_util.read_png(p) for p in paths]
    shapes = {im.shape for im in images}
    if len(shapes) != 1:
        raise ValueError(f"rate probe images must share one shape, got {shapes}")
    batch = image_util.pad_to_multiple_np(
        np.stack(images).astype(np.float32) / 255.0, 64)[0]
    scale = batch.shape[1] * batch.shape[2] / (images[0].shape[0] * images[0].shape[1])
    return torch.from_numpy(np.ascontiguousarray(batch)), scale


def train(cfg: HificConfig, train_cfg: common.TrainConfig, params=None, *,
          hooks: Optional[Callable] = None, device="cuda"):
    """Trains HiFiC's G and D jointly; returns ``(model, disc)``.

    Args:
      cfg: the HiFiC configuration.
      train_cfg: batch, patch (a multiple of 64), steps, logging and
        checkpoints (``lr`` and its schedule are not used: G and D take
        ``cfg.lr`` and ``cfg.disc_lr``).
      params: optional G state dict to start from (a warm start: D starts
        fresh).
      hooks: optional ``callable(step, metrics)`` at every logged step.
      device: ``"cuda"`` (default; raises if absent) or ``"cpu"``.

    The G model is seeded with ``train_cfg.seed``, D with the next seed, the
    noise generator on the device with ``train_cfg.seed``. With
    ``cfg.rate_probe_glob`` the coded bpp of those images is measured at
    step 1 and every ``rate_probe_every`` steps (smoothed by
    ``probe_ema``) and the hinge compares it instead of the patch rate;
    with ``hinge_integral > 0`` lambda is the integral controller's,
    starting at the geometric mean of its bounds ``[lambda_b, lambda_a *
    max(k_mse_scale, 1)]``. Checkpoints hold G's params alone.
    """
    # The encoder downsamples 16x and the hyper pair another 4x: a patch
    # that is not a multiple of 64 gives a y grid the hyper-synthesis
    # cannot reproduce.
    if train_cfg.patch_size % 64:
        raise ValueError(
            f"HiFiC patch_size must be a multiple of 64 (16x encoder "
            f"stride x 4x hyper stride); got {train_cfg.patch_size}"
        )
    if cfg.hinge_integral > 0.0 and not cfg.rate_probe_glob:
        raise ValueError(
            "hinge_integral > 0 requires rate_probe_glob: the integrator "
            "consumes the probe's measured full-resolution rate"
        )
    device = resolve_device(device)
    if device.type == "cuda":
        strict_fp32()
    model = HificModel(cfg, seed=train_cfg.seed)
    if params is not None:
        model.load_state_dict(params)
    disc = archs.Discriminator(cfg.num_latents, seed=train_cfg.seed + 1)
    lpips = make_lpips()
    model.to(device).train()
    disc.to(device).train()
    lpips.to(device).eval()

    data = common.crop_dataset(train_cfg)
    # The JAX package draws one batch to trace its init; so does this
    # driver, so that step k trains on the same batch in both packages.
    next(data)
    probe = None
    if cfg.rate_probe_glob:
        probe_batch, probe_scale = _probe_batch(cfg.rate_probe_glob)
        probe_batch = probe_batch.to(device)
        probe = lambda: float(model.coded_bpp(probe_batch)) * probe_scale  # noqa: E731
    step_fn, _, _ = make_train_steps(model, disc, lpips, cfg,
                                     num_devices=train_cfg.num_devices)
    generator = torch.Generator(device).manual_seed(train_cfg.seed)

    lam_lo = cfg.lambda_b
    lam_hi = cfg.lambda_a * max(cfg.k_mse_scale, 1.0)
    lam_state = float(np.sqrt(lam_hi * lam_lo)) if cfg.hinge_integral > 0.0 else -1.0
    probe_val = -1.0
    ckpt_name = train_cfg.checkpoint_name or f"{cfg.name}.msgpack"
    t0 = time.time()
    for step in range(1, train_cfg.steps + 1):
        batch = torch.from_numpy(next(data))
        if device.type == "cuda":
            batch = batch.pin_memory().to(device, non_blocking=True)
        if probe is not None and (step == 1 or step % cfg.rate_probe_every == 0):
            with torch.no_grad():
                new_val = probe()
            if cfg.probe_ema > 0.0 and probe_val >= 0.0:
                probe_val = cfg.probe_ema * probe_val + (1.0 - cfg.probe_ema) * new_val
            else:
                probe_val = new_val
            if cfg.hinge_integral > 0.0:
                ratio = max(probe_val, 1e-6) / cfg.target_rate
                lam_state = float(np.clip(lam_state * ratio ** cfg.hinge_integral,
                                          lam_lo, lam_hi))
        metrics = step_fn(batch, generator, step - 1, probe_bpp=probe_val,
                          lam_override=lam_state)
        if step % train_cfg.log_every == 0 or step == train_cfg.steps:
            m = {k: v.item() for k, v in metrics.items()}
            m["target"] = cfg.target_rate
            if probe is not None:
                m["eval_bpp"] = probe_val
            rate = step * train_cfg.batch_size / (time.time() - t0)
            print(f"step {step}: "
                  + " ".join(f"{k}={v:.4f}" for k, v in sorted(m.items()))
                  + f" ({rate:.1f} img/s)")
            if train_cfg.checkpoint_dir:
                common.write_metrics_row(train_cfg.checkpoint_dir, ckpt_name, step, m, rate)
            if hooks:
                hooks(step, m)
        if train_cfg.checkpoint_dir and (
            step % train_cfg.checkpoint_every == 0 or step == train_cfg.steps
        ):
            common.save_checkpoint(os.path.join(train_cfg.checkpoint_dir, ckpt_name),
                                   model, step)
    return model, disc
