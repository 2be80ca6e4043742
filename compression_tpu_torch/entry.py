"""The port's counterparts of ``__graft_entry__``: ``entry``, bmshj2018's
loss step at full width with example arguments, and ``dryrun_multichip``,
one pass over the multi-device paths.

    fn, (model, x, generator) = entry()
    loss, metrics = fn(model, x, generator)
    dryrun_multichip(4, mesh=Mesh((torch.device("cuda", 0),) * 4))
"""

from __future__ import annotations

import torch

from compression_tpu_torch.models import bmshj2018
from compression_tpu_torch.util.device import resolve_device, strict_fp32

__all__ = ["entry", "dryrun_multichip"]


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


def dryrun_multichip(n_devices: int, device="cuda", *, mesh=None) -> None:
    """One pass over the multi-device paths at the JAX dryrun's sizes
    (tiny widths, 64x64 images), each checked: a data-parallel step of
    bmshj2018 and one of HiFiC's joint G/D step, the image-parallel CHARM
    decode with both coders (byte-equal to the single-device decode), and a
    bmshj2018 SpatialCodec round trip of one ``64 n x 64`` image.

    Args:
      n_devices: the mesh's size: the first ``n_devices`` cards, or
        virtual CPU shards with ``device="cpu"``
        (:func:`~compression_tpu_torch.parallel.data_parallel.make_mesh`).
      mesh: an explicit mesh instead (it may repeat a device).
    """
    import numpy as np

    from compression_tpu_torch.models import hific, ms2020
    from compression_tpu_torch.models.hific import archs
    from compression_tpu_torch.models.hific.lpips import LPIPS
    from compression_tpu_torch.parallel import ShardedCharmCodec
    from compression_tpu_torch.parallel.data_parallel import (
        make_dp_step,
        make_mesh,
        shard_batch,
        shard_generators,
    )

    if mesh is None:
        mesh = make_mesh(n_devices, device=device)
    n = mesh.size
    main = mesh.devices[0]
    if main.type == "cuda":
        strict_fp32()
    cfg = bmshj2018.Config(num_filters=8, num_latents=8, num_hyperlatents=4)
    model = bmshj2018.BMSHJ2018Model(cfg).to(main)
    opt = torch.optim.Adam(model.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8)
    step = make_dp_step(lambda m, x, g: bmshj2018.make_loss_fn(m)(x, g), opt, mesh=mesh)
    batch = torch.zeros((n, 64, 64, 3))
    metrics = step(model, shard_batch(batch, mesh), shard_generators(2, mesh))
    print(f"dryrun_multichip({n}): one DP step OK, loss={float(metrics['loss']):.4f}")

    hcfg = hific.HificConfig(name="hific-dryrun", target_rate=0.3, num_latents=8,
                             num_hyperlatents=4, num_residual_blocks=1)
    hmodel = hific.HificModel(hcfg).to(main)
    disc = archs.Discriminator(hcfg.num_latents, seed=1).to(main)
    lpips = LPIPS().requires_grad_(False).to(main)
    gan_step, _, _ = hific.make_train_steps(hmodel, disc, lpips, hcfg, mesh=mesh)
    hmetrics = gan_step(shard_batch(batch, mesh), shard_generators(5, mesh))
    print(f"dryrun_multichip({n}): one HiFiC DP G/D step OK, "
          f"g_loss={float(hmetrics['g_loss']):.4f} d_loss={float(hmetrics['d_loss']):.4f}")

    mmodel = ms2020.MS2020Model(ms2020.Config(num_filters=8, num_latents=8,
                                              num_hyperlatents=4, num_slices=4))
    images = (np.random.RandomState(0).rand(n, 64, 64, 3) * 255).astype(np.uint8)
    mcodec = ms2020.make_codec(mmodel, main)
    sharded = ShardedCharmCodec(mmodel, mesh)
    for coder in ("host", "device"):
        blobs = mcodec.compress_batch(images, coder=coder)
        if not np.array_equal(sharded.decompress_batch(blobs),
                              mcodec.decompress_batch(blobs)):
            raise AssertionError(
                f"sharded CHARM decode ({coder} coder) diverged from the single-device one")
        print(f"dryrun_multichip({n}): CHARM image-parallel decode OK, {coder} coder "
              f"({len(blobs)} images byte-exact across the mesh)")

    sc = bmshj2018.SpatialCodec(model, mesh)
    big = (np.random.RandomState(1).rand(n * 64, 64, 3) * 255).astype(np.uint8)
    blob = sc.compress(big)
    if sc.decompress(blob).shape != big.shape:
        raise AssertionError("spatial codec round-trip shape mismatch")
    print(f"dryrun_multichip({n}): giant-image spatial codec OK ({big.shape[0]}x"
          f"{big.shape[1]} image H-sharded, {len(blob)} byte stream)")
