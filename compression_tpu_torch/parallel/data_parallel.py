"""Data-parallel training over a mesh of devices (counterpart of
``compression_tpu/parallel/data_parallel.py``).

The JAX package is single-controller: one process holds a ``Mesh`` of
devices, a step takes the whole batch sharded along its leading dim, and
the per-device gradients meet in a ``pmean``. The port keeps that model in
one process:

* a :class:`Mesh` is an ordered tuple of ``torch.device``\\ s and an axis
  name. A device may repeat: several shards then run on one card, one after
  another (the card tests and ``chip_smoke.py`` run 4 shards on one H100);
* :class:`Replicas` holds a module's parameters and buffers on each device
  of the mesh: the module's own on the device it lives on, copies on the
  others; a function runs on a device's copies through
  ``torch.func.functional_call``, so a loss that closes over the module
  runs on any replica;
* the collectives are tensor copies between shards: a gradient mean sums
  the shards' gradients onto the module's device and divides by the shard
  count (``pmean``), and the updated parameters are copied back to the
  other devices. Shards that share a device share its tensors: nothing is
  copied for them.

No ``torch.distributed`` and no launcher: the JAX package has no
multi-host path either. Copies between distinct cards are written but not
run anywhere yet (the card machine has one H100).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from compression_tpu_torch.util.device import resolve_device

__all__ = ["Mesh", "Replicas", "make_mesh", "shard_batch", "shard_generators",
           "reduce_mean", "mean_metrics", "make_dp_step"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``devices[i]`` holds shard ``i`` of ``axis``.

    Build it with :func:`make_mesh`, or from an explicit device list, which
    may repeat a device (``Mesh((dev,) * 4)``: four shards on one card).
    """

    devices: tuple
    axis: str = "data"

    def __post_init__(self):
        # "cuda" names the current card, as a tensor's device does.
        devices = tuple(torch.device("cuda", torch.cuda.current_device())
                        if torch.device(d) == torch.device("cuda") else torch.device(d)
                        for d in self.devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devices)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(num_devices: Optional[int] = None, axis: str = "data",
              device="cuda") -> Mesh:
    """The first ``num_devices`` devices of a kind as a mesh (all of them
    with ``None``).

    ``device="cuda"``: the visible cards, ``cuda:0`` first; raises when
    fewer than ``num_devices`` are visible (the mesh is never cut to what
    there is). ``device="cpu"``, which the caller must ask for:
    ``num_devices`` virtual shards of the CPU (at most one a core), the
    counterpart of the JAX tests' virtual host devices.
    """
    kind = resolve_device(device).type
    count = torch.cuda.device_count() if kind == "cuda" else os.cpu_count()
    n = count if num_devices is None else int(num_devices)
    if not 1 <= n <= count:
        raise ValueError(f"a mesh of {n} {kind} device(s): this process sees {count}")
    if kind == "cuda":
        return Mesh(tuple(torch.device("cuda", i) for i in range(n)), axis)
    return Mesh((torch.device("cpu"),) * n, axis)


def shard_batch(batch, mesh: Mesh) -> List[torch.Tensor]:
    """Splits a batch on its leading dim into one tensor per mesh position,
    each on its device (through pinned memory, without waiting, for a host
    batch going to a card). The leading dim must divide the mesh size."""
    batch = torch.as_tensor(batch)
    n = mesh.size
    if batch.shape[0] % n:
        raise ValueError(
            f"batch of {batch.shape[0]} does not divide over {n} devices")
    out = []
    for part, dev in zip(torch.chunk(batch, n), mesh.devices):
        if dev.type == "cuda" and part.device.type == "cpu":
            part = part.pin_memory().to(dev, non_blocking=True)
        out.append(part.to(dev))
    return out


def fold_in(seed: int, index: int) -> int:
    """A 63-bit seed from ``(seed, index)`` alone (``jax.random.fold_in``'s
    role: shards draw independent, reproducible noise)."""
    state = np.random.SeedSequence([int(seed) & (2**63 - 1), int(index)])
    return int(state.generate_state(1, np.uint64)[0]) & (2**63 - 1)


def shard_generators(seed: int, mesh: Mesh) -> List[torch.Generator]:
    """One noise generator per mesh position, on its device, seeded from
    ``(seed, position)`` alone."""
    return [torch.Generator(dev).manual_seed(fold_in(seed, d))
            for d, dev in enumerate(mesh.devices)]


class _Bound(nn.Module):
    """``fn`` as the forward of a module that holds ``module``, so that
    ``functional_call`` swaps ``module``'s tensors while ``fn`` runs."""

    def __init__(self, module: nn.Module, fn: Callable):
        super().__init__()
        self.m = module
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def device_of(module: nn.Module) -> torch.device:
    for t in module.parameters():
        return t.device
    for t in module.buffers():
        return t.device
    raise ValueError("the module holds no tensors")


class Replicas:
    """``module``'s parameters and buffers on every device in ``devices``:
    its own on the device it lives on, a copy on each other device.

    Args:
      module: the primary replica; an optimizer steps its parameters.
      devices: the mesh's devices (repeats are one replica).
    """

    def __init__(self, module: nn.Module, devices: Sequence[torch.device]):
        self.module = module
        self.device = device_of(module)
        self.names = [name for name, _ in module.named_parameters()]
        self._copies: Dict[torch.device, dict] = {}
        for dev in dict.fromkeys(torch.device(d) for d in devices):
            if dev != self.device:
                self._copies[dev] = {
                    name: t.detach().to(dev, copy=True).requires_grad_(t.requires_grad)
                    for name, t in self._own().items()}
        self._bound_names = {dev: {f"m.{k}": v for k, v in c.items()}
                             for dev, c in self._copies.items()}

    def _own(self) -> dict:
        return {**dict(self.module.named_parameters()), **dict(self.module.named_buffers())}

    def devices(self) -> List[torch.device]:
        return [self.device, *self._copies]

    def call(self, device, fn: Callable, *args):
        """``fn(*args)`` with the module's tensors on ``device``: a direct
        call on the module's own device, else under ``functional_call``
        with that device's copies (``fn`` may close over the module)."""
        device = torch.device(device)
        if device == self.device:
            return fn(*args)
        return torch.func.functional_call(_Bound(self.module, fn),
                                          self._bound_names[device], args)

    def parameters(self, device) -> List[torch.Tensor]:
        """The parameters on ``device``, in ``named_parameters`` order."""
        device = torch.device(device)
        if device == self.device:
            return list(self.module.parameters())
        copies = self._copies[device]
        return [copies[name] for name in self.names]

    def map(self, fn: Callable, *shards: Sequence[torch.Tensor]) -> list:
        """``fn`` on each mesh position's shards (one of each list), on its device's tensors."""
        return [self.call(parts[0].device, fn, *parts) for parts in zip(*shards)]

    def load(self, device, tensors: dict) -> None:
        """Copies ``{name: tensor}`` into the tensors on ``device``."""
        device = torch.device(device)
        target = self._own() if device == self.device else self._copies[device]
        with torch.no_grad():
            for name, t in tensors.items():
                target[name].copy_(t)

    def broadcast(self) -> None:
        """Copies the module's parameters and buffers to the other devices
        (the replicated update's result)."""
        own = self._own()
        for dev in self._copies:
            self.load(dev, own)


def reduce_mean(sums: Dict[torch.device, list], device, count: int) -> list:
    """``pmean``: each tensor's parts from every device (``None`` where a
    device has none) added on ``device`` and divided by ``count``; ``None``
    where no device has one."""
    out = []
    for parts in zip(*sums.values()):
        parts = [g for g in parts if g is not None]
        if not parts:
            out.append(None)
            continue
        total = parts[0].to(device)
        for g in parts[1:]:
            total = total + g.to(device)
        out.append(total / count)
    return out


def _accumulate(sums: dict, device, grads) -> None:
    acc = sums.get(device)
    if acc is None:
        sums[device] = list(grads)
        return
    for i, g in enumerate(grads):
        if g is not None:
            acc[i] = g if acc[i] is None else acc[i] + g


def _mean_on(values: List[torch.Tensor], device) -> torch.Tensor:
    return torch.mean(torch.stack([v.detach().to(device) for v in values]), 0)


def mean_metrics(per_shard: List[dict], device) -> dict:
    """``pmean`` of per-shard metric dicts, on ``device``."""
    return {k: _mean_on([m[k] for m in per_shard], device) for k in per_shard[0]}


def make_dp_step(loss_fn: Callable, optimizer: torch.optim.Optimizer,
                 num_devices: Optional[int] = None, axis: str = "data", *,
                 mesh: Optional[Mesh] = None):
    """Builds a data-parallel train step.

    Args:
      loss_fn: ``(model, batch, generator) -> (loss, metrics)`` on one
        shard (batch float32 in [0, 1]; a uint8 shard is divided by 255 on
        its device first).
      optimizer: over the model's parameters (the port's optax-matching
        Adam, ``models.common.make_optimizer``, or any ``torch.optim``
        optimizer); it runs once a step, on the mean gradients.
      num_devices: the mesh's size on the cards (:func:`make_mesh`), unless
        ``mesh`` is given.
      mesh: the devices of the shards; the model lives on ``devices[0]``.

    Returns ``step(model, batch, generators) -> {"loss", **metrics}``:
    ``batch`` is the whole batch or :func:`shard_batch`'s shards,
    ``generators`` one per shard (:func:`shard_generators`). Shard d's loss
    and gradients are taken on its device with ``generators[d]``; the
    gradients, losses and metrics are averaged over the shards (``pmean``),
    the optimizer steps once, and the replicas on other devices get the new
    parameters (``step.replicas``).
    """
    if mesh is None:
        mesh = make_mesh(num_devices, axis)
    n = mesh.size

    def step(model, batch, generators):
        replicas = step.replicas
        if replicas is None or replicas.module is not model:
            replicas = step.replicas = Replicas(model, mesh.devices)
        if replicas.device != mesh.devices[0]:
            raise ValueError(f"the model is on {replicas.device}; the mesh's "
                             f"first device is {mesh.devices[0]}")
        shards = batch if isinstance(batch, (list, tuple)) else shard_batch(batch, mesh)
        if len(shards) != n or len(generators) != n:
            raise ValueError(f"{len(shards)} shards and {len(generators)} generators "
                             f"for a mesh of {n}")
        sums: dict = {}
        losses, metrics = [], []
        for dev, x, gen in zip(mesh.devices, shards, generators):
            if x.dtype == torch.uint8:
                x = x.to(torch.float32) / 255.0
            loss, m = replicas.call(dev, loss_fn, model, x, gen)
            grads = torch.autograd.grad(loss, replicas.parameters(dev), allow_unused=True)
            _accumulate(sums, dev, grads)
            losses.append(loss)
            metrics.append(m)
        for p, g in zip(model.parameters(), reduce_mean(sums, replicas.device, n)):
            p.grad = g
        optimizer.step()
        replicas.broadcast()
        return {"loss": _mean_on(losses, replicas.device),
                **mean_metrics(metrics, replicas.device)}

    step.replicas = None
    return step
