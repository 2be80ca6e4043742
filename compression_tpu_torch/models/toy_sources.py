"""Toy sources: nonlinear transform coding of low-dimensional sources
(counterpart of ``compression_tpu/models/toy_sources.py``).

Small MLP analysis/synthesis transforms compress samples of synthetic 2-D
sources (banana, Gaussian, Laplacian) with the same entropy-model machinery
the image codecs use, beside the classic baseline, entropy-constrained
vector quantization (ECVQ). Sources draw from a ``torch.Generator`` on the
generator's device; the entry points run on ``device="cuda"`` unless the
caller asks for the CPU.

The parameters map onto the JAX package's flax tree through
:mod:`compression_tpu_torch.convert` (``analysis.dense0`` is flax's
``analysis/dense0``, a ``Dense`` kernel ``(in, out)`` transposed).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from compression_tpu_torch.entropy_models import ContinuousBatchedEntropyModel
from compression_tpu_torch.layers.priors import DeepFactorizedPrior
from compression_tpu_torch.layers.signal_conv import truncated_normal_init
from compression_tpu_torch.util.device import resolve_device

__all__ = [
    "banana", "gaussian", "laplacian",
    "MLP", "NTCModel", "Config", "train", "compress_samples",
    "ECVQ", "train_ecvq", "rd_point_ntc", "rd_point_ecvq", "compare_ntc_vq",
]


def banana(generator: torch.Generator, n: int) -> torch.Tensor:
    """The 2-D 'banana' source: a curved Gaussian ridge."""
    dev = generator.device
    x = torch.randn(n, generator=generator, device=dev)
    y = torch.randn(n, generator=generator, device=dev) * 0.5 + 0.25 * x ** 2 - 2.0
    return torch.stack([x, y], -1)


def gaussian(generator: torch.Generator, n: int, dim: int = 2) -> torch.Tensor:
    return torch.randn(n, dim, generator=generator, device=generator.device)


def laplacian(generator: torch.Generator, n: int, dim: int = 2) -> torch.Tensor:
    """Standard Laplace samples, by the inverse CDF of U(-1/2, 1/2)."""
    u = torch.rand(n, dim, generator=generator, device=generator.device) - 0.5
    return -torch.sign(u) * torch.log1p(-2.0 * torch.abs(u))


@dataclasses.dataclass(frozen=True)
class Config:
    lmbda: float = 1.0
    dim: int = 2
    latent_dim: int = 2
    hidden: int = 64
    layers: int = 3


class MLP(nn.Module):
    """Dense layers with softplus between them: ``dense0 .. dense{k-1}``
    and ``out`` (flax ``nn.Dense``'s names); weights drawn as flax's
    ``lecun_normal`` (a normal cut at +-2, variance ``1 / in``) from
    ``generator``, biases zero."""

    def __init__(self, in_dim: int, widths: Tuple[int, ...],
                 generator: torch.Generator):
        super().__init__()
        dims = (in_dim,) + tuple(widths)
        names = [f"dense{i}" for i in range(len(widths) - 1)] + ["out"]
        self.names = names
        for name, (a, b) in zip(names, zip(dims[:-1], dims[1:])):
            layer = nn.Linear(a, b)
            truncated_normal_init(layer.weight, generator, "fan_in")
            with torch.no_grad():
                layer.bias.zero_()
            self.add_module(name, layer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self.names[:-1]:
            x = F.softplus(getattr(self, name)(x))
        return getattr(self, self.names[-1])(x)


class NTCModel(nn.Module):
    """Nonlinear transform code for vector sources."""

    def __init__(self, config: Config = Config(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        cfg = self.config = config
        widths = (cfg.hidden,) * cfg.layers
        self.analysis = MLP(cfg.dim, widths + (cfg.latent_dim,), generator)
        self.synthesis = MLP(cfg.latent_dim, widths + (cfg.dim,), generator)
        self.prior = DeepFactorizedPrior((cfg.latent_dim,), generator=generator)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator],
                training: bool = True):
        """``(x_hat, bits)`` of samples ``x``: training adds U(-1/2, 1/2)
        noise from ``generator``, else the latents are rounded."""
        y = self.analysis(x)
        em = ContinuousBatchedEntropyModel(self.prior(), coding_rank=1)
        y_tilde, bits = em(y, generator, training=training)
        return self.synthesis(y_tilde), bits


def _loss(model: NTCModel, x: torch.Tensor, generator, training: bool = True):
    x_hat, bits = model(x, generator, training=training)
    rate = torch.mean(bits)
    dist = torch.mean(torch.sum((x - x_hat) ** 2, -1))
    return rate + model.config.lmbda * dist, rate, dist


def train(cfg: Config, source: Callable = banana, steps: int = 2000,
          batch_size: int = 512, lr: float = 1e-3, seed: int = 0,
          device="cuda"):
    """Trains an NTC model on a toy source with Adam (optax's ``adam(lr)``
    update); returns ``(model, history)``, the history holding ``(step,
    rate, distortion)`` ten times over the run. The weights are drawn from
    a CPU generator seeded ``seed``, the samples and the noise from one on
    ``device`` seeded ``seed``."""
    dev = resolve_device(device)
    model = NTCModel(cfg, torch.Generator().manual_seed(seed)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    optimizer = torch.optim.Adam(model.parameters(), lr=lr)
    history = []
    for i in range(steps):
        x = source(gen, batch_size)
        loss, rate, dist = _loss(model, x, gen)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        if (i + 1) % max(1, steps // 10) == 0:
            history.append((i + 1, float(rate.detach()), float(dist.detach())))
    return model, history


def _code(model: NTCModel, x: torch.Tensor, coding_rank: int):
    """Range-codes the latents of ``x`` (batch dims first, then ``(n,
    latent_dim)``) and decodes them; returns ``(x_hat, strings)``."""
    em = ContinuousBatchedEntropyModel(model.prior(), coding_rank=coding_rank,
                                       compression=True)
    with torch.no_grad():
        y = model.analysis(x)
        strings = em.compress(y)
        y_hat = em.decompress(strings, tuple(y.shape[1:-1]))
        x_hat = model.synthesis(torch.from_numpy(y_hat).to(x.device))
    return x_hat, strings


def compress_samples(model: NTCModel, x: torch.Tensor):
    """Round-trips samples through the real codec, one stream a sample;
    returns ``(x_hat, strings)``."""
    return _code(model, x, coding_rank=1)


@dataclasses.dataclass(frozen=True)
class ECVQ:
    """Entropy-constrained VQ: ``(K, dim)`` centers and code lengths."""

    codebook: torch.Tensor   # (K, dim)
    log2_p: torch.Tensor     # (K,) code lengths in bits (normalized)
    lmbda: float

    def assign(self, x: torch.Tensor) -> torch.Tensor:
        """Rate-augmented nearest codeword per sample (the first on a tie)."""
        d2 = torch.sum((x[:, None, :] - self.codebook[None, :, :]) ** 2, dim=-1)
        cost = -self.log2_p[None, :] + self.lmbda * d2
        return torch.argmin(cost, dim=-1)

    def rate_distortion(self, x: torch.Tensor):
        """Mean (bits a sample, squared error a sample) under hard
        assignment, as 0-d tensors."""
        idx = self.assign(x)
        rate = torch.mean(-self.log2_p[idx])
        dist = torch.mean(torch.sum((x - self.codebook[idx]) ** 2, dim=-1))
        return rate, dist


def ecvq_update(q: ECVQ, x: torch.Tensor, prob_floor: float = 1e-8):
    """One Lloyd step: the assigned samples' centroids (a codeword with no
    sample keeps its place) and their frequencies, floored at
    ``prob_floor`` and normalized; returns ``(codebook, log2_p)``."""
    num = q.codebook.shape[0]
    idx = q.assign(x)
    counts = torch.bincount(idx, minlength=num).to(x.dtype)
    sums = torch.zeros_like(q.codebook).index_add_(0, idx, x)
    codebook = torch.where(counts[:, None] > 0,
                           sums / torch.clamp(counts[:, None], min=1.0), q.codebook)
    p = torch.clamp(counts / x.shape[0], min=prob_floor)
    return codebook, torch.log2(p / torch.sum(p))


def train_ecvq(source: Callable, lmbda: float, num_codewords: int = 256,
               steps: int = 200, batch_size: int = 4096, seed: int = 0,
               prob_floor: float = 1e-8, device="cuda") -> ECVQ:
    """Lloyd-style ECVQ training from ``num_codewords`` source samples, a
    fresh batch each step, all drawn from one generator on ``device``
    seeded ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    codebook = source(gen, num_codewords)
    log2_p = torch.full((num_codewords,), -math.log2(num_codewords), device=dev)
    for _ in range(steps):
        x = source(gen, batch_size)
        codebook, log2_p = ecvq_update(ECVQ(codebook, log2_p, lmbda), x, prob_floor)
    return ECVQ(codebook, log2_p, lmbda)


def rd_point_ntc(cfg: Config, source: Callable, *, steps: int = 3000,
                 eval_n: int = 65536, seed: int = 0, device="cuda"):
    """Trains an NTC model and returns its (rate in bits a sample,
    distortion). All ``eval_n`` samples are coded as ONE range-coder
    stream, so the stream framing does not bias the rate."""
    model, _ = train(cfg, source, steps=steps, seed=seed, device=device)
    dev = resolve_device(device)
    x = source(torch.Generator(device=dev).manual_seed(seed + 1), eval_n)
    x_hat, strings = _code(model, x[None], coding_rank=2)
    rate = sum(len(s) for s in strings) * 8.0 / eval_n
    dist = float(torch.mean(torch.sum((x - x_hat[0]) ** 2, dim=-1)))
    return rate, dist


def rd_point_ecvq(source: Callable, lmbda: float, *, num_codewords: int = 256,
                  steps: int = 200, eval_n: int = 65536, seed: int = 0,
                  device="cuda"):
    q = train_ecvq(source, lmbda, num_codewords=num_codewords, steps=steps,
                   seed=seed, device=device)
    dev = resolve_device(device)
    x = source(torch.Generator(device=dev).manual_seed(seed + 1), eval_n)
    rate, dist = q.rate_distortion(x)
    return float(rate), float(dist)


def compare_ntc_vq(source: Callable = banana,
                   lambdas: Tuple[float, ...] = (0.3, 1.0, 3.0, 10.0),
                   csv_path: Optional[str] = None, ntc_steps: int = 3000,
                   vq_steps: int = 200, num_codewords: int = 256,
                   device="cuda"):
    """NTC against ECVQ over a lambda sweep: rows of (method, lambda, rate
    bits a sample, mse a sample), also written as CSV to ``csv_path``."""
    rows = []
    for lam in lambdas:
        r, d = rd_point_ntc(Config(lmbda=lam), source, steps=ntc_steps,
                            device=device)
        rows.append(("ntc", lam, r, d))
        r, d = rd_point_ecvq(source, lam, num_codewords=num_codewords,
                             steps=vq_steps, device=device)
        rows.append(("ecvq", lam, r, d))
    if csv_path:
        os.makedirs(os.path.dirname(os.path.abspath(csv_path)), exist_ok=True)
        with open(csv_path, "w") as f:
            f.write("method,lambda,rate_bits_per_sample,mse_per_sample\n")
            for m, lam, r, d in rows:
                f.write(f"{m},{lam},{r:.4f},{d:.6f}\n")
    return rows
