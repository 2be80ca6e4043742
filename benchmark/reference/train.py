"""The reference training step: the family's rate-distortion loss
(``rd_loss`` in ``reference/families/<family>.py``), its gradients by
autograd, and Adam as optax applies it (``eps`` outside the square root,
bias-corrected moments).
"""

from __future__ import annotations

import torch

from benchmark.reference.codec import precision
from benchmark.reference.models import family


class Adam:
    """optax.adam: m, v bias-corrected, ``p -= lr * m_hat / (sqrt(v_hat) + eps)``.
    ``m``, ``v`` and ``count`` may start from a given state."""

    def __init__(self, params: dict, lr: float, b1=0.9, b2=0.999, eps=1e-8,
                 m=None, v=None, count=0):
        self.lr, self.b1, self.b2, self.eps, self.count = lr, b1, b2, eps, int(count)
        self.m = {k: (torch.zeros_like(p) if m is None else m[k].clone())
                  for k, p in params.items()}
        self.v = {k: (torch.zeros_like(p) if v is None else v[k].clone())
                  for k, p in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict):
        self.count += 1
        for k, g in grads.items():
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            m_hat = self.m[k] / (1 - self.b1 ** self.count)
            v_hat = self.v[k] / (1 - self.b2 ** self.count)
            params[k].sub_(self.lr * m_hat / (torch.sqrt(v_hat) + self.eps))


def run_steps(cfg: dict, params: dict, batches, generator, steps: int, tf32: bool = False,
              adam_state=None):
    """``steps`` steps from ``params`` (a flat dict, copied) on uint8
    ``batches``, in float32 (TF32 only for the control), Adam from zero or
    from ``adam_state`` (``{"m": ..., "v": ..., "count": n}``); returns the
    losses, the first step's gradients, the parameters after the last step
    and Adam's state then."""
    with precision(tf32):
        loss_fn = family(cfg).rd_loss
        p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        opt = Adam(p, cfg["training"]["learning_rate"], **(adam_state or {}))
        losses, first_grads = [], None
        for batch in batches[:steps]:
            x = batch.to(torch.float32) / 255.0
            loss = loss_fn(cfg, p, x, generator)
            grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
            if first_grads is None:
                first_grads = {k: g.detach().clone() for k, g in grads.items()}
            opt.step(p, grads)
            losses.append(float(loss.detach()))
        return (losses, first_grads, {k: v.detach() for k, v in p.items()},
                {"m": opt.m, "v": opt.v, "count": opt.count})
