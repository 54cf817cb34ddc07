"""AdamW with decoupled weight decay and global-norm clipping (counterpart
of ``repro/optim/adamw.py`` and of ``repro/config.py:TrainConfig``).

- weight decay on every leaf, LayerNorm scales and biases included, as the
  JAX package does;
- the global gradient norm is reported unscaled, and clipping scales
  gradients to at most ``grad_clip``;
- the learning rate is the schedule's at ``step + 1``;
- a static ``loss_scale`` (the precision policy's) is divided back out of
  the gradients in float32 before the moment update.

Parameters and moments are dictionaries of float32 tensors keyed alike;
the update runs in place (the port's parameters are ``nn.Parameter``s that
the encoder module owns) and keeps every quantity on the device, so it
makes no host sync.  The JAX package's bf16 moments (``opt_dtype``) and
int8 gradient compression are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.optim.schedules import SCHEDULES


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 7e-4          # paper: AdamW lr 7e-4
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    warmup_steps: int = 100
    total_steps: int = 1_000
    schedule: str = "cosine"             # paper: cosine annealing
    grad_clip: float = 1.0
    loss_scale: float = 1.0              # unscaled inside adamw_update


def adamw_init(params: dict) -> tuple[dict, dict]:
    """Zero first and second moments, shaped and placed like ``params``."""
    mu = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
    nu = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
    return mu, nu


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


@torch.no_grad()
def adamw_update(params: dict, grads: dict, mu: dict, nu: dict, step: int,
                 tcfg: TrainConfig) -> dict:
    """One AdamW step in place on ``params``, ``mu`` and ``nu``.  ``step``
    is the number of updates already applied.  Returns ``{"lr": float,
    "grad_norm": 0-d tensor}``."""
    t = step + 1
    lr = SCHEDULES[tcfg.schedule](
        t, base_lr=tcfg.learning_rate, total_steps=tcfg.total_steps,
        warmup_steps=tcfg.warmup_steps)
    inv_scale = 1.0 / tcfg.loss_scale
    gnorm = global_norm(grads.values()) * inv_scale
    clip = torch.clamp(tcfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    scale = inv_scale * clip
    b1, b2, eps, wd = tcfg.beta1, tcfg.beta2, tcfg.eps, tcfg.weight_decay
    f = np.float32
    c1 = float(f(1.0) - f(b1) ** f(t))
    c2 = float(f(1.0) - f(b2) ** f(t))
    for k, p in params.items():
        g = grads[k].float() * scale
        m = b1 * mu[k] + (1 - b1) * g
        v = b2 * nu[k] + (1 - b2) * torch.square(g)
        update = (m / c1) / (torch.sqrt(v / c2) + eps)
        p32 = p.float()
        p.copy_(p32 - lr * (update + wd * p32))
        mu[k].copy_(m)
        nu[k].copy_(v)
    return {"lr": lr, "grad_norm": gnorm}
