"""LR schedules (counterpart of ``repro/optim/schedules.py``).  The paper
trains with AdamW + cosine annealing from lr0 = 7e-4, with linear warmup.

The step is a host integer, so the rate is computed on the host, in
float32 as JAX computes it, and handed to the update as a Python float
(exactly a float32 value): no device sync per step.
"""

from __future__ import annotations

import numpy as np

_F = np.float32


def cosine_schedule(step, *, base_lr, total_steps, warmup_steps=0,
                    min_ratio=0.01) -> float:
    step = _F(step)
    warm = (min(step / _F(max(warmup_steps, 1)), _F(1.0))
            if warmup_steps > 0 else _F(1.0))
    t = np.clip((step - _F(warmup_steps)) / _F(max(total_steps - warmup_steps, 1)),
                _F(0.0), _F(1.0))
    cos = _F(min_ratio) + _F(1 - min_ratio) * _F(0.5) * (_F(1) + np.cos(_F(np.pi) * t))
    return float(_F(base_lr) * warm * cos)


def constant_schedule(step, *, base_lr, **_) -> float:
    return float(_F(base_lr))


SCHEDULES = {"cosine": cosine_schedule, "constant": constant_schedule}
