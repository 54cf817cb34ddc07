"""Mixed-precision policy of the encoder (counterpart of
``repro/core/precision.py``), with torch dtypes.

``compute_dtype`` is the activation dtype inside the encoder layers;
LayerNorm statistics and the readout stay float32, parameters stay float32.
``loss_scale`` is the static loss scale of training: the trainer
multiplies the loss before differentiation and ``optim.adamw_update``
divides the gradients back out.  The default policy is pure float32 with
scale 1.0, and every cast is an identity.  The JAX policy's master-param
dtype is left out: parameters are always float32 here.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Policy:
    compute_dtype: str = "float32"
    loss_scale: float = 1.0

    @property
    def compute(self) -> torch.dtype:
        dt = getattr(torch, self.compute_dtype, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"unknown dtype {self.compute_dtype!r}")
        return dt

    def cast_compute(self, x: torch.Tensor) -> torch.Tensor:
        """Cast an activation to the compute dtype (identity under f32)."""
        return x.to(self.compute) if x.dtype != self.compute else x
