"""Mixed-precision policy of the encoder (counterpart of
``repro/core/precision.py``), with torch dtypes.

``compute_dtype`` is the activation dtype inside the encoder layers;
LayerNorm statistics and the readout stay float32, parameters stay float32.
The default policy is pure float32 and every cast is an identity.  The
JAX policy's master-param dtype and loss scale serve training and come
with the training slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Policy:
    compute_dtype: str = "float32"

    @property
    def compute(self) -> torch.dtype:
        dt = getattr(torch, self.compute_dtype, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"unknown dtype {self.compute_dtype!r}")
        return dt

    def cast_compute(self, x: torch.Tensor) -> torch.Tensor:
        """Cast an activation to the compute dtype (identity under f32)."""
        return x.to(self.compute) if x.dtype != self.compute else x
