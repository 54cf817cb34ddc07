"""Device resolution shared by every entry point of the port.

``None`` means the card: entry points run on ``cuda`` unless the caller asks
for the CPU explicitly, and they raise instead of carrying on on the CPU
when no card is present.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None``/"cuda[:i]" -> a CUDA device (raises without one); "cpu" ->
    the CPU.  On CUDA, float32 matmuls and convolutions are pinned to full
    float32 (TF32 off, both switches set explicitly) so the encoder's
    ``torch.matmul`` products keep float32 precision on the card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: no CUDA device is available; pass "
                "device='cpu' to run the plain PyTorch path explicitly")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"repro_torch runs on cuda or cpu, not {dev}")
    return dev
