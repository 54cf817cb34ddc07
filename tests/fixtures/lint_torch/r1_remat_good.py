"""Known-good R1 in a block reached only through
``torch.utils.checkpoint``: the branch stays on the device."""
import torch
from torch.utils.checkpoint import checkpoint


def _block(h: torch.Tensor):
    return torch.where(h.abs().amax() > 1.0, h / 2, h) * 2


def train_step(x: torch.Tensor):
    h = checkpoint(_block, x, use_reentrant=False)
    return (h * h).sum()
