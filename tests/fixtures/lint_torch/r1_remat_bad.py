"""Known-bad R1 in a block reached only through ``torch.utils.checkpoint``
(linted as ``repro_torch.core.train``, whose ``train_step`` is a pinned
hot entry): the rematerialised block runs on every step, and again in
the backward."""
import torch
from torch.utils.checkpoint import checkpoint


def _block(h: torch.Tensor):
    if float(h.abs().max()) > 1.0:       # float() of a device tensor
        h = h / 2
    return h * 2


def train_step(x: torch.Tensor):
    h = checkpoint(_block, x, use_reentrant=False)
    return (h * h).sum()
