"""Known-bad R1 in a hot function (linted as ``repro_torch.core.train``,
whose ``train_step`` is a pinned hot entry)."""
import numpy as np
import torch


def _metrics(loss: torch.Tensor):
    return {"loss": float(loss)}         # float() of a device tensor


def train_step(x: torch.Tensor):
    loss = (x * x).sum()
    if loss > 0:                         # a tensor tested as a bool
        loss = loss * 2
    host = np.asarray(loss)              # np.asarray of a device tensor
    return loss.item(), host, _metrics(loss)
