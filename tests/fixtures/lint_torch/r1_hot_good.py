"""Known-good R1 in a hot function: host scalars and shapes only."""
import torch


def train_step(x: torch.Tensor, lr: float):
    n = int(x.shape[0])                  # a shape, not a tensor
    scale = float(lr) / n                # a host float
    loss = (x * x).sum() * scale
    return torch.stack([loss, torch.clamp(loss, max=1.0)])
