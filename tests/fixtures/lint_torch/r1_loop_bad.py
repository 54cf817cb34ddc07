"""Known-bad R1 in a dispatch loop: a host sync on a hot call's output
every iteration (linted as ``repro_torch.core.train``)."""
import torch


def train_step(x: torch.Tensor) -> torch.Tensor:
    return (x * x).sum()


def fit(xs):
    losses = []
    for x in xs:
        loss = train_step(x)
        losses.append(loss.item())       # one round trip per step
    return losses
