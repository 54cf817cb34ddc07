"""Known-good R1 around a dispatch loop: the outputs stay on the card and
come back in one copy after the loop; a waived loop syncs by design."""
import torch


def train_step(x: torch.Tensor) -> torch.Tensor:
    return (x * x).sum()


def fit(xs):
    losses = []
    for x in xs:
        losses.append(train_step(x))
    return torch.stack(losses).cpu().tolist()


def waived_fit(xs):
    out = []
    for x in xs:
        loss = train_step(x)
        # lint: allow[R1] a parity reference reads every step by design
        out.append(loss.item())
    return out
