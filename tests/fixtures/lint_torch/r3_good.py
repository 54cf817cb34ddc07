"""Known-good R3: every draw from a generator the caller seeds; literal
seeds only as defaults and in a CLI."""
import numpy as np
import torch


def noisy(x, gen: torch.Generator):
    noise = torch.randn(x.shape, generator=gen)
    keep = torch.rand(x.shape, generator=gen) < 0.9
    x.normal_(generator=gen)
    return x * keep + noise


def sample(n, seed: int = 0):
    rng = np.random.default_rng(seed)
    return rng.choice(n)


def main():
    rng = np.random.default_rng(0)
    return rng.integers(10)
