"""Known-bad R3: global RNG draws, global seeding, literal seeds."""
import numpy as np
import torch
import torch.nn.functional as F


def noisy(x):
    torch.manual_seed(0)
    noise = torch.randn(x.shape)                 # global torch RNG
    x = F.dropout(x, 0.1)                        # dropout: always global
    x.normal_()                                  # in place, global
    perm = np.random.permutation(len(x))         # global numpy RNG
    return x + noise, perm


def sample(n):
    rng = np.random.default_rng(1234)            # literal seed in a library
    gen = torch.Generator().manual_seed(7)
    return rng.choice(n), torch.rand(n, generator=gen)
