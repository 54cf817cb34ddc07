"""Known-bad R1: a one-ahead staging loop that reads the step's output
back on every iteration (linted as ``repro_torch.core.train``) — the host
round trip serializes exactly the work the staging thread was meant to
hide behind."""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


def train_step(x: torch.Tensor) -> torch.Tensor:
    return (x * x).sum()


def stage(item):
    return torch.from_numpy(np.ascontiguousarray(item))


def prefetch_loop(items):
    out = []
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(stage, items[0])
        for nxt in items[1:]:
            batch = fut.result()
            fut = pool.submit(stage, nxt)
            loss = train_step(batch)
            out.append(loss.cpu())      # R1b: a sync rides every step
    return out
