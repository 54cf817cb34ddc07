"""Known-good R1: one-ahead staging (the ``core/train._OneAhead`` shape,
linted as ``repro_torch.core.train``).  numpy touches only the host-side
inputs on the staging thread; the step's outputs stay on the card and
cross to the host once, after the loop."""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


def train_step(x: torch.Tensor) -> torch.Tensor:
    return (x * x).sum()


def stage(item):
    # host-side staging: numpy on the input (not a step output) is legal
    return torch.from_numpy(np.ascontiguousarray(item))


def prefetch_loop(items):
    out = []
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(stage, items[0])
        for nxt in items[1:]:
            batch = fut.result()
            fut = pool.submit(stage, nxt)   # staging rides the step
            out.append(train_step(batch))
        out.append(train_step(fut.result()))
    return torch.stack(out).cpu().tolist()  # one readback after the loop
