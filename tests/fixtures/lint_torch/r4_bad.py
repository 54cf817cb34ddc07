"""Known-bad R4: order-dependent sums and gathers whose backwards scatter
with float atomics on the card."""
import torch
import torch.nn.functional as F


def aggregate(h, src, dst, table, idx):
    s = torch.zeros_like(h)
    s.index_add_(0, dst, h[src])
    t = torch.scatter_add(torch.zeros_like(h), 0, dst[:, None].expand_as(h), h)
    s.index_put_((dst,), h, accumulate=True)
    e = F.embedding(idx, table)
    r = table.index_select(0, idx)
    return s + t, e + r
