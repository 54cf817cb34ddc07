"""Known-bad R5: library kernels on the port's path; a bf16 cast that
bypasses the precision policy."""
import torch
import torch.nn.functional as F


def attention(q, k, v):
    return F.scaled_dot_product_attention(q, k, v, is_causal=True)


def assign(x, c):
    return torch.cdist(x, c).argmin(1)


def aggregate(a_sparse, h):
    return torch.sparse.mm(a_sparse, h).to(torch.bfloat16)
