"""Error-feedback int8 gradient compression (counterpart of
``repro/optim/grad_compress.py``).

Each gradient leaf plus its carried error is quantized to int8 with one
per-tensor scale and dequantized; what the quantization lost is carried to
the next step (Karimireddy et al., arXiv:1901.09847).  This is the
single-device value-level transform that ``apply_gradients`` calls.  The
collective forms of the JAX module (``psum_mean``, ``compressed_psum_mean``,
means over a mesh axis) need more than one card and are not ported.
"""

from __future__ import annotations

import torch

from repro_torch.optim.adamw import tree_leaves, tree_unflatten


def _quantize(x32: torch.Tensor):
    amax = torch.max(torch.abs(x32))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def compress_decompress(grads, err):
    """Quantize (grad + carried error) to int8; return the dequantized
    gradients (in each gradient's dtype) and the new error residual
    (float32), in the trees' structure."""
    new_g, new_e = [], []
    for g, e in zip(tree_leaves(grads), tree_leaves(err)):
        g32 = g.float() + e
        q, scale = _quantize(g32)
        deq = q.float() * scale
        new_g.append(deq.to(g.dtype))
        new_e.append(g32 - deq)
    return tree_unflatten(grads, new_g), tree_unflatten(err, new_e)
