"""Error-feedback int8 gradient compression (counterpart of
``repro/optim/grad_compress.py``).

Each gradient leaf plus its carried error is quantized to int8 with one
per-tensor scale and dequantized; what the quantization lost is carried to
the next step (Karimireddy et al., arXiv:1901.09847).
``compress_decompress`` is the value-level transform that
``apply_gradients`` calls.  ``psum_mean`` and ``compressed_psum_mean`` are
the JAX module's means over a mesh axis, taken here over the ranks of a
:class:`~repro_torch.distributed.group.Group`.  As in JAX, the fit calls
neither: its gradient is summed in rank order and then compressed by
value.

JAX sums the int8 codes widened to int16 (2 bytes an element on the wire).
Neither gloo nor NCCL reduces int16, so the port sums them as int32 (4
bytes an element, as many as the float32 mean it replaces); the integer
sum is exact either way, so the values are JAX's.
"""

from __future__ import annotations

import torch

from repro_torch.optim.adamw import tree_leaves, tree_unflatten


def _quantize(x32: torch.Tensor, reduce=None):
    amax = torch.max(torch.abs(x32))
    if reduce is not None:
        amax = reduce(amax)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def compress_decompress(grads, err, amax=None):
    """Quantize (grad + carried error) to int8; return the dequantized
    gradients (in each gradient's dtype) and the new error residual
    (float32), in the trees' structure.  ``amax``, when given, maps a
    block's largest magnitude to its leaf's (the MAX over a model mesh),
    so each element takes the code it takes on one card."""
    new_g, new_e = [], []
    for g, e in zip(tree_leaves(grads), tree_leaves(err)):
        g32 = g.float() + e
        q, scale = _quantize(g32, amax)
        deq = q.float() * scale
        new_g.append(deq.to(g.dtype))
        new_e.append(g32 - deq)
    return tree_unflatten(grads, new_g), tree_unflatten(err, new_e)


@torch.no_grad()
def psum_mean(grads, group):
    """The exact mean of every rank's gradients (one float32 SUM
    ``all_reduce`` a leaf), in each gradient's dtype."""
    out = []
    for g in tree_leaves(grads):
        total = group.all_reduce(g.float().contiguous().clone())
        out.append((total / group.size).to(g.dtype))
    return tree_unflatten(grads, out)


@torch.no_grad()
def compressed_psum_mean(grads, err, group):
    """Error-feedback int8 mean over the ranks (JAX's
    ``compressed_psum_mean``).  Per leaf: add the carried error, share one
    scale (a MAX ``all_reduce`` of each rank's amax, JAX's ``pmax``), round
    to int8 codes, sum the codes over the ranks as int32, and scale back.
    The new residual is local: what this rank failed to send.  Returns
    ``(mean_grads, new_err)`` in the trees' structures."""
    new_g, new_e = [], []
    for g, e in zip(tree_leaves(grads), tree_leaves(err)):
        g32 = g.float() + e
        amax = group.all_reduce(torch.max(torch.abs(g32)).reshape(1),
                                "max")[0]
        scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        total = group.all_reduce(q.to(torch.int32).contiguous())
        new_g.append((total.float() * scale / group.size).to(g.dtype))
        new_e.append(g32 - q.float() * scale)
    return tree_unflatten(grads, new_g), tree_unflatten(err, new_e)
