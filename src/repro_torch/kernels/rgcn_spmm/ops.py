"""K5 wrapper, its plain PyTorch version, and the unfused layer
aggregation built on it.

Counterpart of ``repro/kernels/rgcn_spmm/{kernel,ops,ref}.py`` (the flat
variant only; the dense ``rgcn_spmm_fwd`` serves the dense encoder, which
the port has not reached).

``rgcn_spmm_flat``         the pre-basis accumulator s (P, nb*D): CUDA
                           tensors launch ``csrc/rgcn_spmm.cu``, CPU tensors
                           take ``rgcn_spmm_flat_plain``.
``rgcn_message_agg_flat``  K5, then the basis contraction as
                           ``torch.matmul`` (JAX does that product outside
                           Pallas too); differentiable, its backward is K1b
                           with unit edge norms.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import (
    EdgeCSR, check, check_endpoints, edge_csr, launch, route,
)


def rgcn_spmm_flat_plain(h, src, dst, w, num_nodes: int) -> torch.Tensor:
    """s (P, nb*D) f32 = segment-sum over dst of w[e,k] * h[src_e] (the
    model is ``rgcn_spmm/ref.py``: gather in h's dtype, products and sums
    in float32)."""
    P, D = int(num_nodes), h.shape[1]
    nb = w.shape[1]
    h_src = h.index_select(0, src.long())                     # (Q,D)
    weighted = h_src[:, None, :] * w[..., None]               # (Q,nb,D) f32
    s = torch.zeros(P, nb, D, dtype=torch.float32, device=h.device)
    s.index_add_(0, dst.long(), weighted)
    return s.reshape(P, nb * D)


def rgcn_spmm_flat(h, src, dst, w, num_nodes: int, *,
                   csr: Optional[EdgeCSR] = None,
                   checked: bool = True) -> torch.Tensor:
    """s (P, nb*D) f32.  h (P,D) f32 or bf16; src/dst (Q,) int32; w (Q,nb)
    f32 (relation coefficient x edge mask x degree normalizer).  Q = 0
    gives zeros.  ``csr``: the destination CSR (``edge_csr(dst, live, P)``)
    when the caller already holds it — any ``live`` that keeps every edge
    with a nonzero weight; built here otherwise, keyed on the weights.
    ``checked=False`` skips the endpoint check (one host sync) for callers
    that validated the edges before upload."""
    if route(h) == "cpu":
        return rgcn_spmm_flat_plain(h, src, dst, w, num_nodes)
    dev = h.device
    P = int(num_nodes)
    if h.dim() != 2 or w.dim() != 2:
        raise ValueError(f"h (P, D) and w (Q, nb) expected, got "
                         f"{tuple(h.shape)} and {tuple(w.shape)}")
    D, (Q, nb) = h.shape[1], w.shape
    check("h", h, dtype=(torch.float32, torch.bfloat16), shape=(P, D),
          device=dev)
    check("src", src, dtype=torch.int32, shape=(Q,), device=dev)
    check("dst", dst, dtype=torch.int32, shape=(Q,), device=dev)
    check("w", w, dtype=torch.float32, shape=(Q, nb), device=dev)
    if nb > 4 or D > 256:
        raise ValueError(f"rgcn_spmm kernel takes nb <= 4, D <= 256; got "
                         f"nb={nb}, D={D}")
    if checked:
        check_endpoints(src, dst, P, "rgcn_spmm")
    if csr is None:
        csr = edge_csr(dst, (w != 0).any(1), P)
    out = torch.empty(P, nb * D, dtype=torch.float32, device=dev)
    launch("rgcn_spmm_flat", h.data_ptr(), int(h.dtype == torch.bfloat16),
           *(t.data_ptr() for t in (src, csr.perm, csr.rowptr, w, out)),
           P, D, nb)
    rgcn_spmm_flat.launches += 1
    return out


#: kernel launches made through this wrapper (CUDA tensors only)
rgcn_spmm_flat.launches = 0


class _MessageAggFlat(torch.autograd.Function):
    """agg = K5(h, w) @ basisflat; backward: t = g @ basisflat^T, dbasis =
    s^T g (s saved from the forward), and dh / dw from K1b with w as the
    coefficients and unit norms (every edge walked: a zero-weight edge
    still has a nonzero dw)."""

    @staticmethod
    def forward(ctx, h, basis, w, src, dst, num_nodes, checked):
        nb, D, O = basis.shape
        s = rgcn_spmm_flat(h, src, dst, w, num_nodes, checked=checked)
        ctx.save_for_backward(h, basis, w, src, dst, s)
        ctx.num_nodes = num_nodes
        return s @ basis.reshape(nb * D, O)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.kernels.rgcn_fused.ops import rgcn_fused_bwd

        h, basis, w, src, dst, s = ctx.saved_tensors
        nb, D, O = basis.shape
        g = g.contiguous()
        dbasis = (s.t() @ g).reshape(nb, D, O)
        dh = dw = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[2]:
            t = (g @ basis.reshape(nb * D, O).t()).contiguous()
            ones = torch.ones(w.shape[0], dtype=w.dtype, device=w.device)
            dh, dw = rgcn_fused_bwd(h, t, src, dst, w.contiguous(), ones,
                                    ctx.num_nodes, checked=False)
        return dh, dbasis, dw, None, None, None, None


def rgcn_message_agg_flat(h, basis, src, dst, w, num_nodes: int, *,
                          checked: bool = True) -> torch.Tensor:
    """agg (P,O) f32 = s @ basis.reshape(nb*D, O), s from K5.  h (P,D);
    basis (nb,D,O) f32; src/dst (Q,) int32; w (Q,nb) f32."""
    return _MessageAggFlat.apply(h, basis, w, src, dst, int(num_nodes),
                                 checked)
