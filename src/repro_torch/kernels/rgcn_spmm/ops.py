"""K5 and K6 wrappers, their plain PyTorch versions, and the layer
aggregations built on them.

Counterpart of ``repro/kernels/rgcn_spmm/{kernel,ops,ref}.py``.

``rgcn_spmm_flat``         K5, the packed pre-basis accumulator s
                           (P, nb*D): CUDA tensors launch
                           ``csrc/rgcn_spmm.cu``, CPU tensors take
                           ``rgcn_spmm_flat_plain``.
``rgcn_message_agg_flat``  K5, then the basis contraction as
                           ``torch.matmul`` (JAX does that product outside
                           Pallas too); differentiable, its backward is K1b
                           with unit edge norms.
``rgcn_spmm_dense``        K6, the dense pre-basis accumulator s
                           (B, N, nb*D) of a ``pad_batch`` batch (the same
                           source; CPU tensors take ``rgcn_spmm_dense_plain``).
``rgcn_message_agg``       K6, then the basis contraction; differentiable,
                           its backward is K1b over the flattened batch.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import (
    EdgeCSR, check, check_endpoints, dense_edge_csr, launch, route,
    weight_csr,
)


# lint: allow[R4] plain version: route() sends it CPU tensors only
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
        csr = weight_csr(dst, w, P)
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
    coefficients and unit norms: a zero-weight edge still has a nonzero
    dw, which K1b writes for every edge, while its dh walk keeps only the
    edges of nonzero weight."""

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


# ---------------------------------------------------------------------------
# Dense batches (core/graphs.pad_batch): K6
# ---------------------------------------------------------------------------

# lint: allow[R4] plain version: route() sends it CPU tensors only
def rgcn_spmm_dense_plain(h, src, dst, w, num_nodes: int) -> torch.Tensor:
    """s (B, N, nb*D) f32 = per graph, segment-sum over dst of
    w[b,e,k] * h[b, src[b,e]] (the model is ``rgcn_spmm/ref.py:
    rgcn_message_agg_ref`` before its basis einsum: gather in h's dtype,
    products and sums in float32)."""
    B, N, D = h.shape[0], int(num_nodes), h.shape[2]
    E, nb = w.shape[1], w.shape[2]
    h_src = torch.gather(h, 1, src.long()[..., None].expand(B, E, D))
    weighted = h_src[:, :, None, :] * w[..., None]            # (B,E,nb,D) f32
    rows = dst.long() + N * torch.arange(B, device=h.device)[:, None]
    s = torch.zeros(B * N, nb, D, dtype=torch.float32, device=h.device)
    s.index_add_(0, rows.reshape(-1), weighted.reshape(B * E, nb, D))
    return s.reshape(B, N, nb * D)


def dense_csr(dst, wnorm, num_nodes: int) -> Optional[EdgeCSR]:
    """The destination CSR K6 walks, keyed on ``wnorm != 0`` (B, E): built
    once per dense batch and shared by every layer; ``None`` on the CPU,
    where the plain version needs none."""
    if route(wnorm) == "cpu":
        return None
    return dense_edge_csr(dst, wnorm != 0, num_nodes)


def rgcn_spmm_dense(h, src, dst, w, num_nodes: int, *,
                    csr: Optional[EdgeCSR] = None,
                    checked: bool = True) -> torch.Tensor:
    """K6: s (B, N, nb*D) f32.  h (B,N,D) f32 or bf16; src/dst (B,E) int32,
    node indices local to each graph; w (B,E,nb) f32 (relation coefficient
    x edge mask x degree normalizer).  E = 0 gives zeros; padded edges
    carry w = 0.  ``csr``: ``dense_edge_csr(dst, live, N)`` for any
    ``live`` that keeps every edge with a nonzero weight, built here
    otherwise, keyed on the weights.  ``checked=False`` skips the endpoint
    check (one host sync) for callers that validated the edges."""
    if route(h) == "cpu":
        return rgcn_spmm_dense_plain(h, src, dst, w, num_nodes)
    dev = h.device
    N = int(num_nodes)
    if h.dim() != 3 or w.dim() != 3:
        raise ValueError(f"h (B, N, D) and w (B, E, nb) expected, got "
                         f"{tuple(h.shape)} and {tuple(w.shape)}")
    B, D = h.shape[0], h.shape[2]
    E, nb = w.shape[1], w.shape[2]
    check("h", h, dtype=(torch.float32, torch.bfloat16), shape=(B, N, D),
          device=dev)
    check("src", src, dtype=torch.int32, shape=(B, E), device=dev)
    check("dst", dst, dtype=torch.int32, shape=(B, E), device=dev)
    check("w", w, dtype=torch.float32, shape=(B, E, nb), device=dev)
    if nb > 4 or D > 256:
        raise ValueError(f"rgcn_spmm kernel takes nb <= 4, D <= 256; got "
                         f"nb={nb}, D={D}")
    if checked:
        check_endpoints(src, dst, N, "rgcn_spmm_dense")
    if csr is None:
        csr = dense_edge_csr(dst, (w != 0).any(-1), N)
    out = torch.empty(B, N, nb * D, dtype=torch.float32, device=dev)
    launch("rgcn_spmm_dense", h.data_ptr(), int(h.dtype == torch.bfloat16),
           *(t.data_ptr() for t in (src, csr.perm, csr.rowptr, w, out)),
           B, N, E, D, nb)
    rgcn_spmm_dense.launches += 1
    return out


#: kernel launches made through this wrapper (CUDA tensors only)
rgcn_spmm_dense.launches = 0


class _MessageAgg(torch.autograd.Function):
    """agg = K6(h, w) @ basisflat; backward: dbasis = s^T g (s saved from
    the forward), and dh / dw from K1b over the flattened batch — h as
    (B*N, D), edge endpoints offset by b*N, w as the coefficients and unit
    norms, as ``_MessageAggFlat``."""

    @staticmethod
    def forward(ctx, h, basis, w, src, dst, num_nodes, csr, checked):
        nb, D, O = basis.shape
        B, N = h.shape[0], int(num_nodes)
        s = rgcn_spmm_dense(h, src, dst, w, N, csr=csr, checked=checked)
        ctx.save_for_backward(h, basis, w, src, dst, s)
        return (s.reshape(B * N, nb * D)
                @ basis.reshape(nb * D, O)).reshape(B, N, O)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.kernels.rgcn_fused.ops import rgcn_fused_bwd

        h, basis, w, src, dst, s = ctx.saved_tensors
        nb, D, O = basis.shape
        (B, N), E = h.shape[:2], w.shape[1]
        g = g.reshape(B * N, O).contiguous()
        dbasis = (s.reshape(B * N, nb * D).t() @ g).reshape(nb, D, O)
        dh = dw = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[2]:
            t = (g @ basis.reshape(nb * D, O).t()).contiguous()
            off = (N * torch.arange(B, dtype=torch.int32,
                                    device=src.device))[:, None]
            ones = torch.ones(B * E, dtype=w.dtype, device=w.device)
            dh, dw = rgcn_fused_bwd(
                h.reshape(B * N, D), t, (src + off).reshape(-1),
                (dst + off).reshape(-1), w.reshape(B * E, nb).contiguous(),
                ones, B * N, checked=False)
            dh, dw = dh.reshape(B, N, D), dw.reshape(B, E, nb)
        return dh, dbasis, dw, None, None, None, None, None


def rgcn_message_agg(h, basis, src, dst, w, num_nodes: int, *,
                     csr: Optional[EdgeCSR] = None,
                     checked: bool = True) -> torch.Tensor:
    """agg (B,N,O) f32 = s @ basis.reshape(nb*D, O), s from K6.  h (B,N,D);
    basis (nb,D,O) f32; src/dst (B,E) int32; w (B,E,nb) f32 = comb[etype]
    x edge mask x degree normalizer (JAX ``rgcn_message_agg``)."""
    return _MessageAgg.apply(h, basis, w, src, dst, int(num_nodes), csr,
                             checked)
