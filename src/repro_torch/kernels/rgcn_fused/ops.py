"""K1 and K1b wrappers, their plain PyTorch versions, the differentiable
layer aggregation, and the two-level readout.

Counterpart of ``repro/kernels/rgcn_fused/{ops,ref}.py``.

``rgcn_fused_agg_flat``     the fused packed-layer aggregation as a
                            ``torch.autograd.Function``: forward K1
                            (``csrc/rgcn_fused.cu``), backward
                            t = g @ basisflat^T and dbasis = s^T g as
                            ``torch.matmul`` with s recomputed by K5, and
                            dh / dcoef from K1b (``csrc/rgcn_fused_bwd.cu``).
                            JAX's backward is ``jax.vjp`` of the oracle
                            (``ops.py:_bwd``), which keeps only the inputs
                            as residuals; so does this one.
``rgcn_fused_flat_fwd``     K1 alone (CUDA -> kernel, CPU -> plain).
``rgcn_fused_bwd``          K1b alone (CUDA -> kernel, CPU -> plain).
``fused_two_level_readout`` node -> warp -> graph masked means; a
                            ``jax.ops.segment_sum`` pair in JAX (not Pallas),
                            one-hot matmuls here (fixed order, no atomics).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import (
    EdgeCSR, check, check_endpoints, edge_csr, launch, route,
)
from repro_torch.kernels.rgcn_spmm.ops import rgcn_spmm_flat


class EdgeIndex(NamedTuple):
    """The CSR views one packed batch (or augmented view) gives every layer:
    by destination for K1 and K5, by source for K1b, both keyed on
    ``wnorm != 0``.  Built once per batch on the card (``edge_index``);
    ``None`` fields on the CPU, where the plain versions need none, and
    ``by_src`` only when autograd is on (a backward may follow)."""
    by_dst: Optional[EdgeCSR]
    by_src: Optional[EdgeCSR]


def edge_index(src, dst, wnorm, num_nodes: int) -> EdgeIndex:
    if route(wnorm) == "cpu":
        return EdgeIndex(None, None)
    live = wnorm != 0
    return EdgeIndex(edge_csr(dst, live, num_nodes),
                     edge_csr(src, live, num_nodes)
                     if torch.is_grad_enabled() else None)


def rgcn_fused_agg_flat_plain(h, basis, src, dst, coef, wnorm,
                              num_nodes: int) -> torch.Tensor:
    """agg (P,O) = sum_k basis[k] . sum_{e: dst_e=v} coef[e,k]*wnorm[e]*h[src_e].

    The model is ``rgcn_fused_agg_flat_ref``: the gather runs in h's dtype,
    the weights and everything after the gather in float32 (type promotion
    of h_src * w), scatter then contract."""
    w = coef * wnorm[:, None]                                 # (Q,nb) f32
    h_src = h.index_select(0, src.long())                     # (Q,D)
    weighted = h_src[:, None, :] * w[..., None]               # (Q,nb,D) f32
    nb, D = basis.shape[0], basis.shape[1]
    s = torch.zeros(num_nodes, nb, D, dtype=torch.float32, device=h.device)
    s.index_add_(0, dst.long(), weighted)
    return torch.einsum("nkd,kdo->no", s, basis.float())


def _check_layer(h, src, dst, coef, wnorm, P, nb):
    dev = h.device
    Q, D = src.shape[0], h.shape[1]
    check("h", h, dtype=(torch.float32, torch.bfloat16), shape=(P, D),
          device=dev)
    check("src", src, dtype=torch.int32, shape=(Q,), device=dev)
    check("dst", dst, dtype=torch.int32, shape=(Q,), device=dev)
    check("coef", coef, dtype=torch.float32, shape=(Q, nb), device=dev)
    check("wnorm", wnorm, dtype=torch.float32, shape=(Q,), device=dev)


def rgcn_fused_flat_fwd(h, basis, src, dst, coef, wnorm, num_nodes: int, *,
                        csr: Optional[EdgeCSR] = None,
                        checked: bool = True) -> torch.Tensor:
    """K1: agg (P,O) f32.  h (P,D) f32 or bf16; basis (nb,D,O) f32;
    src/dst (Q,) int32; coef (Q,nb) f32 = comb[etype]; wnorm (Q,) f32 =
    edge_mask * edge_norm.  Edges may come in any order: the CSR view the
    kernel walks (``csr``, by destination) is built here from a stable sort
    of dst unless the caller passes it.  ``checked=False`` skips the
    endpoint check (one host sync) for callers that validated the edges
    before upload."""
    if route(h) == "cpu":
        return rgcn_fused_agg_flat_plain(h, basis, src, dst, coef, wnorm,
                                         num_nodes)
    P = int(num_nodes)
    if basis.dim() != 3:
        raise ValueError(f"basis: expected (nb, D, O), got {tuple(basis.shape)}")
    nb, D, O = basis.shape
    _check_layer(h, src, dst, coef, wnorm, P, nb)
    check("basis", basis, dtype=torch.float32, shape=(nb, D, O),
          device=h.device)
    if nb > 4 or D > 256 or nb * D > 512:
        raise ValueError(f"rgcn_fused kernel takes nb <= 4, D <= 256, "
                         f"nb*D <= 512; got nb={nb}, D={D}")
    if checked:
        check_endpoints(src, dst, P, "rgcn_fused")
    if csr is None:
        csr = edge_csr(dst, wnorm != 0, P)
    out = torch.empty(P, O, dtype=torch.float32, device=h.device)
    launch("rgcn_fused_flat", h.data_ptr(), int(h.dtype == torch.bfloat16),
           *(t.data_ptr() for t in (src, csr.perm, csr.rowptr, coef, wnorm,
                                    basis, out)),
           P, D, nb, O)
    rgcn_fused_agg_flat.launches += 1     # the public entry's count
    return out


def rgcn_fused_bwd_plain(h, t, src, dst, coef, wnorm, num_nodes: int):
    """(dh (P,D) in h's dtype, dcoef (Q,nb) f32) for t = g @ basisflat^T
    (P, nb*D): dh[u] = sum_{e: src_e=u} sum_k w[e,k] t[dst_e,k],
    dcoef[e,k] = wnorm_e <h[src_e], t[dst_e,k]>, w = coef * wnorm."""
    P, D = int(num_nodes), h.shape[1]
    nb = coef.shape[1]
    w = coef * wnorm[:, None]                                 # (Q,nb)
    tg = t.reshape(P, nb, D).index_select(0, dst.long())      # (Q,nb,D)
    m = (tg * w[..., None]).sum(1)                            # (Q,D) f32
    dh = torch.zeros(P, D, dtype=torch.float32, device=h.device)
    dh.index_add_(0, src.long(), m)
    hs = h.index_select(0, src.long()).float()                # (Q,D)
    dcoef = (tg * hs[:, None, :]).sum(-1) * wnorm[:, None]
    return dh.to(h.dtype), dcoef


def rgcn_fused_bwd(h, t, src, dst, coef, wnorm, num_nodes: int, *,
                   csr: Optional[EdgeCSR] = None, checked: bool = True):
    """K1b: (dh, dcoef), see ``rgcn_fused_bwd_plain``.  ``csr``: the edges
    by SOURCE, keyed on ``wnorm != 0`` (built here unless given)."""
    if route(h) == "cpu":
        return rgcn_fused_bwd_plain(h, t, src, dst, coef, wnorm, num_nodes)
    P, nb, D = int(num_nodes), coef.shape[-1], h.shape[1]
    _check_layer(h, src, dst, coef, wnorm, P, nb)
    check("t", t, dtype=torch.float32, shape=(P, nb * D), device=h.device)
    if nb > 4 or D > 256:
        raise ValueError(f"rgcn_fused_bwd kernel takes nb <= 4, D <= 256; "
                         f"got nb={nb}, D={D}")
    if checked:
        check_endpoints(src, dst, P, "rgcn_fused_bwd")
    if csr is None:
        csr = edge_csr(src, wnorm != 0, P)
    dh = torch.empty(P, D, dtype=h.dtype, device=h.device)
    dcoef = torch.zeros_like(coef)
    launch("rgcn_fused_bwd", h.data_ptr(), int(h.dtype == torch.bfloat16),
           *(x.data_ptr() for x in (t, dst, csr.perm, csr.rowptr, coef,
                                    wnorm, dh, dcoef)),
           P, D, nb)
    rgcn_fused_bwd.launches += 1
    return dh, dcoef


#: kernel launches made through this wrapper (CUDA tensors only)
rgcn_fused_bwd.launches = 0


class _FusedAggFlat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, basis, coef, src, dst, wnorm, num_nodes, edges,
                checked):
        edges = edges or edge_index(src, dst, wnorm, num_nodes)
        out = rgcn_fused_flat_fwd(h, basis, src, dst, coef, wnorm,
                                  num_nodes, csr=edges.by_dst,
                                  checked=checked)
        ctx.save_for_backward(h, basis, coef, src, dst, wnorm)
        ctx.num_nodes, ctx.edges = num_nodes, edges
        return out

    @staticmethod
    def backward(ctx, g):
        h, basis, coef, src, dst, wnorm = ctx.saved_tensors
        P, edges = ctx.num_nodes, ctx.edges
        nb, D, O = basis.shape
        bflat = basis.reshape(nb * D, O)
        g = g.contiguous()
        dh = dbasis = dcoef = None
        if ctx.needs_input_grad[1]:
            # s is recomputed (K5), not stored: JAX's residuals are the
            # inputs only.  w = coef * wnorm is zero wherever wnorm is, so
            # the destination CSR keyed on wnorm serves K5 as well.
            s = rgcn_spmm_flat(h, src, dst, coef * wnorm[:, None], P,
                               csr=edges.by_dst, checked=False)
            dbasis = (s.t() @ g).reshape(nb, D, O)
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[2]:
            t = (g @ bflat.t()).contiguous()                  # (P, nb*D)
            dh, dcoef = rgcn_fused_bwd(h, t, src, dst, coef, wnorm, P,
                                       csr=edges.by_src, checked=False)
        return dh, dbasis, dcoef, None, None, None, None, None, None


def rgcn_fused_agg_flat(h, basis, src, dst, coef, wnorm, num_nodes: int, *,
                        edges: Optional[EdgeIndex] = None,
                        checked: bool = True) -> torch.Tensor:
    """agg (P,O) f32, differentiable in h, basis and coef (wnorm gets no
    gradient: it depends only on the graph and the augmentation masks; in
    JAX its cotangent flows into no parameter).  ``edges``: the batch's
    CSR views (``edge_index``), shared by every layer; built per call
    otherwise.  ``checked=False`` skips the endpoint check (one host sync
    per call) for callers that validated the edges before upload."""
    return _FusedAggFlat.apply(h, basis, coef, src, dst, wnorm,
                               int(num_nodes), edges, checked)


#: K1 launches (CUDA tensors only), made by ``rgcn_fused_flat_fwd``
rgcn_fused_agg_flat.launches = 0


def _segment_sum(x: torch.Tensor, seg: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """sum of the rows of x per segment, as a one-hot matmul: a fixed-order
    reduction on every device (``index_add_`` adds with float atomics on
    the card, so its sums change from run to run)."""
    onehot = (torch.arange(num_segments, device=x.device)[:, None]
              == seg.long()[None, :]).to(x.dtype)            # (S, rows)
    return onehot @ x


def fused_two_level_readout(h, node_mask, warp_seg, warp_graph,
                            num_graphs: int) -> torch.Tensor:
    """(P,D) node states -> (G,D) graph embeddings.  Each level's (sum,
    count) pair rides one segment sum over a (., D+1) concatenation."""
    num_warps = warp_graph.shape[0]
    nmask = node_mask.to(h.dtype)
    x = torch.cat([h * nmask[:, None], nmask[:, None]], dim=1)
    wagg = _segment_sum(x, warp_seg, num_warps)
    wsum, wcnt = wagg[:, :-1], wagg[:, -1]
    warp_mean = wsum / torch.clamp_min(wcnt, 1.0)[:, None]
    valid = (wcnt > 0).to(h.dtype)                            # (W,)
    y = torch.cat([warp_mean * valid[:, None], valid[:, None]], dim=1)
    gagg = _segment_sum(y, warp_graph, num_graphs)
    gsum, gcnt = gagg[:, :-1], gagg[:, -1]
    return gsum / torch.clamp_min(gcnt, 1.0)[:, None]
