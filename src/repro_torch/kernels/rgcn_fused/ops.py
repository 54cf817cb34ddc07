"""K1 wrapper, its plain PyTorch version, and the two-level readout.

Counterpart of ``repro/kernels/rgcn_fused/{ops,ref}.py``.

``rgcn_fused_agg_flat``     the fused packed-layer aggregation: CUDA tensors
                            launch ``csrc/rgcn_fused.cu``, CPU tensors take
                            ``rgcn_fused_agg_flat_plain``.
``fused_two_level_readout`` node -> warp -> graph masked means; a
                            ``jax.ops.segment_sum`` pair in JAX (not Pallas),
                            plain ``index_add_`` here.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import check, launch, route


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


def rgcn_fused_agg_flat(h, basis, src, dst, coef, wnorm,
                        num_nodes: int) -> torch.Tensor:
    """agg (P,O) f32.  h (P,D) f32 or bf16; basis (nb,D,O) f32; src/dst
    (Q,) int32; coef (Q,nb) f32 = comb[etype]; wnorm (Q,) f32 =
    edge_mask * edge_norm.  Edges may come in any order: the CSR view the
    kernel walks is built here from a stable sort of dst."""
    if route(h) == "cpu":
        return rgcn_fused_agg_flat_plain(h, basis, src, dst, coef, wnorm,
                                         num_nodes)
    dev = h.device
    P = int(num_nodes)
    if basis.dim() != 3:
        raise ValueError(f"basis: expected (nb, D, O), got {tuple(basis.shape)}")
    nb, D, O = basis.shape
    Q = src.shape[0]
    check("h", h, dtype=(torch.float32, torch.bfloat16), shape=(P, D),
          device=dev)
    check("basis", basis, dtype=torch.float32, shape=(nb, D, O), device=dev)
    check("src", src, dtype=torch.int32, shape=(Q,), device=dev)
    check("dst", dst, dtype=torch.int32, shape=(Q,), device=dev)
    check("coef", coef, dtype=torch.float32, shape=(Q, nb), device=dev)
    check("wnorm", wnorm, dtype=torch.float32, shape=(Q,), device=dev)
    if nb > 4 or D > 256 or nb * D > 512:
        raise ValueError(f"rgcn_fused kernel takes nb <= 4, D <= 256, "
                         f"nb*D <= 512; got nb={nb}, D={D}")
    if Q and bool(((src < 0) | (src >= P) | (dst < 0) | (dst >= P)).any()):
        raise IndexError("rgcn_fused: edge endpoint outside [0, num_nodes)")
    # Edges with wnorm == 0 (pack_graphs' padded tail, masked edges) add
    # exactly zero for finite h; keyed past the last row they are never
    # walked — otherwise the whole padded tail (dst = 0) lands in row 0 and
    # one warp walks it while the rest of the card waits.
    key = torch.where(wnorm != 0, dst, torch.full_like(dst, P))
    sorted_key, perm = torch.sort(key, stable=True)
    rowptr = torch.searchsorted(
        sorted_key, torch.arange(P + 1, dtype=torch.int32, device=dev),
        out_int32=True)
    perm = perm.to(torch.int32)
    out = torch.empty(P, O, dtype=torch.float32, device=dev)
    launch("rgcn_fused_flat", h.data_ptr(), int(h.dtype == torch.bfloat16),
           *(t.data_ptr() for t in (src, perm, rowptr, coef, wnorm, basis,
                                    out)),
           P, D, nb, O)
    rgcn_fused_agg_flat.launches += 1
    return out


#: kernel launches made through this wrapper (CUDA tensors only)
rgcn_fused_agg_flat.launches = 0


def fused_two_level_readout(h, node_mask, warp_seg, warp_graph,
                            num_graphs: int) -> torch.Tensor:
    """(P,D) node states -> (G,D) graph embeddings.  Each level's (sum,
    count) pair rides one ``index_add_`` over a (., D+1) concatenation."""
    num_warps = warp_graph.shape[0]
    nmask = node_mask.to(h.dtype)
    x = torch.cat([h * nmask[:, None], nmask[:, None]], dim=1)
    wagg = torch.zeros(num_warps, x.shape[1], dtype=x.dtype, device=x.device)
    wagg.index_add_(0, warp_seg.long(), x)
    wsum, wcnt = wagg[:, :-1], wagg[:, -1]
    warp_mean = wsum / torch.clamp_min(wcnt, 1.0)[:, None]
    valid = (wcnt > 0).to(h.dtype)                            # (W,)
    y = torch.cat([warp_mean * valid[:, None], valid[:, None]], dim=1)
    gagg = torch.zeros(num_graphs, y.shape[1], dtype=y.dtype, device=y.device)
    gagg.index_add_(0, warp_graph.long(), y)
    gsum, gcnt = gagg[:, :-1], gagg[:, -1]
    return gsum / torch.clamp_min(gcnt, 1.0)[:, None]
