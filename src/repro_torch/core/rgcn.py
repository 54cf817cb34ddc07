"""RGCN encoder with basis decomposition + projection head (paper §3.3.2),
packed and dense paths.  Counterpart of ``repro/core/rgcn.py``.

Architecture: 3 relational conv layers (64 -> 128 -> 128 -> 256), basis
decomposition per layer, LayerNorm + ReLU + dropout (the last layer keeps
the full representation: no dropout), mean-pool readout to warp
embeddings, warp mean to the kernel embedding z_k in R^256; projection
head 256 -> 128 (ReLU, dropout) -> 64.  Node features are built in-model
(paper §3.3.1).

The encoder is an ``nn.Module`` whose parameters keep the JAX pytree's
names (``repro_torch.interop`` maps one onto the other).  The packed path
(``encode_packed``, the main path) passes messages through
``kernels.rgcn_fused`` (K1 forward, K1b + K5 backward); the dense path
(``encode``, batches from ``core/graphs.pad_batch``: every graph padded to
the batch's largest) through ``kernels.rgcn_spmm.rgcn_message_agg`` (K6
forward, K1b backward): the hand-written kernels for CUDA tensors, their
plain versions for CPU tensors.  ``h @ w0``, the basis contraction after
K5 / K6 and the projection head are ``torch.matmul``, as the JAX package
leaves those to XLA.

Training mode takes its randomness from an explicit draws object
(``EncodeDraws``: feature noise, dropout keep masks; the projection's keep
mask is an argument of ``project``), never from a global generator, so the
same draws give the same forward pass on the CPU and the card.  The
relation coefficients ``comb[etype]`` and the readouts are one-hot
matmuls, so their gradients are matmuls too (fixed-order reductions)
rather than scatter-adds with float atomics.  ``unfused_ref=True`` is the
JAX package's pre-fusion packed path: the normalizer recomputed per layer,
K5 + a matmul in place of K1, and the four-sum readout.  The ablation
switches ``use_vstats`` and ``relations_used`` act on both paths as in
JAX.  ``message_dtype`` is JAX's: the messages (K1, K5, K6) gather ``h``
in the narrower of it and the policy's compute dtype, while ``h @ w0``
and the epilogue keep ``h``; the kernels' precision profile holds (the
gather in that dtype, the weights and sums float32), where JAX's XLA path
also rounds the products and sums to it.  JAX's ``use_pallas`` has no
counterpart: the port always runs the kernels.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Optional

import torch
from torch import nn

from repro_torch.core.augment import (
    apply_feature_noise, apply_feature_noise_packed,
)
from repro_torch.core.graphs import NUM_RELATIONS
from repro_torch.core.precision import Policy
from repro_torch.kernels import check_endpoints
from repro_torch.kernels.rgcn_fused.ops import (
    edge_index, fused_two_level_readout, rgcn_fused_agg_flat,
)
from repro_torch.kernels.rgcn_spmm.ops import (
    dense_csr, rgcn_message_agg, rgcn_message_agg_flat,
)
from repro_torch.tracing.isa import NUM_OPCODES, PSEUDO_KINDS, VAR_KINDS


@dataclass(frozen=True)
class RGCNConfig:
    dims: tuple = (64, 128, 128, 256)
    num_bases: int = 2
    num_relations: int = NUM_RELATIONS
    proj_hidden: int = 128
    proj_out: int = 64
    dropout: float = 0.1
    feat_noise_sigma: float = 0.01
    #: 'bfloat16' gathers the messages in bf16 (halving the gathers'
    #: traffic); they run in the narrower of this and the policy's dtype
    message_dtype: str = "float32"
    #: activations (and K1's gathered messages) run in the policy's compute
    #: dtype; LayerNorm statistics and the readout stay float32
    policy: Policy = field(default_factory=Policy)
    # ablation switches (the JAX package's benchmarks/bench_ablations.py)
    use_vstats: bool = True           # dynamic-value summary features
    relations_used: tuple = (0, 1, 2, 3)  # subset of edge relations


class RGCNLayer(nn.Module):
    def __init__(self, din: int, dout: int, num_bases: int,
                 num_relations: int):
        super().__init__()
        self.basis = nn.Parameter(torch.zeros(num_bases, din, dout))
        self.comb = nn.Parameter(torch.zeros(num_relations, num_bases))
        self.w0 = nn.Parameter(torch.zeros(din, dout))
        self.b = nn.Parameter(torch.zeros(dout))
        self.ln_scale = nn.Parameter(torch.ones(dout))
        self.ln_bias = nn.Parameter(torch.zeros(dout))


class Projection(nn.Module):
    def __init__(self, din: int, hidden: int, dout: int):
        super().__init__()
        self.w1 = nn.Parameter(torch.zeros(din, hidden))
        self.b1 = nn.Parameter(torch.zeros(hidden))
        self.w2 = nn.Parameter(torch.zeros(hidden, dout))
        self.b2 = nn.Parameter(torch.zeros(dout))


class RGCNEncoder(nn.Module):
    """Parameters of the encoder + head; ``forward`` = ``encode_packed``."""

    def __init__(self, rc: RGCNConfig):
        super().__init__()
        self.rc = rc
        self.embed_instr = nn.Parameter(torch.zeros(NUM_OPCODES, 64))
        self.embed_var = nn.Parameter(torch.zeros(len(VAR_KINDS), 32))
        self.embed_pseudo = nn.Parameter(torch.zeros(len(PSEUDO_KINDS), 16))
        self.layers = nn.ModuleList(
            RGCNLayer(rc.dims[i], rc.dims[i + 1], rc.num_bases,
                      rc.num_relations)
            for i in range(len(rc.dims) - 1))
        self.proj = Projection(rc.dims[-1], rc.proj_hidden, rc.proj_out)

    def forward(self, batch: dict) -> torch.Tensor:
        return encode_packed(self, self.rc, batch)


def init_rgcn(seed: int, rc: RGCNConfig) -> RGCNEncoder:
    """Randomly initialised encoder (same scales as the JAX ``init_rgcn``;
    the draws come from a ``torch.Generator`` and differ from JAX's)."""
    g = torch.Generator().manual_seed(int(seed))
    enc = RGCNEncoder(rc)

    def normal(p: nn.Parameter, scale: float) -> None:
        with torch.no_grad():
            p.copy_(torch.randn(p.shape, generator=g) * scale)

    normal(enc.embed_instr, 0.1)
    normal(enc.embed_var, 0.1)
    normal(enc.embed_pseudo, 0.1)
    for lp, din in zip(enc.layers, rc.dims[:-1]):
        normal(lp.basis, 1.0 / math.sqrt(din))
        normal(lp.comb, 1.0 / math.sqrt(rc.num_bases))
        normal(lp.w0, 1.0 / math.sqrt(din))
    normal(enc.proj.w1, 1.0 / math.sqrt(rc.dims[-1]))
    normal(enc.proj.w2, 1.0 / math.sqrt(rc.proj_hidden))
    return enc


@lru_cache(maxsize=None)
def _pe_freqs(half: int, device: torch.device) -> torch.Tensor:
    """The positional encoding's frequency table, computed on the CPU and
    copied to ``device`` once.  The encoding takes sin/cos of angles up to
    1000 rad, where one ulp of a frequency moves a feature by ~6e-5 and the
    encoder's gradients by ~4e-3; the card's ``exp`` rounds some of these
    32 values differently from the CPU's, so every device uses the CPU's
    table (the one the JAX package's CPU path computes too)."""
    freqs = torch.exp(torch.arange(half, dtype=torch.float32)
                      * (-math.log(10_000.0) / half))
    return freqs.to(device)


def _positional_encoding(pc_norm: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal PE of normalized PC (...,) -> (..., dim)."""
    freqs = _pe_freqs(dim // 2, pc_norm.device)
    ang = pc_norm[..., None] * 1000.0 * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _stats_encode(vstats: torch.Tensor) -> torch.Tensor:
    return torch.sign(vstats) * torch.sqrt(torch.abs(vstats)) * 0.3


def _lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] as a one-hot matmul: exact (one nonzero term per row),
    and its backward is a fixed-order matmul.  Indexing's backward
    accumulates rows in an order that changes from run to run on the CPU,
    ``F.embedding``'s on the card."""
    return torch.nn.functional.one_hot(idx, table.shape[0]).to(
        table.dtype) @ table


def node_features(p: RGCNEncoder, rc: RGCNConfig, batch: dict
                  ) -> torch.Tensor:
    tok = batch["token"].long()
    ntype = batch["node_type"]
    instr = _lookup(p.embed_instr, torch.clamp(tok, 0, NUM_OPCODES - 1))
    instr = instr + _positional_encoding(batch["pc_norm"], 64)
    var32 = _lookup(p.embed_var, torch.clamp(tok, 0, len(VAR_KINDS) - 1))
    vstats = batch["vstats"] if rc.use_vstats \
        else torch.zeros_like(batch["vstats"])
    var = torch.cat([var32, _stats_encode(vstats),
                     var32.new_zeros(var32.shape[:-1] + (64 - 40,))], dim=-1)
    pse16 = _lookup(p.embed_pseudo,
                    torch.clamp(tok, 0, len(PSEUDO_KINDS) - 1))
    pseudo = torch.cat([pse16, pse16.new_zeros(pse16.shape[:-1] + (48,))],
                       dim=-1)
    h = torch.where((ntype == 0)[..., None], instr,
                    torch.where((ntype == 1)[..., None], pseudo, var))
    return h * batch["node_mask"][..., None]


@dataclass(frozen=True)
class EncodeDraws:
    """The random draws of one training-mode encode (JAX: the key split
    ``len(dims)`` ways in ``encode_packed`` / ``encode``).  noise (P,
    dims[0]) packed, (B, N, dims[0]) dense: standard normal in the compute
    dtype (JAX's ``rngs[-1]``); noise_gate (G,) / (B,): which graphs get
    feature noise (the view's strategy flags); dropout: one (P, dims[i+1])
    / (B, N, dims[i+1]) bool keep mask per non-last layer (``rngs[i]``)."""
    noise: Optional[torch.Tensor] = None
    noise_gate: Optional[torch.Tensor] = None
    dropout: tuple = ()


def _layer_epilogue(lp: RGCNLayer, rc: RGCNConfig, agg, h, node_mask, *,
                    last: bool, keep: Optional[torch.Tensor] = None,
                    train: bool = False) -> torch.Tensor:
    """Self-loop + LayerNorm (population variance, eps 1e-5) + ReLU +
    dropout (training, non-last layers, from the given keep mask) + node
    mask; cast back to the compute dtype except after the last layer,
    whose output feeds the f32 readout."""
    out = agg + h @ lp.w0.to(h.dtype) + lp.b
    out = out.float()
    mu = out.mean(-1, keepdim=True)
    sig = ((out - mu) ** 2).mean(-1, keepdim=True)
    out = (out - mu) * torch.rsqrt(sig + 1e-5) * lp.ln_scale + lp.ln_bias
    out = torch.relu(out)
    if not last and train and keep is not None and rc.dropout > 0:
        out = out * keep / (1 - rc.dropout)
    out = out * node_mask[..., None]
    return out if last else rc.policy.cast_compute(out)


def _message_dtype(rc: RGCNConfig) -> torch.dtype:
    """The messages' dtype: the narrower of ``message_dtype`` and the
    policy's compute dtype (float32 with float32 messages: no cast)."""
    mdt = getattr(torch, rc.message_dtype, None)
    if not isinstance(mdt, torch.dtype):
        raise ValueError(f"unknown message_dtype {rc.message_dtype!r}")
    comp = rc.policy.compute
    return comp if comp.itemsize < mdt.itemsize else mdt


def _messages(rc: RGCNConfig, h: torch.Tensor) -> torch.Tensor:
    """``h`` as the message kernels gather it (its gradient flows back
    through the cast)."""
    return h.to(_message_dtype(rc)).contiguous()


# lint: allow[R4] degree counts: sums of 0/1 mask values, exact in any order
def edge_norm_packed(dst, etype, emask, num_nodes: int,
                     num_relations: int) -> torch.Tensor:
    """Per-edge degree normalizer 1/|N_r(dst_e)| for a packed batch (the
    in-graph fallback for batches without the hoisted ``edge_norm``)."""
    key = dst.long() * num_relations + etype.long()
    deg = torch.zeros(num_nodes * num_relations, dtype=emask.dtype,
                      device=emask.device)
    deg.index_add_(0, key, emask)
    return 1.0 / torch.clamp_min(deg[key], 1.0)


def _relation_mask(rc: RGCNConfig, etype, emask) -> torch.Tensor:
    """The edge mask with the relations outside ``rc.relations_used``
    switched off (the ablation; JAX compares with all four literally)."""
    if tuple(rc.relations_used) == (0, 1, 2, 3):
        return emask
    used = torch.tensor(rc.relations_used, dtype=etype.dtype,
                        device=etype.device)
    return emask * torch.isin(etype, used)


def _rgcn_layer_packed(lp: RGCNLayer, rc: RGCNConfig, h, batch, emask,
                       wnorm, onehot_etype, edges, *, last: bool, keep=None,
                       train: bool = False,
                       unfused_ref: bool = False) -> torch.Tensor:
    P = h.shape[0]
    src, dst = batch["edge_src"], batch["edge_dst"]
    coef = onehot_etype @ lp.comb                       # (Q,nb) = comb[etype]
    if unfused_ref:
        norm = edge_norm_packed(dst, batch["edge_type"], emask, P,
                                rc.num_relations)
        w = coef * (emask * norm)[:, None]
        agg = rgcn_message_agg_flat(_messages(rc, h), lp.basis, src, dst,
                                    w.contiguous(), P, checked=False)
    else:
        agg = rgcn_fused_agg_flat(_messages(rc, h), lp.basis, src, dst,
                                  coef, wnorm, P, edges=edges, checked=False)
    return _layer_epilogue(lp, rc, agg, h, batch["node_mask"], last=last,
                           keep=keep, train=train)


def encode_packed(p: RGCNEncoder, rc: RGCNConfig, batch: dict, *,
                  draws: Optional[EncodeDraws] = None, train: bool = False,
                  unfused_ref: bool = False,
                  edges_checked: bool = False) -> torch.Tensor:
    """Packed batch (tensors on one device) -> kernel embeddings z_k
    (G, dims[-1]); padding graphs (graph_mask == 0) give zero rows.

    ``train=True`` with ``draws``: dropout after the non-last layers and
    per-graph gated feature noise, as JAX's ``encode_packed(rng=...,
    train=True, noise_gate=...)``.  ``edges_checked=True``: the caller
    validated the edge endpoints before upload (the trainer's and the
    embedder's staging do); otherwise they are checked here once per call
    (one host sync on the card)."""
    P = batch["node_mask"].shape[0]
    src, dst = batch["edge_src"], batch["edge_dst"]
    if not edges_checked:
        check_endpoints(src, dst, P, "encode_packed")
    h = rc.policy.cast_compute(node_features(p, rc, batch))     # (P, 64)
    if draws is not None and draws.noise is not None \
            and draws.noise_gate is not None:
        h = apply_feature_noise_packed(h, draws.noise, draws.noise_gate,
                                       batch["graph_id"], rc.feat_noise_sigma)
        h = h * batch["node_mask"].to(h.dtype)[:, None]
    emask = _relation_mask(rc, batch["edge_type"], batch["edge_mask"])
    norm = batch.get("edge_norm") if emask is batch["edge_mask"] else None
    if norm is None:     # no hoisted normalizer, or relations filtered out
        norm = edge_norm_packed(dst, batch["edge_type"], emask, P,
                                rc.num_relations)
    wnorm = (emask * norm).contiguous()                          # (Q,)
    onehot_etype = torch.nn.functional.one_hot(
        batch["edge_type"].long(), rc.num_relations).float()     # (Q,R)
    edges = None if unfused_ref else edge_index(src, dst, wnorm, P)
    keeps = draws.dropout if draws is not None else ()
    n_layers = len(p.layers)
    for li, lp in enumerate(p.layers):
        h = _rgcn_layer_packed(
            lp, rc, h, batch, emask, wnorm, onehot_etype, edges,
            last=(li == n_layers - 1),
            keep=keeps[li] if li < len(keeps) else None, train=train,
            unfused_ref=unfused_ref)
    G = batch["graph_mask"].shape[0]
    if unfused_ref:
        return _four_sum_readout(h, batch["node_mask"], batch["warp_seg"],
                                 batch["warp_graph"], G)
    return fused_two_level_readout(h, batch["node_mask"], batch["warp_seg"],
                                   batch["warp_graph"], G)


def _four_sum_readout(h, node_mask, warp_seg, warp_graph, num_graphs: int):
    """The pre-fusion readout: node -> warp and warp -> graph masked means
    as four separate sums (``two_level_readout_ref`` in JAX)."""
    W = warp_graph.shape[0]
    nmask = node_mask.to(h.dtype)
    wsum = h.new_zeros(W, h.shape[1]).index_add_(0, warp_seg.long(),
                                                 h * nmask[:, None])
    # lint: allow[R4] counts: sums of 0/1 mask values, exact in any order
    wcnt = nmask.new_zeros(W).index_add_(0, warp_seg.long(), nmask)
    warp_mean = wsum / torch.clamp_min(wcnt, 1.0)[:, None]
    valid = (wcnt > 0).to(h.dtype)
    gsum = h.new_zeros(num_graphs, h.shape[1]).index_add_(
        0, warp_graph.long(), warp_mean * valid[:, None])
    # lint: allow[R4] counts: sums of 0/1 mask values, exact in any order
    gcnt = valid.new_zeros(num_graphs).index_add_(0, warp_graph.long(), valid)
    return gsum / torch.clamp_min(gcnt, 1.0)[:, None]


# ---------------------------------------------------------------------------
# Dense path (core/graphs.pad_batch layout: (B, N) nodes, (B, E) edges)
# ---------------------------------------------------------------------------

# lint: allow[R4] degree counts: sums of 0/1 mask values, exact in any order
def edge_norm_dense(dst, etype, emask, num_nodes: int,
                    num_relations: int) -> torch.Tensor:
    """Per-edge degree normalizer 1/|N_r(dst_e)| of each graph of a dense
    batch (B, E).  The degrees are sums of 0/1 mask values, exact in any
    order, so the result equals JAX's bit for bit."""
    key = dst.long() * num_relations + etype.long()
    deg = emask.new_zeros(dst.shape[0], int(num_nodes) * num_relations)
    deg.scatter_add_(1, key, emask)
    return 1.0 / torch.clamp_min(deg.gather(1, key), 1.0)


def _rgcn_layer(lp: RGCNLayer, rc: RGCNConfig, h, batch, wnorm,
                onehot_etype, csr, *, last: bool, keep=None,
                train: bool = False) -> torch.Tensor:
    coef = onehot_etype @ lp.comb                       # (B,E,nb) = comb[etype]
    w = (coef * wnorm[..., None]).contiguous()
    agg = rgcn_message_agg(_messages(rc, h), lp.basis, batch["edge_src"],
                           batch["edge_dst"], w, h.shape[1], csr=csr,
                           checked=False)
    return _layer_epilogue(lp, rc, agg, h, batch["node_mask"], last=last,
                           keep=keep, train=train)


def _dense_readout(h, node_mask, warp_id, max_warps: int) -> torch.Tensor:
    """Per graph: node -> warp masked mean, then the mean over the warps
    that hold a live node (JAX ``encode``'s segment sums), as one-hot
    matmuls so the backward is a fixed-order sum."""
    nmask = node_mask.to(h.dtype)
    onehot = torch.nn.functional.one_hot(
        warp_id.long(), int(max_warps)).to(h.dtype).transpose(1, 2)
    sums = onehot @ (h * nmask[..., None])              # (B,W,D)
    cnts = (onehot @ nmask[..., None])[..., 0]          # (B,W)
    warp_mean = sums / torch.clamp_min(cnts, 1.0)[..., None]
    valid = (cnts > 0).to(h.dtype)
    zsum = (valid[:, None, :] @ warp_mean)[:, 0]        # (B,D)
    return zsum / torch.clamp_min(valid.sum(1, keepdim=True), 1.0)


def encode(p: RGCNEncoder, rc: RGCNConfig, batch: dict, max_warps: int, *,
           draws: Optional[EncodeDraws] = None, train: bool = False,
           edges_checked: bool = False) -> torch.Tensor:
    """Dense batch (``pad_batch``'s arrays as tensors on one device) ->
    kernel embeddings z_k (B, dims[-1]); JAX ``encode``.

    ``train=True`` with ``draws``: dropout after the non-last layers and
    per-graph gated feature noise (noise (B, N, dims[0]), gate (B,)).  The
    degree normalizer is derived here from the batch's (or view's) edge
    mask; the destination CSR K6 walks is built once and shared by every
    layer.  ``edges_checked=True``: the caller validated the endpoints;
    otherwise they are checked here (one host sync on the card)."""
    N = batch["node_mask"].shape[1]
    src, dst, etype = batch["edge_src"], batch["edge_dst"], batch["edge_type"]
    if not edges_checked:
        check_endpoints(src, dst, N, "encode")
    h = rc.policy.cast_compute(node_features(p, rc, batch))     # (B,N,64)
    if draws is not None and draws.noise is not None \
            and draws.noise_gate is not None:
        h = apply_feature_noise(h, draws.noise, draws.noise_gate,
                                rc.feat_noise_sigma)
        h = h * batch["node_mask"].to(h.dtype)[..., None]
    emask = _relation_mask(rc, etype, batch["edge_mask"])
    norm = edge_norm_dense(dst, etype, emask, N, rc.num_relations)
    wnorm = (emask * norm).contiguous()                          # (B,E)
    onehot_etype = torch.nn.functional.one_hot(
        etype.long(), rc.num_relations).float()                  # (B,E,R)
    csr = dense_csr(dst, wnorm, N)
    keeps = draws.dropout if draws is not None else ()
    n_layers = len(p.layers)
    for li, lp in enumerate(p.layers):
        h = _rgcn_layer(lp, rc, h, batch, wnorm, onehot_etype, csr,
                        last=(li == n_layers - 1),
                        keep=keeps[li] if li < len(keeps) else None,
                        train=train)
    return _dense_readout(h, batch["node_mask"], batch["warp_id"], max_warps)


def project(p: RGCNEncoder, rc: RGCNConfig, zk: torch.Tensor, *,
            keep: Optional[torch.Tensor] = None,
            train: bool = False) -> torch.Tensor:
    """Projection head; in training, dropout after the hidden ReLU from
    the (G, proj_hidden) bool keep mask."""
    h = torch.relu(zk @ p.proj.w1 + p.proj.b1)
    if train and keep is not None and rc.dropout > 0:
        h = h * keep / (1 - rc.dropout)
    return h @ p.proj.w2 + p.proj.b2
