"""RGCN encoder with basis decomposition + projection head (paper §3.3.2),
packed inference path.  Counterpart of ``repro/core/rgcn.py:56-363``.

Architecture: 3 relational conv layers (64 -> 128 -> 128 -> 256), basis
decomposition per layer, LayerNorm + ReLU, mean-pool readout to warp
embeddings, warp mean to the kernel embedding z_k in R^256; projection
head 256 -> 128 (ReLU) -> 64.  Node features are built in-model (paper
§3.3.1).

The encoder is an ``nn.Module`` whose parameters keep the JAX pytree's
names (``repro_torch.interop`` maps one onto the other).  Message passing
goes through ``kernels.rgcn_fused`` (K1): the hand-written kernel for CUDA
tensors, its plain version for CPU tensors.  ``h @ w0`` and the projection
head are ``torch.matmul``, as the JAX package leaves those to XLA.

This slice serves inference: no dropout, no augmentation, no feature
noise.  The dense ``encode`` and the unfused ``rgcn_spmm`` branch of the
original come with later slices.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
from torch import nn

from repro_torch.core.graphs import NUM_RELATIONS
from repro_torch.core.precision import Policy
from repro_torch.kernels.rgcn_fused.ops import (
    fused_two_level_readout, rgcn_fused_agg_flat,
)
from repro_torch.tracing.isa import NUM_OPCODES, PSEUDO_KINDS, VAR_KINDS


@dataclass(frozen=True)
class RGCNConfig:
    dims: tuple = (64, 128, 128, 256)
    num_bases: int = 2
    num_relations: int = NUM_RELATIONS
    proj_hidden: int = 128
    proj_out: int = 64
    #: activations (and K1's gathered messages) run in the policy's compute
    #: dtype; LayerNorm statistics and the readout stay float32
    policy: Policy = field(default_factory=Policy)


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


def _positional_encoding(pc_norm: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal PE of normalized PC (...,) -> (..., dim)."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32,
                                   device=pc_norm.device)
                      * (-math.log(10_000.0) / half))
    ang = pc_norm[..., None] * 1000.0 * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _stats_encode(vstats: torch.Tensor) -> torch.Tensor:
    return torch.sign(vstats) * torch.sqrt(torch.abs(vstats)) * 0.3


def node_features(p: RGCNEncoder, rc: RGCNConfig, batch: dict
                  ) -> torch.Tensor:
    tok = batch["token"].long()
    ntype = batch["node_type"]
    instr = p.embed_instr[torch.clamp(tok, 0, NUM_OPCODES - 1)]
    instr = instr + _positional_encoding(batch["pc_norm"], 64)
    var32 = p.embed_var[torch.clamp(tok, 0, len(VAR_KINDS) - 1)]
    vstats = batch["vstats"]
    var = torch.cat([var32, _stats_encode(vstats),
                     var32.new_zeros(var32.shape[:-1] + (64 - 40,))], dim=-1)
    pse16 = p.embed_pseudo[torch.clamp(tok, 0, len(PSEUDO_KINDS) - 1)]
    pseudo = torch.cat([pse16, pse16.new_zeros(pse16.shape[:-1] + (48,))],
                       dim=-1)
    h = torch.where((ntype == 0)[..., None], instr,
                    torch.where((ntype == 1)[..., None], pseudo, var))
    return h * batch["node_mask"][..., None]


def _layer_epilogue(lp: RGCNLayer, rc: RGCNConfig, agg, h, node_mask, *,
                    last: bool) -> torch.Tensor:
    """Self-loop + LayerNorm (population variance, eps 1e-5) + ReLU +
    node mask; cast back to the compute dtype except after the last layer,
    whose output feeds the f32 readout."""
    out = agg + h @ lp.w0.to(h.dtype) + lp.b
    out = out.float()
    mu = out.mean(-1, keepdim=True)
    sig = ((out - mu) ** 2).mean(-1, keepdim=True)
    out = (out - mu) * torch.rsqrt(sig + 1e-5) * lp.ln_scale + lp.ln_bias
    out = torch.relu(out)
    out = out * node_mask[..., None]
    return out if last else rc.policy.cast_compute(out)


def edge_norm_packed(dst, etype, emask, num_nodes: int,
                     num_relations: int) -> torch.Tensor:
    """Per-edge degree normalizer 1/|N_r(dst_e)| for a packed batch (the
    in-graph fallback for batches without the hoisted ``edge_norm``)."""
    key = dst.long() * num_relations + etype.long()
    deg = torch.zeros(num_nodes * num_relations, dtype=emask.dtype,
                      device=emask.device)
    deg.index_add_(0, key, emask)
    return 1.0 / torch.clamp_min(deg[key], 1.0)


def _rgcn_layer_packed(lp: RGCNLayer, rc: RGCNConfig, h, batch, *,
                       last: bool) -> torch.Tensor:
    P = h.shape[0]
    src, dst, etype = batch["edge_src"], batch["edge_dst"], batch["edge_type"]
    emask = batch["edge_mask"]
    norm = batch.get("edge_norm")
    if norm is None:
        norm = edge_norm_packed(dst, etype, emask, P, rc.num_relations)
    wnorm = (emask * norm).contiguous()                 # (Q,)
    coef = lp.comb[etype.long()].contiguous()           # (Q,nb)
    agg = rgcn_fused_agg_flat(h.contiguous(),
                              lp.basis.contiguous(), src, dst, coef, wnorm, P)
    return _layer_epilogue(lp, rc, agg, h, batch["node_mask"], last=last)


def encode_packed(p: RGCNEncoder, rc: RGCNConfig, batch: dict
                  ) -> torch.Tensor:
    """Packed batch (tensors on one device) -> kernel embeddings z_k
    (G, dims[-1]); padding graphs (graph_mask == 0) give zero rows."""
    h = rc.policy.cast_compute(node_features(p, rc, batch))     # (P, 64)
    for li, lp in enumerate(p.layers):
        h = _rgcn_layer_packed(lp, rc, h, batch,
                               last=(li == len(p.layers) - 1))
    G = batch["graph_mask"].shape[0]
    return fused_two_level_readout(h, batch["node_mask"], batch["warp_seg"],
                                   batch["warp_graph"], G)


def project(p: RGCNEncoder, rc: RGCNConfig, zk: torch.Tensor
            ) -> torch.Tensor:
    """Projection head (inference: no dropout)."""
    h = torch.relu(zk @ p.proj.w1 + p.proj.b1)
    return h @ p.proj.w2 + p.proj.b2
