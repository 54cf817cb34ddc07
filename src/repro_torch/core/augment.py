"""Graph augmentation pool (paper §3.3.1): node dropping (15 %), edge
dropping (15 %), feature noise (sigma = 0.01); each graph of a view gets
one or two of the three strategies.  Counterpart of
``repro/core/augment.py``: ``augment_view`` / ``apply_feature_noise`` on
dense ``pad_batch`` batches, the ``*_packed`` variants on packed ones.

The random draws are split from their application: the functions here take
the strategy choice, the keep masks and the noise as tensors
(``core/train.draw_view`` makes them from a ``torch.Generator``; the
parity tests make them from JAX's key tree), so the same draws give the
same view on every device.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from repro_torch.core.graphs import NUM_RELATIONS

NODE_DROP_RATE = 0.15
EDGE_DROP_RATE = 0.15

# the 6 subsets of {node_drop, edge_drop, noise} of size 1 or 2
COMBOS = ((1, 0, 0), (0, 1, 0), (0, 0, 1),
          (1, 1, 0), (1, 0, 1), (0, 1, 1))


@lru_cache(maxsize=None)
def _combos(device: torch.device) -> torch.Tensor:
    """COMBOS as a (6, 3) float32 tensor, uploaded once per device."""
    return torch.tensor(COMBOS, dtype=torch.float32, device=device)


def augment_view(batch: dict, combo: torch.Tensor, node_keep: torch.Tensor,
                 edge_keep: torch.Tensor):
    """Returns (view batch, use_noise (B,) float32) for a dense batch.
    combo (B,) int in [0, 6); node_keep (B, N) / edge_keep (B, E) bool: the
    Bernoulli(0.85) draws, applied only to graphs whose subset holds node /
    edge dropping.  The view carries no degree normalizer: the dense encoder
    derives it from the view's edge mask."""
    flags = _combos(batch["node_mask"].device)[combo.long()]   # (B,3)
    node_keep = torch.where(flags[:, 0:1] > 0, node_keep, True)
    edge_keep = torch.where(flags[:, 1:2] > 0, edge_keep, True)
    node_mask = batch["node_mask"] * node_keep
    src_keep = torch.gather(node_mask, 1, batch["edge_src"].long())
    dst_keep = torch.gather(node_mask, 1, batch["edge_dst"].long())
    edge_mask = batch["edge_mask"] * edge_keep * src_keep * dst_keep
    out = dict(batch)
    out["node_mask"] = node_mask
    out["edge_mask"] = edge_mask
    return out, flags[:, 2]


def apply_feature_noise(h: torch.Tensor, noise: torch.Tensor,
                        use_noise: torch.Tensor,
                        sigma: float) -> torch.Tensor:
    """Per-graph gated Gaussian feature noise on dense (B, N, D) features;
    ``noise`` is the standard-normal draw (B, N, D) in h's dtype."""
    return h + (sigma * noise) * use_noise.to(h.dtype)[:, None, None]


def augment_view_packed(batch: dict, combo: torch.Tensor,
                        node_keep: torch.Tensor, edge_keep: torch.Tensor):
    """Returns (view batch, use_noise (G,) float32).  combo (G,) int in
    [0, 6): each graph's strategy subset; node_keep (P,) / edge_keep (Q,)
    bool: the Bernoulli(0.85) draws, applied only to graphs whose subset
    holds node / edge dropping.  The view's degree normalizer is re-derived
    from its edge mask."""
    from repro_torch.core.rgcn import edge_norm_packed

    P = batch["node_mask"].shape[0]
    flags = _combos(batch["node_mask"].device)[combo.long()]   # (G,3)
    node_keep = torch.where(flags[batch["graph_id"].long(), 0] > 0,
                            node_keep, True)
    edge_keep = torch.where(flags[batch["edge_graph"].long(), 1] > 0,
                            edge_keep, True)
    node_mask = batch["node_mask"] * node_keep
    src_keep = node_mask[batch["edge_src"].long()]
    dst_keep = node_mask[batch["edge_dst"].long()]
    edge_mask = batch["edge_mask"] * edge_keep * src_keep * dst_keep
    out = dict(batch)
    out["node_mask"] = node_mask
    out["edge_mask"] = edge_mask
    if "edge_norm" in batch:
        out["edge_norm"] = edge_norm_packed(
            batch["edge_dst"], batch["edge_type"], edge_mask, P,
            NUM_RELATIONS)
    return out, flags[:, 2]


def apply_feature_noise_packed(h: torch.Tensor, noise: torch.Tensor,
                               use_noise: torch.Tensor,
                               graph_id: torch.Tensor,
                               sigma: float) -> torch.Tensor:
    """Per-graph gated Gaussian feature noise on flat (P, D) features;
    ``noise`` is the standard-normal draw (P, D) in h's dtype."""
    return h + (sigma * noise) * use_noise[graph_id.long()].to(h.dtype)[:, None]
