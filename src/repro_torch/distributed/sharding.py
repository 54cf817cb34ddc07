"""Data-parallel sharding of a packed graph batch (the data-parallel half
of ``repro/distributed/sharding.py``).

JAX stages a packed batch onto its mesh with ``shard_batch_put``, splitting
every flat node / edge / warp / graph axis evenly and letting GSPMD handle
the graphs that straddle a shard.  The port runs one process per rank, so
:func:`shard_batch` gives a rank a contiguous range of WHOLE graphs instead:
that range's node, edge and warp rows, with the ``edge_src`` / ``edge_dst``
/ ``warp_seg`` offsets and the graph ids rebased, padded to power-of-two
buckets as ``core/batching.pack_graphs`` pads (the batch ``pack_graphs``
would make of those graphs).  Every layer of the encoder works per node or
per graph (its layer norm is over features, the readout per graph, the
augmentations draw per node, edge or graph), so the math is that of the
whole batch.  Ranks take ``ceil(G / W)`` graphs each, padding graphs
included, so the last ranks may hold fewer graphs, or none: the
counterpart of JAX's pad-or-skip rule for sizes that do not divide
(``batch_put_spec``).  A rank with no graph still joins every collective.

The parameter half of the JAX module (``MeshRules`` parameter specs,
``spec_for``, ``make_rules``) shards models over a (data, model) mesh and
comes with the LM slice that shards the zoo over several cards (ROADMAP
A9c).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.core.batching import (
    EDGE_FLOOR, NODE_FLOOR, WARP_FLOOR, bucket_size,
)
from repro_torch.core.graphs import NUM_RELATIONS

#: logical axis names for every field of a packed graph batch (a copy of
#: JAX's): the flat node / edge / warp / graph axes are the data-parallel
#: 'batch' axis
PACKED_BATCH_AXES: dict[str, tuple] = {
    "node_type": ("batch",),
    "token": ("batch",),
    "pc_norm": ("batch",),
    "vstats": ("batch", None),
    "graph_id": ("batch",),
    "warp_seg": ("batch",),
    "node_mask": ("batch",),
    "edge_src": ("batch",),
    "edge_dst": ("batch",),
    "edge_type": ("batch",),
    "edge_graph": ("batch",),
    "edge_mask": ("batch",),
    "edge_norm": ("batch",),
    "warp_graph": ("batch",),
    "graph_mask": ("batch",),
    "trunc_nodes": ("batch",),
    "trunc_edges": ("batch",),
}

#: which flat axis each field's rows run along
_NODE = ("node_type", "token", "pc_norm", "vstats", "graph_id", "warp_seg",
         "node_mask")
_EDGE = ("edge_src", "edge_dst", "edge_type", "edge_graph", "edge_mask",
         "edge_norm")
_WARP = ("warp_graph",)
_GRAPH = ("graph_mask", "trunc_nodes", "trunc_edges")


class ShardRange(NamedTuple):
    """A rank's rows of a packed batch: [lo, hi) along each flat axis of
    the whole batch, and the padded lengths of its own batch."""
    graphs: tuple
    nodes: tuple
    edges: tuple
    warps: tuple
    P: int            # its node rows, padded
    Q: int            # its edge rows, padded
    W: int            # its warp rows, padded

    @property
    def n_graphs(self) -> int:
        return self.graphs[1] - self.graphs[0]


def shard_ranges(packed: dict, rank: int, world: int) -> ShardRange:
    """Rank ``rank`` of ``world``'s contiguous range of whole graphs of a
    packed batch (host arrays as ``pack_graphs`` makes them: the real
    nodes and edges a prefix, in graph order)."""
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a group of {world}")
    G = packed["graph_mask"].shape[0]
    P = packed["node_mask"].shape[0]
    Q = packed["edge_mask"].shape[0]
    W = packed["warp_graph"].shape[0]
    if world == 1:
        return ShardRange((0, G), (0, P), (0, Q), (0, W), P, Q, W)
    per = -(-G // world)
    g0 = min(rank * per, G)
    g1 = min(g0 + per, G)
    p_used = int(np.count_nonzero(packed["node_mask"]))
    q_used = int(np.count_nonzero(packed["edge_mask"]))
    wg = packed["warp_graph"]
    # the real warps are a prefix, graph ids ascending; the padding rows
    # after them hold graph 0, so the prefix ends after the last nonzero id
    # (with one real graph every row is graph 0's)
    nz = np.flatnonzero(wg)
    w_used = int(nz[-1]) + 1 if len(nz) else W

    def span(ids, used):
        lo, hi = np.searchsorted(ids[:used], [g0, g1], side="left")
        return int(lo), int(hi)

    nodes = span(packed["graph_id"], p_used)
    edges = span(packed["edge_graph"], q_used)
    warps = span(wg, w_used)
    return ShardRange(
        (g0, g1), nodes, edges, warps,
        bucket_size(nodes[1] - nodes[0], NODE_FLOOR),
        bucket_size(max(edges[1] - edges[0], 1), EDGE_FLOOR),
        bucket_size(max(warps[1] - warps[0], 1), WARP_FLOOR))


def _rows(a: np.ndarray, lo: int, hi: int, n: int) -> np.ndarray:
    out = np.zeros((n,) + a.shape[1:], a.dtype)
    out[:hi - lo] = a[lo:hi]
    return out


def shard_batch(packed: dict, rank: int, world: int) -> dict:
    """Rank ``rank`` of ``world``'s packed batch (host arrays): its range
    of whole graphs (:func:`shard_ranges`), offsets and graph ids rebased,
    padded as ``pack_graphs`` pads, the degree normalizer re-derived from
    its own rows (equal on its real edges).  One rank gets the batch as it
    is."""
    if world == 1:
        return dict(packed)
    r = shard_ranges(packed, rank, world)
    axes = {**{k: (r.nodes, r.P) for k in _NODE},
            **{k: (r.edges, r.Q) for k in _EDGE},
            **{k: (r.warps, r.W) for k in _WARP},
            **{k: (r.graphs, r.n_graphs) for k in _GRAPH}}
    out = {}
    for k, a in packed.items():
        (lo, hi), n = axes[k]
        out[k] = _rows(a, lo, hi, n)
    rebase = {"graph_id": r.graphs[0], "edge_graph": r.graphs[0],
              "warp_graph": r.graphs[0], "edge_src": r.nodes[0],
              "edge_dst": r.nodes[0], "warp_seg": r.warps[0]}
    for k, off in rebase.items():
        (lo, hi), _ = axes[k]
        out[k][:hi - lo] -= off
    if "edge_norm" in out:
        key = (out["edge_dst"].astype(np.int64) * NUM_RELATIONS
               + out["edge_type"])
        deg = np.zeros(r.P * NUM_RELATIONS, np.float32)
        np.add.at(deg, key, out["edge_mask"])
        out["edge_norm"] = (np.float32(1.0)
                            / np.maximum(deg[key], np.float32(1.0)))
    return out
