"""Copy of ``repro/core/batching.py`` for the PyTorch port (imports rewritten to
``repro_torch``; the port imports nothing of ``repro``).

Packed, bucketed graph batching (jraph-style) for the RGCN stack.

Dense `pad_batch` pads every graph in a batch to the batch-wide max
nodes/edges/warps, so one large kernel inflates the cost of every small one
and every new (N, E, W) combination triggers a fresh jit compile.  The packed
representation concatenates all graphs of a batch into ONE flat node array
and ONE flat edge array:

  node axis (P,): node_type / token / pc_norm / vstats / node_mask
                  graph_id  — segment id of the owning graph
                  warp_seg  — GLOBAL warp segment id (graph-offset warp ids)
  edge axis (Q,): edge_src / edge_dst (node-offset-shifted into the flat
                  node axis, sorted by edge_dst for the blocked SpMM kernel),
                  edge_type / edge_mask / edge_graph
                  edge_norm — hoisted per-edge degree normalizer
                  1/|N_r(dst_e)| (schema v2; h-independent, so computed once
                  here instead of per RGCN layer per step — DESIGN.md §12)
  warp axis (W,): warp_graph — graph id per warp segment (warp validity
                  is derived in the readout from per-warp node counts)
  graph axis (G,): graph_mask, trunc_nodes / trunc_edges accounting

Each axis is padded up to a small set of size BUCKETS (powers of two above a
floor), so the number of distinct jit-compiled shapes is bounded by the
bucket count instead of the dataset's shape diversity.  Padding rows carry
mask 0 and index 0; every consumer is masked, so segment-sums over padding
contribute nothing.

`unpack` is index bookkeeping only: graph g owns rows [node_off[g],
node_off[g] + n_nodes[g]) of the flat node axis, and row g of any per-graph
output (e.g. the (G, 256) kernel embeddings).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

from repro_torch.core.graphs import NUM_RELATIONS, KernelGraph

#: packed-batch dict schema version.  v2 added the precomputed ``edge_norm``
#: field; every consumer falls back to in-trace recomputation when the key
#: is absent (core/rgcn._rgcn_layer_packed), so v1 batches stay valid.
PACK_SCHEMA = 2

# Bucket floors: the smallest padded size per axis.  Everything above the
# floor rounds up to the next power of two, so #buckets per axis is
# log2(max/floor) + 1.
NODE_FLOOR = 256
EDGE_FLOOR = 512
WARP_FLOOR = 4

# Default micro-batch budgets for the streaming embed path.  MAX_NODES also
# bounds the flat Pallas kernel's VMEM residency: h (P, 128) f32 + the
# (P, nb*128) accumulator must fit on-chip (P = 4096 -> ~6 MB).
MAX_NODES_PER_MICROBATCH = 4096
MAX_EDGES_PER_MICROBATCH = 8192
MAX_GRAPHS_PER_MICROBATCH = 64


def bucket_size(n: int, floor: int) -> int:
    """Round n up to the next power-of-two bucket >= floor."""
    b = int(floor)
    while b < n:
        b *= 2
    return b


def bucket_key(batch) -> tuple[int, int, int, int]:
    """(P, Q, W, G) static shape key — jit retraces are bounded by the
    number of distinct keys."""
    return (
        batch["node_mask"].shape[0],
        batch["edge_mask"].shape[0],
        batch["warp_graph"].shape[0],
        batch["graph_mask"].shape[0],
    )


@dataclass(frozen=True)
class PackMeta:
    """Host-side bookkeeping to unpack per-graph results.

    node_off/warp_off slice the flat node/warp axes per graph.  The flat
    EDGE arrays are dst-sorted across the whole batch, so graph g's edges
    are NOT contiguous — select them with `batch['edge_graph'] == g`;
    `edge_off` only gives per-graph edge COUNTS (edge_off[g+1]-edge_off[g]).
    """
    n_graphs: int
    node_off: np.ndarray   # (G+1,) node offsets into the flat axis
    edge_off: np.ndarray   # (G+1,) cumulative per-graph edge counts (pre-sort)
    warp_off: np.ndarray   # (G+1,)
    trunc_nodes: np.ndarray  # (G,) nodes dropped by per-graph caps
    trunc_edges: np.ndarray  # (G,)


def pack_graphs(
    graphs: list[KernelGraph],
    *,
    bucket: bool = True,
    pad_graphs_to: int | None = None,
    max_nodes_per_graph: int | None = None,
    max_edges_per_graph: int | None = None,
):
    """Pack a list of KernelGraphs into one flat (numpy) batch.

    Returns (batch dict, PackMeta).  With `bucket`, the node/edge/warp axes
    are padded to power-of-two buckets; the graph axis is left exact unless
    `pad_graphs_to` is given (training keeps G == batch_size so the InfoNCE
    logits never see padding graphs; embed pads G per micro-batch bucket).
    """
    G = len(graphs)
    assert G > 0, "pack_graphs needs at least one graph"

    n_nodes = np.empty(G, np.int64)
    n_edges = np.empty(G, np.int64)
    n_warps = np.empty(G, np.int64)
    trunc_n = np.zeros(G, np.int64)
    trunc_e = np.zeros(G, np.int64)
    parts = []
    for gi, g in enumerate(graphs):
        n, e = g.n_nodes, g.n_edges
        if max_nodes_per_graph is not None and n > max_nodes_per_graph:
            trunc_n[gi] = n - max_nodes_per_graph
            n = max_nodes_per_graph
        src, dst, et = g.edge_src, g.edge_dst, g.edge_type
        if n < g.n_nodes:  # drop edges touching truncated nodes
            keep = (src < n) & (dst < n)
            src, dst, et = src[keep], dst[keep], et[keep]
            trunc_e[gi] += g.n_edges - len(src)
            e = len(src)
        if max_edges_per_graph is not None and e > max_edges_per_graph:
            trunc_e[gi] += e - max_edges_per_graph
            src = src[:max_edges_per_graph]
            dst = dst[:max_edges_per_graph]
            et = et[:max_edges_per_graph]
            e = max_edges_per_graph
        n_nodes[gi], n_edges[gi], n_warps[gi] = n, e, g.n_warps
        parts.append((n, src, dst, et))

    node_off = np.concatenate([[0], np.cumsum(n_nodes)])
    edge_off = np.concatenate([[0], np.cumsum(n_edges)])
    warp_off = np.concatenate([[0], np.cumsum(n_warps)])
    P_used, Q_used, W_used = int(node_off[-1]), int(edge_off[-1]), int(warp_off[-1])

    if bucket:
        P = bucket_size(P_used, NODE_FLOOR)
        Q = bucket_size(max(Q_used, 1), EDGE_FLOOR)
        W = bucket_size(max(W_used, 1), WARP_FLOOR)
    else:
        P, Q, W = P_used, max(Q_used, 1), max(W_used, 1)
    Gp = pad_graphs_to or G
    assert Gp >= G, (Gp, G)

    batch = {
        "node_type": np.zeros(P, np.int32),
        "token": np.zeros(P, np.int32),
        "pc_norm": np.zeros(P, np.float32),
        "vstats": np.zeros((P, 8), np.float32),
        "graph_id": np.zeros(P, np.int32),
        "warp_seg": np.zeros(P, np.int32),
        "node_mask": np.zeros(P, np.float32),
        "edge_src": np.zeros(Q, np.int32),
        "edge_dst": np.zeros(Q, np.int32),
        "edge_type": np.zeros(Q, np.int32),
        "edge_graph": np.zeros(Q, np.int32),
        "edge_mask": np.zeros(Q, np.float32),
        "warp_graph": np.zeros(W, np.int32),
        "graph_mask": np.zeros(Gp, np.float32),
        "trunc_nodes": np.zeros(Gp, np.int32),
        "trunc_edges": np.zeros(Gp, np.int32),
    }

    for gi, g in enumerate(graphs):
        n, src, dst, et = parts[gi]
        no, eo, wo = int(node_off[gi]), int(edge_off[gi]), int(warp_off[gi])
        sl = slice(no, no + n)
        batch["node_type"][sl] = g.node_type[:n]
        batch["token"][sl] = g.token[:n]
        batch["pc_norm"][sl] = g.pc_norm[:n]
        batch["vstats"][sl] = g.vstats[:n]
        batch["graph_id"][sl] = gi
        batch["warp_seg"][sl] = g.warp_id[:n].astype(np.int32) + wo
        batch["node_mask"][sl] = 1.0
        e = len(src)
        el = slice(eo, eo + e)
        batch["edge_src"][el] = src.astype(np.int32) + no
        batch["edge_dst"][el] = dst.astype(np.int32) + no
        batch["edge_type"][el] = et
        batch["edge_graph"][el] = gi
        batch["edge_mask"][el] = 1.0
        wl = slice(wo, wo + g.n_warps)
        batch["warp_graph"][wl] = gi
    batch["graph_mask"][:G] = 1.0
    batch["trunc_nodes"][:G] = trunc_n
    batch["trunc_edges"][:G] = trunc_e

    # sort the used prefix of the edge list by destination: the blocked SpMM
    # kernel streams edge blocks whose dst indices are then near-contiguous,
    # and the accumulation order becomes deterministic
    order = np.argsort(batch["edge_dst"][:Q_used], kind="stable")
    for k in ("edge_src", "edge_dst", "edge_type", "edge_graph", "edge_mask"):
        batch[k][:Q_used] = batch[k][:Q_used][order]

    # hoisted degree normalizer 1/|N_r(v)| (schema v2, DESIGN.md §12):
    # structure-only, so it is derived ONCE here instead of per layer per
    # step in-trace.  Bit-identical to core/rgcn.edge_norm_packed (integer-
    # valued mask sums + the same 1/max IEEE division); padding rows (mask 0)
    # get the same formula so the jnp twin matches on every element.
    key = batch["edge_dst"].astype(np.int64) * NUM_RELATIONS + batch["edge_type"]
    deg = np.zeros(P * NUM_RELATIONS, np.float32)
    np.add.at(deg, key, batch["edge_mask"])
    batch["edge_norm"] = np.float32(1.0) / np.maximum(deg[key], np.float32(1.0))

    meta = PackMeta(
        n_graphs=G, node_off=node_off, edge_off=edge_off, warp_off=warp_off,
        trunc_nodes=trunc_n, trunc_edges=trunc_e,
    )
    return batch, meta


@dataclass(frozen=True)
class EpochSegment:
    """A maximal run of CONSECUTIVE training steps whose packed batches share
    one bucket key, with the per-step batches stacked along a new leading
    step axis — ready to become `jax.lax.scan` xs after one device upload.
    Step order is preserved exactly (the optimizer state evolves
    sequentially), so segments never reorder steps across bucket flips."""
    start: int                     # first step (absolute index in the epoch)
    stop: int                      # one past the last step
    key: tuple                     # bucket_key shared by every step
    batches: dict                  # field -> np.ndarray of shape (stop-start, ...)

    def __len__(self) -> int:
        return self.stop - self.start


@dataclass(frozen=True)
class EpochPlan:
    """Host-side epoch schedule built by `plan_epoch` (DESIGN.md §4): every
    step's batch packed up front, grouped into same-bucket segments.  The
    trainer stages each segment to the device ONCE and drives it with a
    compiled multi-step scan instead of a per-step pack -> upload -> sync
    round-trip."""
    n_steps: int
    selections: np.ndarray         # (n_steps, batch_size) graph indices
    segments: tuple                # EpochSegments covering [0, n_steps)
    bucket_keys: tuple             # sorted distinct bucket keys
    trunc_nodes: int               # total nodes truncated by per-graph caps


def plan_epoch(
    graphs: list[KernelGraph],
    selections: np.ndarray,
    *,
    max_nodes_per_graph: int | None = None,
    max_edges_per_graph: int | None = None,
) -> EpochPlan:
    """Pack every step of an epoch and group consecutive same-bucket steps.

    `selections` is the (steps, batch_size) matrix of graph indices (one row
    per training step, drawn ahead of time so the schedule is deterministic
    given the seed — the resume protocol replays it exactly).  Bucketing
    keeps the number of distinct stacked shapes — and hence scan compiles —
    bounded by the bucket count, not the step count.
    """
    selections = np.asarray(selections)
    steps = []
    trunc_total = 0
    for sel in selections:
        packed, meta = pack_graphs(
            [graphs[i] for i in sel],
            max_nodes_per_graph=max_nodes_per_graph,
            max_edges_per_graph=max_edges_per_graph,
        )
        trunc_total += int(meta.trunc_nodes.sum())
        steps.append((bucket_key(packed), packed))

    segments: list[EpochSegment] = []
    start = 0
    while start < len(steps):
        key = steps[start][0]
        stop = start + 1
        while stop < len(steps) and steps[stop][0] == key:
            stop += 1
        stacked = {
            f: np.stack([steps[t][1][f] for t in range(start, stop)])
            for f in steps[start][1]
        }
        segments.append(EpochSegment(start=start, stop=stop, key=key,
                                     batches=stacked))
        start = stop
    return EpochPlan(
        n_steps=len(steps), selections=selections, segments=tuple(segments),
        bucket_keys=tuple(sorted({k for k, _ in steps})),
        trunc_nodes=trunc_total,
    )


def plan_microbatches(
    graphs: list[KernelGraph],
    *,
    max_nodes: int = MAX_NODES_PER_MICROBATCH,
    max_edges: int = MAX_EDGES_PER_MICROBATCH,
    max_graphs: int = MAX_GRAPHS_PER_MICROBATCH,
) -> list[list[int]]:
    """Greedy size-sorted binning of graph indices into micro-batches whose
    packed totals respect the node/edge/graph budgets.  Sorting by size keeps
    same-bucket graphs together, minimizing distinct bucket keys."""
    order = sorted(
        range(len(graphs)), key=lambda i: (graphs[i].n_nodes, graphs[i].n_edges)
    )
    bins: list[list[int]] = []
    cur: list[int] = []
    cn = ce = 0
    for i in order:
        g = graphs[i]
        gn = min(g.n_nodes, max_nodes)
        ge = min(g.n_edges, max_edges)
        if cur and (cn + gn > max_nodes or ce + ge > max_edges
                    or len(cur) >= max_graphs):
            bins.append(cur)
            cur, cn, ce = [], 0, 0
        cur.append(i)
        cn += gn
        ce += ge
    if cur:
        bins.append(cur)
    return bins


def stream_bins(
    items,
    size_fn,
    *,
    max_nodes: int = MAX_NODES_PER_MICROBATCH,
    max_edges: int = MAX_EDGES_PER_MICROBATCH,
    max_graphs: int = MAX_GRAPHS_PER_MICROBATCH,
    stats: dict | None = None,
):
    """Greedy micro-batch binning over an ITERATOR of items.

    The streaming counterpart of `plan_microbatches`: items arrive one at a
    time (no global size-sort is possible), are buffered until the packed
    budgets would overflow, and each full bin is yielded before the next item
    is buffered — so at most ONE bin of items is ever resident.  `size_fn`
    maps an item to (n_nodes, n_edges); per-item sizes are clamped to the
    budgets (oversized graphs are truncated downstream by `pack_graphs`).

    When `stats` is given it accumulates: peak_resident_graphs /
    peak_resident_nodes / peak_resident_edges — the TRUE (unclamped) sizes
    of what is buffered, so a single oversized graph shows up honestly even
    though the budget decision clamps it (truncation to the budget happens
    downstream in `pack_graphs`) — and bins.
    """
    buf: list = []
    bn = be = 0          # budget-clamped running sums (flush decision)
    rn = re_ = 0         # true resident sums (stats)
    peak_g = peak_n = peak_e = bins = 0
    for item in items:
        n, e = size_fn(item)
        gn, ge = min(int(n), max_nodes), min(int(e), max_edges)
        if buf and (bn + gn > max_nodes or be + ge > max_edges
                    or len(buf) >= max_graphs):
            bins += 1
            yield buf
            buf, bn, be, rn, re_ = [], 0, 0, 0, 0
        buf.append(item)
        bn += gn
        be += ge
        rn += int(n)
        re_ += int(e)
        peak_g = max(peak_g, len(buf))
        peak_n = max(peak_n, rn)
        peak_e = max(peak_e, re_)
    if buf:
        bins += 1
        yield buf
    if stats is not None:
        stats.update(
            peak_resident_graphs=peak_g, peak_resident_nodes=peak_n,
            peak_resident_edges=peak_e, bins=bins,
        )


def graph_content_hash(g: KernelGraph) -> str:
    """Content hash of a kernel graph — identical repeated invocations hash
    equal, so the embedding cache encodes each distinct kernel once."""
    h = hashlib.blake2b(digest_size=16)
    for a in (g.node_type, g.token, g.pc_norm, g.vstats, g.warp_id,
              g.edge_src, g.edge_dst, g.edge_type):
        h.update(np.ascontiguousarray(a).tobytes())
        h.update(str(a.shape).encode())
    h.update(str(g.n_warps).encode())
    return h.hexdigest()
