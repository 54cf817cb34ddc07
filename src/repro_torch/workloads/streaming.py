"""Copy of ``repro/workloads/streaming.py`` for the PyTorch port (imports rewritten to
``repro_torch``; the port imports nothing of ``repro``).

Streaming trace -> graph ingestion.

Scenario populations can reach hundreds of programs x thousands of
invocations; materializing every trace and every KernelGraph before packing
would hold the whole population in memory.  This module keeps the expensive
stages lazy end-to-end:

    Program.kernels (lightweight specs)
      --iter_program_graphs-->  KernelGraph, one at a time (trace built,
                                graph built, trace dropped)
      --stream_pack-->          packed bucket batches, at most ONE
                                micro-batch of graphs resident
      --ContrastiveTrainer.embed_stream-->  embeddings (content-hash cached)

Peak resident graphs are bounded by one micro-batch budget
(`core.batching.MAX_*_PER_MICROBATCH`), asserted in tests/test_workloads.py.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

from repro_torch.core.batching import (
    MAX_EDGES_PER_MICROBATCH, MAX_GRAPHS_PER_MICROBATCH,
    MAX_NODES_PER_MICROBATCH, bucket_size, pack_graphs, stream_bins,
)
from repro_torch.core.graphs import KernelGraph, iter_kernel_graphs

def iter_program_graphs(program, cap_warps=None, cap_instr=None, *,
                        engine=None):
    """Canonical lazy trace->graph generator (the ingestion entry point).

    Default: the sequential per-invocation path (`core.graphs`).  Pass an
    `repro_torch.ingest.IngestEngine` to ingest through the parallel cache-backed
    path instead — same order, same bits, bounded residency either way.
    Omitted caps resolve per program (`repro_torch.config.resolve_trace_caps`)."""
    if engine is not None:
        return engine.iter_graphs(program, cap_warps, cap_instr)
    return iter_kernel_graphs(program, cap_warps, cap_instr)


def stream_pack(
    graphs: Iterable[KernelGraph],
    *,
    max_nodes: int = MAX_NODES_PER_MICROBATCH,
    max_edges: int = MAX_EDGES_PER_MICROBATCH,
    max_graphs: int = MAX_GRAPHS_PER_MICROBATCH,
    stats: dict | None = None,
):
    """Yield (packed batch, PackMeta, graphs) bucket-by-bucket from a graph
    iterator.  The graph axis is padded to a small power-of-two bucket so
    downstream jit retraces stay bounded; per-graph node/edge caps keep a
    single oversized graph from blowing the bucket (truncation is accounted
    in PackMeta)."""
    for bin_graphs in stream_bins(
            graphs, lambda g: (g.n_nodes, g.n_edges), max_nodes=max_nodes,
            max_edges=max_edges, max_graphs=max_graphs, stats=stats):
        batch, meta = pack_graphs(
            bin_graphs,
            pad_graphs_to=bucket_size(len(bin_graphs), 8),
            max_nodes_per_graph=max_nodes,
            max_edges_per_graph=max_edges,
        )
        yield batch, meta, bin_graphs


def materialized_peak(graphs: list[KernelGraph]) -> dict:
    """Peak residency of the non-streaming path (everything at once) — the
    benchmark baseline for the streaming comparison."""
    return {
        "peak_resident_graphs": len(graphs),
        "peak_resident_nodes": int(np.sum([g.n_nodes for g in graphs])),
        "peak_resident_edges": int(np.sum([g.n_edges for g in graphs])),
    }
