"""Inference half of the contrastive trainer: packed, micro-batched
embedding with a content-hash cache.  Counterpart of
``repro/core/train.py:738-930``.

``ContrastiveTrainer.embed`` / ``embed_stream`` turn kernel graphs into the
256-d kernel embeddings z_k (paper §3.4): graphs are packed into size
buckets (``core/batching.py``), uploaded to the trainer's device and encoded
by ``core/rgcn.encode_packed``; identical graphs (same content hash) are
encoded once.  ``fit`` (InfoNCE, augmentations, AdamW) arrives with the
training slice; the host-side staging runs inline (the JAX package's
one-ahead prefetch thread is not ported).
"""

from __future__ import annotations

import copy
import hashlib
import warnings
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core import rgcn as rgcn_mod
from repro_torch.core.batching import (
    MAX_EDGES_PER_MICROBATCH, MAX_NODES_PER_MICROBATCH, bucket_key,
    bucket_size, graph_content_hash, pack_graphs, plan_microbatches,
    stream_bins,
)
from repro_torch.core.graphs import KernelGraph
from repro_torch.core.rgcn import RGCNConfig, RGCNEncoder
from repro_torch.utils.device import resolve_device


@dataclass(frozen=True)
class GCLTrainConfig:
    """Training knobs the serving path reads (the seed feeds the planning
    engine's kmeans++ draws); the optimizer fields come with ``fit``."""
    seed: int = 0


def _params_fingerprint(params: RGCNEncoder) -> str:
    """Cheap content fingerprint of the encoder (the embedding cache is only
    valid for the params it was computed with): a prefix of every
    parameter's bytes, in name order."""
    h = hashlib.blake2b(digest_size=8)
    for name, leaf in sorted(params.state_dict().items()):
        h.update(name.encode())
        h.update(leaf.detach().cpu().numpy().tobytes()[:4096])
    return h.hexdigest()


class ContrastiveTrainer:
    def __init__(self, rc: RGCNConfig,
                 tc: Optional[GCLTrainConfig] = None, *, device=None):
        self.rc = rc
        self.tc = tc or GCLTrainConfig()
        self.device = resolve_device(device)
        self._embed_cache: dict[str, np.ndarray] = {}
        self._embed_cache_fp: Optional[str] = None
        self._encoder: Optional[RGCNEncoder] = None
        self._encoder_src: Optional[int] = None
        # LRU-evicted above this many entries (hits move to the tail)
        self.embed_cache_max = 65536
        self.embed_stats: dict = {}

    # -- inference ----------------------------------------------------------
    def _embed_setup(self, params: RGCNEncoder, n_cap: int, e_cap: int
                     ) -> RGCNEncoder:
        """The content cache is valid only for the (params, truncation caps)
        it was built with; a device copy of the encoder is made once per
        params object (the caller's module stays where it is)."""
        fp = f"{_params_fingerprint(params)}:{n_cap}:{e_cap}"
        if fp != self._embed_cache_fp:
            self._embed_cache.clear()
            self._embed_cache_fp = fp
            self._encoder = None
        if self._encoder is None or self._encoder_src != id(params):
            self._encoder = copy.deepcopy(params).to(self.device).eval()
            self._encoder_src = id(params)
        return self._encoder

    def _stage_bin(self, bin_graphs, n_cap, e_cap):
        """Pack + upload one micro-batch.  Per-graph caps truncate a single
        graph larger than the budget (with accounting) instead of letting
        it blow the bucket.  Returns (device batch, PackMeta, bucket key)."""
        packed, meta = pack_graphs(
            bin_graphs,
            pad_graphs_to=bucket_size(len(bin_graphs), 8),
            max_nodes_per_graph=n_cap, max_edges_per_graph=e_cap,
        )
        batch = {k: torch.from_numpy(v).to(self.device)
                 for k, v in packed.items()}
        return batch, meta, bucket_key(packed)

    def _encode(self, enc: RGCNEncoder, batch: dict) -> np.ndarray:
        with torch.inference_mode():
            z = rgcn_mod.encode_packed(enc, self.rc, batch)
        return z.float().cpu().numpy()

    def _embed_finish(self, label, hashes, stats):
        """Assemble rows from the cache, warn on truncation, LRU-evict,
        publish ``self.embed_stats``."""
        if stats["trunc_nodes"] or stats["trunc_edges"]:
            warnings.warn(
                f"{label} truncated {stats['trunc_nodes']} node(s) / "
                f"{stats['trunc_edges']} edge(s) over the micro-batch "
                f"budget; embeddings for the affected graphs are computed "
                f"on truncated graphs",
                stacklevel=3,
            )
        out = np.stack([self._embed_cache[h] for h in hashes]) if hashes \
            else np.zeros((0, self.rc.dims[-1]), np.float32)
        while len(self._embed_cache) > self.embed_cache_max:
            self._embed_cache.pop(next(iter(self._embed_cache)))
        self.embed_stats = {"graphs": len(hashes), **stats}
        return out

    def embed(self, params: RGCNEncoder, graphs: list[KernelGraph],
              batch_size=64, max_nodes=None, max_edges=None) -> np.ndarray:
        """256-d kernel embeddings for all graphs.  Micro-batched pass over
        size buckets with a content-hash cache: repeated kernel invocations
        (identical traces) are encoded once.  Stats land in
        ``self.embed_stats``."""
        n_cap = max_nodes or MAX_NODES_PER_MICROBATCH
        e_cap = max_edges or MAX_EDGES_PER_MICROBATCH
        enc = self._embed_setup(params, n_cap, e_cap)

        n = len(graphs)
        hashes = [graph_content_hash(g) for g in graphs]
        todo: list[int] = []
        scheduled: set[str] = set()
        for i, hsh in enumerate(hashes):
            if hsh in self._embed_cache:
                self._embed_cache[hsh] = self._embed_cache.pop(hsh)
            elif hsh not in scheduled:
                scheduled.add(hsh)
                todo.append(i)

        bucket_keys = set()
        trunc_nodes = trunc_edges = 0
        bins = plan_microbatches(
            [graphs[i] for i in todo],
            max_nodes=n_cap, max_edges=e_cap, max_graphs=batch_size,
        )
        for bin_idx in bins:
            sel = [todo[j] for j in bin_idx]
            batch, meta, bkey = self._stage_bin(
                [graphs[i] for i in sel], n_cap, e_cap)
            z = self._encode(enc, batch)
            trunc_nodes += int(meta.trunc_nodes.sum())
            trunc_edges += int(meta.trunc_edges.sum())
            bucket_keys.add(bkey)
            for k, i in enumerate(sel):
                self._embed_cache[hashes[i]] = z[k]

        return self._embed_finish("embed", hashes, {
            "cache_hits": n - len(todo),
            "encoded": len(todo),
            "microbatches": len(bins),
            "bucket_keys": sorted(bucket_keys),
            "trunc_nodes": trunc_nodes,
            "trunc_edges": trunc_edges,
        })

    def embed_stream(self, params: RGCNEncoder, graphs, batch_size=64,
                     max_nodes=None, max_edges=None) -> np.ndarray:
        """Streaming-iterator variant of ``embed``: consumes any iterable of
        KernelGraphs holding at most one micro-batch of graphs resident
        (arrival order, no global size sort)."""
        n_cap = max_nodes or MAX_NODES_PER_MICROBATCH
        e_cap = max_edges or MAX_EDGES_PER_MICROBATCH
        enc = self._embed_setup(params, n_cap, e_cap)

        order: list[str] = []
        scheduled: set[str] = set()
        cache_hits = 0

        def pending():
            nonlocal cache_hits
            for g in graphs:
                h = graph_content_hash(g)
                order.append(h)
                if h in self._embed_cache:
                    self._embed_cache[h] = self._embed_cache.pop(h)
                    cache_hits += 1
                    continue
                if h in scheduled:
                    cache_hits += 1
                    continue
                scheduled.add(h)
                yield (h, g)

        bucket_keys = set()
        trunc_nodes = trunc_edges = 0
        stream_stats: dict = {}
        for bin_items in stream_bins(
                pending(), lambda hg: (hg[1].n_nodes, hg[1].n_edges),
                max_nodes=n_cap, max_edges=e_cap, max_graphs=batch_size,
                stats=stream_stats):
            batch, meta, bkey = self._stage_bin(
                [g for _, g in bin_items], n_cap, e_cap)
            z = self._encode(enc, batch)
            trunc_nodes += int(meta.trunc_nodes.sum())
            trunc_edges += int(meta.trunc_edges.sum())
            bucket_keys.add(bkey)
            for k, (h, _) in enumerate(bin_items):
                self._embed_cache[h] = z[k]

        return self._embed_finish("embed_stream", order, {
            "cache_hits": cache_hits,
            "encoded": len(scheduled),
            "microbatches": stream_stats.pop("bins", 0),
            "bucket_keys": sorted(bucket_keys),
            "trunc_nodes": trunc_nodes,
            "trunc_edges": trunc_edges,
            "streaming": True,
            **stream_stats,
        })
