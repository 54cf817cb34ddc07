"""Copy of ``repro/ingest/engine.py`` for the PyTorch port (imports rewritten to
``repro_torch``; the port imports nothing of ``repro``).

Worker-pool trace->graph ingestion with deterministic output order.

`IngestEngine.iter_graphs` is a drop-in replacement for
`core.graphs.iter_kernel_graphs`: it yields one built `KernelGraph` per
kernel invocation IN PROGRAM ORDER, but traces up to ``workers`` kernels
concurrently with a bounded look-ahead window, so peak residency stays at
``workers + depth`` graphs no matter how long the program is.  Output is
bit-identical to sequential ingestion at any worker count: the tracer's
RNG is keyed per (template, params, seed, warp) — never shared mutable
state — and results are collected FIFO (the hypothesis suite enforces it).

Tracing is numpy-heavy (the vectorized `trace_kernel` spends its time
inside BLAS-free numpy ops that release the GIL), so a thread pool gives
real concurrency without pickling traces across processes.

Two caches stack underneath:
  - an in-process bounded LRU memo over the content key — duplicate
    invocations of one kernel (same template/params/seed at the same caps)
    build once per engine;
  - an optional on-disk `GraphStore` — warm runs load npz entries and
    re-trace NOTHING (``stats["traced"] == 0``), and a corrupt entry is
    rejected, re-traced, and overwritten.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Iterator, Optional

from repro_torch.config import resolve_trace_caps
from repro_torch.core.graphs import KernelGraph, build_kernel_graph
from repro_torch.ingest.store import GraphStore, kernel_graph_key


@dataclass(frozen=True)
class IngestConfig:
    #: concurrent trace workers; 0 = sequential inline (the parity baseline)
    workers: int = 0
    #: extra look-ahead submissions beyond the workers — peak residency is
    #: bounded by ``workers + depth`` in-flight graphs
    depth: int = 2
    #: consult/populate the attached GraphStore
    cache: bool = True
    #: in-process dedup memo capacity (unique kernels kept resident)
    memo: int = 128


class IngestEngine:
    """Parallel deterministic ingestion over a Program's kernels."""

    def __init__(self, config: Optional[IngestConfig] = None,
                 store: Optional[GraphStore] = None):
        self.config = config or IngestConfig()
        self.store = store
        self._lock = threading.Lock()  # guards _memo + stats (workers race)
        self._memo: OrderedDict[str, KernelGraph] = OrderedDict()
        self.stats = {
            "kernels": 0,        # invocations ingested
            "traced": 0,         # actually traced+built (warm run: 0)
            "memo_hits": 0,      # in-process dedup hits
            "store_hits": 0,     # on-disk cache hits
            "corrupt": 0,        # store entries rejected (then re-traced)
            "build_s": 0.0,      # worker seconds tracing/building/loading
            "wait_s": 0.0,       # consumer seconds blocked on a result
        }

    @property
    def overlap_fraction(self) -> float:
        """1 - wait/build: how much ingestion hid behind the consumer."""
        if self.stats["build_s"] <= 0.0:
            return 0.0
        return max(0.0, 1.0 - self.stats["wait_s"] / self.stats["build_s"])

    # -- single kernel -------------------------------------------------------
    def _memo_put(self, key: str, g: KernelGraph):
        memo = self._memo  # caller holds self._lock
        memo[key] = g
        memo.move_to_end(key)
        while len(memo) > self.config.memo:
            memo.popitem(last=False)

    def _bump(self, field: str, by=1):
        with self._lock:
            self.stats[field] += by

    def _build_one(self, inv, cap_warps: int, cap_instr: int) -> KernelGraph:
        key = kernel_graph_key(inv, cap_warps, cap_instr)
        t0 = time.perf_counter()
        try:
            with self._lock:
                g = self._memo.get(key)
                if g is not None:
                    self.stats["memo_hits"] += 1
                    return g
            store = self.store if self.config.cache else None
            if store is not None:
                existed = store.has_kernel(key)
                g = store.load_kernel(key)
                if g is not None:
                    with self._lock:
                        self.stats["store_hits"] += 1
                        self._memo_put(key, g)
                    return g
                if existed:  # present on disk but rejected -> corrupt entry
                    self._bump("corrupt")
            g = build_kernel_graph(inv.trace(cap_warps, cap_instr))
            self._bump("traced")
            if store is not None:
                store.save_kernel(key, g)
            with self._lock:
                self._memo_put(key, g)
            return g
        finally:
            self._bump("build_s", time.perf_counter() - t0)

    # -- program stream ------------------------------------------------------
    def iter_graphs(self, program, cap_warps: Optional[int] = None,
                    cap_instr: Optional[int] = None) -> Iterator[KernelGraph]:
        """Yield one graph per invocation, in program order.

        Draining the iterator to completion publishes the program's
        manifest to the GraphStore, marking the ingest as complete for
        `warm()` checks."""
        cap_warps, cap_instr = resolve_trace_caps(cap_warps, cap_instr,
                                                  program)
        kernels = list(program.kernels)
        self.stats["kernels"] += len(kernels)
        workers = max(0, int(self.config.workers))
        if workers == 0:
            for inv in kernels:
                t0 = time.perf_counter()
                g = self._build_one(inv, cap_warps, cap_instr)
                self.stats["wait_s"] += time.perf_counter() - t0
                yield g
        else:
            from concurrent.futures import ThreadPoolExecutor

            window = workers + max(1, int(self.config.depth))
            with ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix="ingest"
            ) as pool:
                pending: deque = deque()
                it = iter(kernels)
                for inv in it:
                    pending.append(
                        pool.submit(self._build_one, inv, cap_warps,
                                    cap_instr))
                    if len(pending) >= window:
                        break
                while pending:
                    t0 = time.perf_counter()
                    g = pending.popleft().result()  # FIFO: program order
                    self.stats["wait_s"] += time.perf_counter() - t0
                    nxt = next(it, None)
                    if nxt is not None:
                        pending.append(
                            pool.submit(self._build_one, nxt, cap_warps,
                                        cap_instr))
                    yield g
        if self.store is not None and self.config.cache and kernels:
            keys = [kernel_graph_key(k, cap_warps, cap_instr)
                    for k in kernels]
            if all(self.store.has_kernel(k) for k in keys):
                self.store.save_manifest(program, cap_warps, cap_instr, keys)

    def ingest(self, program, cap_warps: Optional[int] = None,
               cap_instr: Optional[int] = None) -> list[KernelGraph]:
        """Materialize every graph (benchmarks / small programs only —
        streaming consumers should use `iter_graphs`)."""
        return list(self.iter_graphs(program, cap_warps, cap_instr))
