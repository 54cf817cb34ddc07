"""PlanEngine — plan serving over the swept K-Means for every clustering
method.  Counterpart of ``repro/sampling/engine.py``.

- plan requests are grouped by embedding-matrix size (power-of-two points
  bucket, exact feature dim), the sweep's own padding unit;
- each program is one sweep dispatch on the engine's device (the JAX
  kernel path also dispatches one program at a time);
- trivial/tiny programs take the same host paths as the JAX engine;
- ``plan_many`` builds program i's plan on a worker thread while program
  i+1 is clustered;
- ``errors="isolate"`` turns a failing request into an Exception entry.
  The JAX engine retries such a request through its sequential reference;
  that path is not in the port, so the failure is the request's result —
  never a quiet answer from another implementation.

There are no compiled executables to cache: ``warmup`` builds (or loads)
the kernel library, so the first request does not pay the ``nvcc`` build.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field, replace
from typing import Callable, Optional

import numpy as np

from repro_torch.core.clustering import bucket_points, sweep_cluster_stack
from repro_torch.sampling.base import plan_from_labels
from repro_torch.sim.simulate import SamplingPlan
from repro_torch.utils.device import resolve_device


@dataclass(frozen=True)
class PlanEngineConfig:
    """Clustering knobs (mirrors the JAX ``PlanEngineConfig``)."""
    k_max: int = 48
    seed: int = 0
    sil_floor: float = 0.20
    tie_tol: float = 0.02
    tiny_n: int = 4
    sil_cap: int = 1200
    iters: int = 50
    init: str = "host"           # host numpy kmeans++ (the only one ported)
    engine: str = "sweep"        # 'sequential' is not ported: raises
    max_batch: int = 8           # requests per service flush
    record_timings: bool = False  # stamp per-request dispatch telemetry


@dataclass
class PlanRequest:
    """One program's plan inputs: kernel embeddings + invocation seqs."""
    embeddings: np.ndarray
    seqs: np.ndarray
    method: str = ""
    seed: Optional[int] = None   # overrides the engine seed per request
    extra: dict = field(default_factory=dict)


def normalize_embeddings(x) -> np.ndarray:
    """Engine-wide input normalization: float32, 2-D.  1-D vectors are a
    single scalar feature per point -> (n, 1)."""
    x = np.asarray(x, np.float32)
    if x.ndim == 1:
        x = x[:, None]
    if x.ndim != 2:
        raise ValueError(f"embeddings must be (n, d) or (n,), got {x.shape}")
    return x


def bucket_key(x) -> tuple[int, int]:
    """The ``(points-bucket, dim)`` grouping key for one request."""
    x = normalize_embeddings(x)
    return (bucket_points(len(x)), x.shape[1])


class PlanEngine:
    def __init__(self, cfg: Optional[PlanEngineConfig] = None, *,
                 device=None, **overrides):
        cfg = cfg or PlanEngineConfig()
        self.cfg = replace(cfg, **overrides) if overrides else cfg
        if self.cfg.engine != "sweep":
            raise NotImplementedError(
                f"engine={self.cfg.engine!r}: the sequential reference is not "
                f"in the PyTorch port yet; engine='sweep' is")
        self.device = resolve_device(device)
        self.stats = {"programs": 0, "dispatches": 0, "errors": 0,
                      "warmed_executables": 0, "bucket_hist": []}

    def _bump_bucket(self, key: tuple[int, int], n: int) -> None:
        for entry in self.stats["bucket_hist"]:
            if (entry["points_bucket"], entry["dim"]) == key:
                entry["count"] += n
                return
        self.stats["bucket_hist"].append(
            {"points_bucket": key[0], "dim": key[1], "count": n})

    # -- warm pool -----------------------------------------------------------
    def warmup(self) -> int:
        """Build or load the kernel library before the first request (eager
        kernels have no per-shape executables to pre-build).  Returns 1 when
        the library was built or loaded now, 0 when it already was."""
        if self.device.type != "cuda":
            return 0
        from repro_torch import kernels

        built = int(not kernels.loaded())
        kernels.library()
        self.stats["warmed_executables"] += built
        return built

    # -- clustering ---------------------------------------------------------
    def _cluster_kwargs(self) -> dict:
        c = self.cfg
        return dict(k_max=c.k_max, sil_floor=c.sil_floor, tie_tol=c.tie_tol,
                    tiny_n=c.tiny_n, sil_cap=c.sil_cap, iters=c.iters,
                    init=c.init, device=self.device)

    def _stamp(self, results: list, key, dispatch_s: float):
        for r in results:
            if isinstance(r, Exception):
                continue
            r[1]["serve"] = {"points_bucket": key[0], "dim": key[1],
                             "batch": 1, "dispatch_s": dispatch_s}

    def cluster_many(self, embs: list, seeds: Optional[list] = None,
                     errors: str = "raise",
                     on_chunk: Optional[Callable] = None):
        """Cluster many programs' embeddings; returns aligned
        [(labels, info)].  Requests are visited bucket by bucket, one sweep
        dispatch per program.  ``errors="isolate"``: a failing request
        becomes an Exception entry.  ``on_chunk(indices, results)`` fires
        after every dispatch."""
        if errors not in ("raise", "isolate"):
            raise ValueError(f"errors must be 'raise'|'isolate': {errors!r}")
        out: list = [None] * len(embs)
        if not embs:
            return out
        seeds = ([self.cfg.seed] * len(embs) if seeds is None
                 else [self.cfg.seed if s is None else s for s in seeds])
        norm: list = [None] * len(embs)
        for i, x in enumerate(embs):
            try:
                norm[i] = normalize_embeddings(x)
            except Exception as e:
                if errors == "raise":
                    raise
                out[i] = e
                self.stats["errors"] += 1
        groups: dict[tuple, list[int]] = {}
        for i in range(len(embs)):
            if norm[i] is not None:
                groups.setdefault(bucket_key(norm[i]), []).append(i)
        for key, idxs in sorted(groups.items()):
            self._bump_bucket(key, len(idxs))
            for i in idxs:
                t0 = time.perf_counter()
                try:
                    res = sweep_cluster_stack([norm[i]], seed=[seeds[i]],
                                              **self._cluster_kwargs())[0]
                except Exception as e:
                    if errors == "raise":
                        raise
                    res = e
                    self.stats["errors"] += 1
                if self.cfg.record_timings:
                    self._stamp([res], key, time.perf_counter() - t0)
                out[i] = res
                self.stats["dispatches"] += 1
                if on_chunk is not None:
                    on_chunk([i], [res])
        self.stats["programs"] += len(embs)
        return out

    # -- plans --------------------------------------------------------------
    def plan_many(self, requests: list[PlanRequest],
                  errors: str = "raise") -> list:
        """Serve many programs' SamplingPlans.  Host-side plan building
        (``plan_from_labels``) overlaps the next program's sweep on a worker
        thread.  With ``errors="isolate"``
        failed requests come back as Exception entries."""
        if not requests:
            return []
        plans: list = [None] * len(requests)

        def build(idxs, results):
            for i, r in zip(idxs, results):
                if isinstance(r, Exception):
                    plans[i] = r
                    continue
                labels, info = r
                req = requests[i]
                try:
                    plans[i] = plan_from_labels(
                        labels, req.seqs, req.method,
                        extra=dict(info, **req.extra))
                except Exception as e:
                    if errors == "raise":
                        raise
                    self.stats["errors"] += 1
                    plans[i] = e

        embs = [r.embeddings for r in requests]
        seeds = [r.seed for r in requests]
        with ThreadPoolExecutor(max_workers=1) as pool:
            futs = []
            results = self.cluster_many(
                embs, seeds, errors=errors,
                on_chunk=lambda idxs, res: futs.append(
                    pool.submit(build, idxs, res)))
            for f in futs:
                f.result()
        for i, r in enumerate(results):
            if plans[i] is None:        # normalization failures
                build([i], [r])
        return plans

    def plan(self, embeddings: np.ndarray, seqs: np.ndarray, method: str = "",
             seed: Optional[int] = None, extra: Optional[dict] = None
             ) -> SamplingPlan:
        return self.plan_many([PlanRequest(embeddings, seqs, method,
                                           seed=seed, extra=extra or {})])[0]

    def engine_stats(self) -> dict:
        return dict(self.stats, device=str(self.device))
