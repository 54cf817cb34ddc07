"""PlanEngine — plan serving over the swept K-Means for every clustering
method.  Counterpart of ``repro/sampling/engine.py``.

- plan requests are grouped by embedding-matrix size (power-of-two points
  bucket, exact feature dim), the sweep's own padding unit;
- each program is one sweep dispatch on the engine's device (the JAX
  kernel path also dispatches one program at a time);
- trivial/tiny programs take the same host paths as the JAX engine;
- ``plan_many`` builds program i's plan on a worker thread while program
  i+1 is clustered;
- ``errors="isolate"``: a request whose sweep fails is retried through the
  sequential reference (``select_k_and_cluster``), as the JAX engine does;
  a request that fails there too becomes an Exception entry and counts in
  ``stats["errors"]``, a recovered one does not;
- ``engine="sequential"`` serves every request through that reference
  (the parity path);
- scale-out fault protocol: ``fault_hook`` runs before every sweep
  dispatch, and a :class:`~repro_torch.distributed.fault.DeviceLost` from
  it halves the program-axis shard width (``data_devices``) and retries
  the same programs; at width 1 it propagates.

There are no compiled executables to cache: ``warmup`` builds (or loads)
the kernel library, so the first request does not pay the ``nvcc`` build,
and, given buckets, sweeps a seeded matrix of each bucket's shape once, so
the first request of a bucket does not pay for the allocator's growth or
the library handles either.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field, replace
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.clustering import (
    _check_init, bucket_points, select_k_and_cluster, sweep_cluster_stack,
)
from repro_torch.distributed.fault import DeviceLost
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
    init: str = "host"           # 'host' numpy kmeans++ | 'device' D^2 draws
    engine: str = "sweep"        # 'sweep' | 'sequential' (parity reference)
    max_batch: int = 8           # requests per service flush
    record_timings: bool = False  # stamp per-request dispatch telemetry
    #: program-axis shard width the degradation loop starts from: 0 = every
    #: card present (``torch.cuda.device_count()``; 1 for an engine on the
    #: CPU).  The port sweeps one program per dispatch on the engine's one
    #: device, so the width is bookkeeping only: placing a dispatch's
    #: programs across several cards waits for a program axis in the sweep
    data_devices: int = 0


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
        if self.cfg.engine not in ("sweep", "sequential"):
            raise ValueError(f"engine must be 'sweep'|'sequential': "
                             f"{self.cfg.engine!r}")
        _check_init(self.cfg.init)
        self.device = resolve_device(device)
        self.stats = self._fresh_stats()
        #: the (points-bucket, dim, batch) keys ``warmup`` has swept
        self._warm: set = set()
        present = (torch.cuda.device_count() if self.device.type == "cuda"
                   else 1)
        #: program-axis shard width: starts at ``data_devices`` and only
        #: ever halves, when a dispatch raises DeviceLost
        self._data_shards = max(1, self.cfg.data_devices or present)
        #: fault injection point, called before every sweep dispatch; raise
        #: DeviceLost from it to drive the degradation loop
        self.fault_hook: Optional[Callable[[], None]] = None

    @staticmethod
    def _fresh_stats() -> dict:
        return {"programs": 0, "dispatches": 0, "errors": 0,
                "warmed_executables": 0, "degraded_dispatches": 0,
                "bucket_hist": []}

    def reset_stats(self) -> None:
        """Zero the instance counters (long-lived servers window their
        telemetry with this); the warm set stays."""
        self.stats = self._fresh_stats()

    def _bump_bucket(self, key: tuple[int, int], n: int) -> None:
        for entry in self.stats["bucket_hist"]:
            if (entry["points_bucket"], entry["dim"]) == key:
                entry["count"] += n
                return
        self.stats["bucket_hist"].append(
            {"points_bucket": key[0], "dim": key[1], "count": n})

    # -- warm pool -----------------------------------------------------------
    def warmup(self, buckets=(), batch_sizes: Optional[list] = None) -> int:
        """Take first-request costs off the serving path.

        Without ``buckets``: build or load the kernel library (on the card;
        eager kernels have no per-shape executables); returns 1 when it was
        built or loaded now, 0 when it already was or on the CPU.

        ``buckets``: ``(points, dim)`` pairs or ``{"points_bucket": p,
        "dim": d}`` dicts, points rounded up to their bucket.  The library
        is loaded, then each bucket not yet warm on this engine is swept
        once (this engine's k_max, iters and seed) over a seeded matrix of
        that bucket's points and dim on the engine's device, so its first
        request finds the library, the library handles and the allocator's
        blocks in place (``engine="sequential"``: one call of the
        sequential reference).  The port dispatches one program per sweep, so
        ``batch_sizes`` defaults to ``[1]``; every batch size takes the
        same path, and each new ``(points, dim, batch)`` key counts once.
        With ``init="device"`` the bucket's sweep draws its seeding on the
        device at the bucket's shape (k_up = min(k_max, points - 1)), the
        key JAX's warm pool pre-builds its device init for.  Returns the
        number of keys warmed now: 0 when all were warm."""
        lib = 0
        if self.device.type == "cuda":
            from repro_torch import kernels

            lib = int(not kernels.loaded())
            kernels.library()
        if not buckets:
            self.stats["warmed_executables"] += lib
            return lib
        built = 0
        for bucket in buckets:
            if isinstance(bucket, dict):
                points, dim = bucket["points_bucket"], bucket["dim"]
            else:
                points, dim = bucket
            points, dim = bucket_points(int(points)), int(dim)
            new = [b for b in (batch_sizes or [1])
                   if (points, dim, int(b)) not in self._warm]
            if not new:
                continue
            x = np.random.default_rng(self.cfg.seed).standard_normal(
                (points, dim)).astype(np.float32)
            self._cluster_one(x, self.cfg.seed, "raise")
            self._warm.update((points, dim, int(b)) for b in new)
            built += len(new)
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
        dispatch per program (``engine="sequential"``: one sequential
        reference call per program, in request order).
        ``errors="isolate"``: a request whose sweep fails is retried
        through the sequential reference; one that fails there too becomes
        an Exception entry.  ``on_chunk(indices, results)`` fires after
        every dispatch."""
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
        live = [i for i in range(len(embs)) if norm[i] is not None]
        if self.cfg.engine == "sequential":
            order = [(bucket_key(norm[i]), i) for i in live]
        else:
            groups: dict[tuple, list[int]] = {}
            for i in live:
                groups.setdefault(bucket_key(norm[i]), []).append(i)
            order = []
            for key, idxs in sorted(groups.items()):
                self._bump_bucket(key, len(idxs))
                order += [(key, i) for i in idxs]
        for key, i in order:
            t0 = time.perf_counter()
            res = self._cluster_one(norm[i], seeds[i], errors)
            if self.cfg.record_timings:
                self._stamp([res], key, time.perf_counter() - t0)
            out[i] = res
            self.stats["dispatches"] += 1
            if on_chunk is not None:
                on_chunk([i], [res])
        self.stats["programs"] += len(embs)
        return out

    def cluster(self, emb: np.ndarray, seed: Optional[int] = None):
        return self.cluster_many([emb], [seed])[0]

    def _sequential(self, x, seed):
        return select_k_and_cluster(x, seed=seed, **self._cluster_kwargs())

    def _dispatch_chunk(self, xs: list, seeds: list):
        """One sweep dispatch with the degradation loop: a DeviceLost (from
        ``fault_hook``) halves the shard width and retries the same
        programs, so a lost participant costs throughput, not requests; at
        width 1 it propagates."""
        while True:
            try:
                if self.fault_hook is not None:
                    self.fault_hook()
                return sweep_cluster_stack(xs, seed=seeds,
                                           **self._cluster_kwargs())
            except DeviceLost:
                if self._data_shards <= 1:
                    raise
                self._data_shards //= 2
                self.stats["degraded_dispatches"] += 1

    def _cluster_one(self, x, seed, errors: str):
        """One program through the configured engine.  Under
        ``errors="isolate"`` a failed sweep is retried through the
        sequential reference, and a request that fails there too (or in
        the sequential engine) comes back as its exception, counted in
        ``stats["errors"]``."""
        try:
            if self.cfg.engine == "sequential":
                return self._sequential(x, seed)
            return self._dispatch_chunk([x], [seed])[0]
        except Exception as e:
            if errors == "raise":
                raise
            err = e
        if self.cfg.engine == "sweep":
            try:
                return self._sequential(x, seed)
            except Exception as e:
                err = e
        self.stats["errors"] += 1
        return err

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
        return dict(self.stats, device=str(self.device),
                    data_shards=self._data_shards)
