"""PlanEngine — plan serving over the swept K-Means for every clustering
method.  Counterpart of ``repro/sampling/engine.py``.

- plan requests are grouped by embedding-matrix size (power-of-two points
  bucket, exact feature dim), the sweep's own padding unit;
- each group is cut into chunks of ``max_batch x data_devices`` programs,
  and each chunk is ONE sweep dispatch
  (:func:`repro_torch.core.clustering.sweep_cluster_stack`: every
  candidate K of every program of the chunk together), as JAX's default
  engine dispatches them; the results carry ``serve.batch`` = the chunk's
  size under ``record_timings``;
- a dispatch is placed across devices as JAX's is across its data mesh:
  its program axis is cut into ``effective_shards`` slices (the largest
  power of two at most the chunk's padded size, the shard width and the
  devices of the placement), each swept on its own device, the results
  read back in program order.  The placement is the cards present
  (``launch/mesh.make_data_mesh``'s first cards) or an explicit
  ``devices=`` list, which may repeat a device;
- trivial/tiny programs take the same host paths as the JAX engine;
- ``plan_many`` builds a chunk's plans on a worker thread while the next
  chunk is clustered;
- ``errors="isolate"``: when a chunk's sweep fails, each of its programs
  is retried on its own through the sequential reference
  (``select_k_and_cluster``), as the JAX engine does; a program that fails
  there too becomes an Exception entry and counts in ``stats["errors"]``,
  a recovered one does not;
- ``engine="sequential"`` serves every request through that reference
  (the parity path), one dispatch a request;
- scale-out fault protocol: ``fault_hook`` runs before every sweep
  dispatch, and a :class:`~repro_torch.distributed.fault.DeviceLost` from
  it halves the program-axis shard width (``data_devices``) and retries
  the same chunk; at width 1 it propagates.  The width defaults to the
  devices of the placement (JAX: ``jax.device_count()``): every card
  present, or the ``devices=`` list; 1 on the CPU.  An explicit
  ``data_devices=N`` takes JAX's chunk of ``max_batch x N`` programs (and
  its ``serve.batch`` stamps); above the devices of the placement, a
  slice stacks more than ``max_batch`` programs on its device, as JAX's
  engine does on a host with fewer devices than N, and its memory grows
  with it (the silhouette arithmetic's (B, num_k, n_pad, k_max) tensors
  and K2's partial sums scale with B).

There are no compiled executables to cache: ``warmup`` builds (or loads)
the kernel library, so the first request does not pay the ``nvcc`` build,
and, given buckets, sweeps a seeded batch of each bucket's shape once, so
the first dispatch of a bucket does not pay for the allocator's growth or
the library handles either.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field, replace
from typing import Callable, Optional

import numpy as np

from repro_torch.core.clustering import (
    _check_init, bucket_batch, bucket_points, select_k_and_cluster,
    sweep_cluster_stack,
)
from repro_torch.distributed.fault import DeviceLost
from repro_torch.launch.mesh import visible_devices
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
    max_batch: int = 8           # programs per sweep dispatch PER DEVICE
    record_timings: bool = False  # stamp per-request dispatch telemetry
    #: program-axis shard width: one dispatch serves data_devices x
    #: max_batch programs, and the degradation loop halves it.  0 = every
    #: device of the placement (JAX: every device): the cards present or
    #: the engine's ``devices=``; 1 on the CPU
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
    """``device``: where a dispatch of one slice runs (the card unless
    ``"cpu"``); ``devices``: the placement of a dispatch cut into slices
    (default: the cards present, or the CPU)."""

    def __init__(self, cfg: Optional[PlanEngineConfig] = None, *,
                 device=None, devices=None, **overrides):
        cfg = cfg or PlanEngineConfig()
        self.cfg = replace(cfg, **overrides) if overrides else cfg
        if self.cfg.engine not in ("sweep", "sequential"):
            raise ValueError(f"engine must be 'sweep'|'sequential': "
                             f"{self.cfg.engine!r}")
        _check_init(self.cfg.init)
        self.device = resolve_device(device)
        self.devices = (None if devices is None
                        else [resolve_device(d) for d in devices])
        self.stats = self._fresh_stats()
        #: the (points-bucket, dim, batch) keys ``warmup`` has swept
        self._warm: set = set()
        #: program-axis shard width: starts at ``data_devices`` (0: the
        #: devices of the placement) and only ever halves, when a dispatch
        #: raises DeviceLost
        self._data_shards = max(1, self.cfg.data_devices or len(
            self.devices or visible_devices(self.device.type)))
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
        "dim": d}`` dicts, points rounded up to their bucket.
        ``batch_sizes`` defaults to JAX's: every power-of-two chunk size up
        to ``bucket_batch(max_batch)``.  The library is loaded, then for
        each bucket with a ``(points, dim, batch)`` key not yet warm on
        this engine one seeded batch of the largest new batch size is
        swept (this engine's k_max, iters and seed; every program of the
        batch a seeded matrix of the bucket's points and dim), so the
        bucket's first dispatch finds the library, the library handles and
        the allocator's blocks in place (``engine="sequential"``: one call
        of the sequential reference, which serves one program at a time).
        With ``init="device"`` each program of that batch draws its
        seeding on the device at the bucket's shape (k_up = min(k_max,
        points - 1)), the key JAX's warm pool pre-builds its device init
        for.  Returns the number of keys warmed now, each counted once: 0
        when all were warm."""
        lib = 0
        if self.device.type == "cuda":
            from repro_torch import kernels

            lib = int(not kernels.loaded())
            kernels.library()
        if not buckets:
            self.stats["warmed_executables"] += lib
            return lib
        if batch_sizes is None:
            batch_sizes, b = [], 1
            while b <= bucket_batch(max(1, self.cfg.max_batch)):
                batch_sizes.append(b)
                b <<= 1
        built = 0
        for bucket in buckets:
            if isinstance(bucket, dict):
                points, dim = bucket["points_bucket"], bucket["dim"]
            else:
                points, dim = bucket
            points, dim = bucket_points(int(points)), int(dim)
            new = sorted({int(b) for b in batch_sizes
                          if (points, dim, int(b)) not in self._warm})
            if not new:
                continue
            rng = np.random.default_rng(self.cfg.seed)
            xs = [rng.standard_normal((points, dim)).astype(np.float32)
                  for _ in range(new[-1] if self.cfg.engine == "sweep"
                                 else 1)]
            if self.cfg.engine == "sweep":
                self._dispatch_chunk(xs, [self.cfg.seed] * len(xs))
            else:
                self._sequential(xs[0], self.cfg.seed)
            self._warm.update((points, dim, b) for b in new)
            built += len(new)
        self.stats["warmed_executables"] += built
        return built

    # -- clustering ---------------------------------------------------------
    def _cluster_kwargs(self) -> dict:
        c = self.cfg
        return dict(k_max=c.k_max, sil_floor=c.sil_floor, tie_tol=c.tie_tol,
                    tiny_n=c.tiny_n, sil_cap=c.sil_cap, iters=c.iters,
                    init=c.init, device=self.device)

    def _stamp(self, results: list, key, chunk: int, dispatch_s: float):
        """record_timings: dispatch telemetry on every info dict (flows into
        plan.extra), so a server can account occupancy and service time."""
        for r in results:
            if isinstance(r, Exception):
                continue
            r[1]["serve"] = {"points_bucket": key[0], "dim": key[1],
                             "batch": chunk, "dispatch_s": dispatch_s}

    def cluster_many(self, embs: list, seeds: Optional[list] = None,
                     errors: str = "raise",
                     on_chunk: Optional[Callable] = None):
        """Cluster many programs' embeddings; returns aligned
        [(labels, info)].  Requests are grouped by (points-bucket, dim) —
        the sweep's own padding unit — and each group is cut into chunks
        of ``max_batch x data_devices`` programs, one sweep dispatch each
        (``engine="sequential"``: one sequential reference call per
        program, in request order).  ``errors="isolate"``: when a chunk's
        sweep fails, its programs are retried one by one through the
        sequential reference, and one that fails there too becomes an
        Exception entry.  ``on_chunk(indices, results)`` fires after every
        dispatch."""
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
            chunks = [(bucket_key(norm[i]), [i]) for i in live]
        else:
            groups: dict[tuple, list[int]] = {}
            for i in live:
                groups.setdefault(bucket_key(norm[i]), []).append(i)
            cap = max(1, self.cfg.max_batch) * max(1, self._data_shards)
            chunks = []
            for key, idxs in sorted(groups.items()):
                self._bump_bucket(key, len(idxs))
                chunks += [(key, idxs[lo:lo + cap])
                           for lo in range(0, len(idxs), cap)]
        for key, chunk in chunks:
            t0 = time.perf_counter()
            res = self._cluster_chunk([norm[i] for i in chunk],
                                      [seeds[i] for i in chunk], errors)
            if self.cfg.record_timings:
                self._stamp(res, key, len(chunk), time.perf_counter() - t0)
            for i, r in zip(chunk, res):
                out[i] = r
            self.stats["dispatches"] += 1
            if on_chunk is not None:
                on_chunk(chunk, res)
        self.stats["programs"] += len(embs)
        return out

    def cluster(self, emb: np.ndarray, seed: Optional[int] = None):
        return self.cluster_many([emb], [seed])[0]

    def _sequential(self, x, seed):
        return select_k_and_cluster(x, seed=seed, **self._cluster_kwargs())

    def _dispatch_chunk(self, xs: list, seeds: list):
        """One sweep dispatch of a chunk with the degradation loop: a
        DeviceLost (from ``fault_hook``) halves the shard width and retries
        the same chunk, so a lost participant costs throughput, not
        requests; at width 1 it propagates."""
        while True:
            try:
                if self.fault_hook is not None:
                    self.fault_hook()
                return sweep_cluster_stack(
                    xs, seed=seeds, data_shards=self._data_shards,
                    devices=self.devices, **self._cluster_kwargs())
            except DeviceLost:
                if self._data_shards <= 1:
                    raise
                self._data_shards //= 2
                self.stats["degraded_dispatches"] += 1

    def _cluster_chunk(self, xs: list, seeds: list, errors: str) -> list:
        """One chunk through the configured engine.  Under
        ``errors="isolate"`` a failed sweep is retried program by program
        through the sequential reference, and a program that fails there
        too (or in the sequential engine) comes back as its exception,
        counted in ``stats["errors"]``."""
        try:
            if self.cfg.engine == "sequential":
                return [self._sequential(x, s) for x, s in zip(xs, seeds)]
            return self._dispatch_chunk(xs, seeds)
        except Exception as e:
            if errors == "raise":
                raise
            if self.cfg.engine == "sequential":     # one program a chunk
                self.stats["errors"] += 1
                return [e]
        res = []
        for x, s in zip(xs, seeds):
            try:
                res.append(self._sequential(x, s))
            except Exception as e:
                res.append(e)
                self.stats["errors"] += 1
        return res

    # -- plans --------------------------------------------------------------
    def plan_many(self, requests: list[PlanRequest],
                  errors: str = "raise") -> list:
        """Serve many programs' SamplingPlans.  Host-side plan building
        (``plan_from_labels``) overlaps the next chunk's sweep on a worker
        thread.  With ``errors="isolate"`` failed requests come back as
        Exception entries."""
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
