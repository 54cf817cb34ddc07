"""Continuous-batched plan serving, counterpart of
``repro/serving/service.py``.

- ``submit`` enqueues a :class:`~repro_torch.sampling.engine.PlanRequest`
  into its ``(points-bucket, dim)`` queue and returns a ``Future``;
- one dispatcher thread flushes a bucket when it reaches ``max_batch``
  (fill) or its oldest request has waited ``max_delay_ms`` (deadline);
- dispatches run through ``PlanEngine.plan_many(errors="isolate")``: a
  failing request fails only its own future;
- ``submit_program`` prepares a program on the caller's thread (trace,
  graphs, embeddings through the adopted encoder) and queues the method's
  engine-ready request.

The dispatcher thread binds the engine's CUDA device before its first
dispatch and launches on that thread's current (default) stream; results
come back to the host inside the engine, so a resolved future never holds
device work in flight.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.sampling.engine import PlanEngine, PlanRequest, bucket_key


@dataclass
class _Pending:
    request: PlanRequest
    future: Future
    t_submit: float


class PlanService:
    """Long-lived continuous batcher over one :class:`PlanEngine`::

        with PlanService(max_batch=8, max_delay_ms=5.0) as svc:
            svc.warmup()
            plan = svc.submit_program(method, program).result()

    ``engine`` defaults to a fresh :class:`PlanEngine` on ``device`` (the
    card unless ``"cpu"``) built from ``engine_overrides`` (k_max, iters,
    seed, ...) with per-request timing telemetry on.
    """

    def __init__(self, engine: Optional[PlanEngine] = None, *,
                 max_batch: Optional[int] = None,
                 max_delay_ms: float = 5.0,
                 device=None,
                 **engine_overrides):
        if engine is None:
            kw = dict(max_batch=max_batch or 8, record_timings=True)
            kw.update(engine_overrides)
            engine = PlanEngine(device=device, **kw)
        elif engine_overrides or device is not None:
            raise ValueError("pass device/engine_overrides only without "
                             "engine")
        self.engine = engine
        self.max_batch = int(max_batch or engine.cfg.max_batch)
        self.max_delay_s = float(max_delay_ms) / 1e3
        self._queues: dict[tuple, deque] = {}
        self._cv = threading.Condition()
        self._stop = False
        self._mlock = threading.Lock()
        self.metrics = {
            "submitted": 0, "served": 0, "failed": 0, "dispatches": 0,
            "batch_sizes": [], "dispatch_s": [], "latencies_s": [],
            "queue_depth_samples": [],
            "flush_causes": {"fill": 0, "deadline": 0, "drain": 0},
        }
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="plan-service-dispatch")
        self._thread.start()

    # -- client surface ------------------------------------------------------
    def submit(self, request: PlanRequest) -> Future:
        """Enqueue one request; returns a Future resolving to its
        SamplingPlan (or raising the request's own isolated error)."""
        fut: Future = Future()
        try:
            key = bucket_key(request.embeddings)
        except Exception as e:
            with self._mlock:
                self.metrics["submitted"] += 1
                self.metrics["failed"] += 1
            fut.set_exception(e)
            return fut
        item = _Pending(request, fut, time.perf_counter())
        with self._cv:
            if self._stop:
                fut.set_exception(RuntimeError("PlanService is closed"))
                return fut
            self._queues.setdefault(key, deque()).append(item)
            depth = sum(len(q) for q in self._queues.values())
            self._cv.notify()
        with self._mlock:
            self.metrics["submitted"] += 1
            self.metrics["queue_depth_samples"].append(depth)
        return fut

    def submit_program(self, method, program, store=None) -> Future:
        """Serve a traced program end to end: ``run_prepare`` on the
        caller's thread, then the method's engine-ready request joins the
        batch queues.  Plans come from this service's engine config; keep
        its clustering knobs (k_max, ...) consistent with the method's."""
        artifacts = method.run_prepare(program, store)
        request = method.plan_request(program, artifacts)
        if request is None:
            fut: Future = Future()
            try:
                fut.set_result(method.plan(program, artifacts))
            except Exception as e:
                fut.set_exception(e)
            return fut
        return self.submit(request)

    def warmup(self) -> int:
        """Build/load the kernels before the first request (see
        :meth:`PlanEngine.warmup`)."""
        return self.engine.warmup()

    # -- telemetry -----------------------------------------------------------
    def stats(self) -> dict:
        """Aggregated serving counters + the engine's own stats."""
        with self._mlock:
            m = {k: (list(v) if isinstance(v, list) else
                     dict(v) if isinstance(v, dict) else v)
                 for k, v in self.metrics.items()}
        with self._cv:
            m["queue_depth"] = sum(len(q) for q in self._queues.values())
        lat = np.asarray(m.pop("latencies_s")) * 1e3
        m["latency_ms"] = {
            "p50": float(np.percentile(lat, 50)) if len(lat) else None,
            "p99": float(np.percentile(lat, 99)) if len(lat) else None,
            "mean": float(lat.mean()) if len(lat) else None,
        }
        sizes = m.pop("batch_sizes")
        m["batch_occupancy"] = (float(np.mean(sizes)) / self.max_batch
                                if sizes else None)
        m["mean_batch"] = float(np.mean(sizes)) if sizes else None
        depth = m.pop("queue_depth_samples")
        m["mean_queue_depth"] = float(np.mean(depth)) if depth else 0.0
        disp = m.pop("dispatch_s")
        m["mean_dispatch_ms"] = (float(np.mean(disp)) * 1e3 if disp
                                 else None)
        m["engine"] = self.engine.engine_stats()
        m["errors"] = m["failed"]           # requests whose future raised
        return m

    # -- dispatcher ----------------------------------------------------------
    def _ready_key_locked(self, now: float):
        best, best_t = None, None
        for key, q in self._queues.items():
            if not q:
                continue
            head_t = q[0].t_submit
            ready = (len(q) >= self.max_batch or self._stop
                     or now - head_t >= self.max_delay_s)
            if ready and (best is None or head_t < best_t):
                best, best_t = key, head_t
        return best

    def _next_timeout_locked(self, now: float):
        waits = [q[0].t_submit + self.max_delay_s - now
                 for q in self._queues.values() if q]
        return max(min(waits), 0.0) if waits else None

    def _loop(self):
        if self.engine.device.type == "cuda":
            torch.cuda.set_device(self.engine.device)
        while True:
            with self._cv:
                while True:
                    now = time.perf_counter()
                    key = self._ready_key_locked(now)
                    if key is not None:
                        break
                    if self._stop:
                        return
                    self._cv.wait(self._next_timeout_locked(now))
                q = self._queues[key]
                n = min(len(q), self.max_batch)
                pending = [q.popleft() for _ in range(n)]
                cause = ("fill" if n >= self.max_batch else
                         "drain" if self._stop else "deadline")
            self._dispatch(pending, cause)

    def _dispatch(self, pending, cause: str):
        reqs = [p.request for p in pending]
        t0 = time.perf_counter()
        try:
            plans = self.engine.plan_many(reqs, errors="isolate")
        except Exception as e:  # engine-level failure: fail THIS batch only
            plans = [e] * len(pending)
        t1 = time.perf_counter()
        served = failed = 0
        lats = []
        for p, plan in zip(pending, plans):
            lats.append(time.perf_counter() - p.t_submit)
            if isinstance(plan, Exception) or plan is None:
                failed += 1
                p.future.set_exception(
                    plan if isinstance(plan, Exception)
                    else RuntimeError("engine returned no plan"))
            else:
                served += 1
                p.future.set_result(plan)
        with self._mlock:
            m = self.metrics
            m["dispatches"] += 1
            m["batch_sizes"].append(len(pending))
            m["dispatch_s"].append(t1 - t0)
            m["flush_causes"][cause] += 1
            m["served"] += served
            m["failed"] += failed
            m["latencies_s"].extend(lats)

    # -- lifecycle -----------------------------------------------------------
    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Drain every queue (pending requests still get served), then stop
        the dispatcher.  Idempotent."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout)

    def __enter__(self) -> "PlanService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
