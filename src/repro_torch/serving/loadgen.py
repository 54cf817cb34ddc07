"""Open-loop Poisson load generation for the plan-serving SLO benchmarks.

Open-loop means arrivals are SCHEDULED up front from a Poisson process and
submitted at their scheduled time regardless of how the server is doing —
latency is measured from the *scheduled* arrival, so a stalled server
accumulates the queueing delay it actually caused (no coordinated
omission; cf. "Parallelizing a modern GPU simulator"'s throughput-vs-
latency framing and standard serving-bench practice).
"""

from __future__ import annotations

import time
from concurrent.futures import wait
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.sampling.engine import PlanRequest


def synthetic_fleet(n_requests: int, d: int = 16, seed: int = 0,
                    n_lo: int = 20, n_hi: int = 60) -> list[PlanRequest]:
    """Blob-structured per-request embedding matrices (K selection has
    signal), sizes spread across point buckets like the scenario grid;
    per-request seeds exercise the mixed-seed chunk path."""
    rng = np.random.default_rng(seed)
    fleet = []
    for i in range(n_requests):
        k_true = int(rng.integers(2, 6))
        n_per = int(rng.integers(n_lo, n_hi)) // k_true + 2
        centers = rng.standard_normal((k_true, d)) * 40.0
        x = np.concatenate(
            [c + rng.standard_normal((n_per, d)) * 0.5 for c in centers]
        ).astype(np.float32)
        fleet.append(PlanRequest(x, np.arange(len(x)), "loadgen", seed=i))
    return fleet


def poisson_arrivals(n: int, rate_hz: float, seed: int = 0) -> np.ndarray:
    """Cumulative arrival times (seconds) of a rate-``rate_hz`` Poisson
    process: exponential inter-arrival gaps."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate_hz, size=n))


@dataclass
class LoadResult:
    """One open-loop run at one offered load."""
    offered_per_s: float
    n_requests: int
    n_ok: int
    n_err: int
    wall_s: float
    plans_per_s: float               # completed plans / wall
    latency_ms: dict                 # p50/p99/mean from scheduled arrival
    service: dict = field(default_factory=dict)  # PlanService.stats()

    def to_json(self) -> dict:
        return {
            "offered_per_s": self.offered_per_s,
            "n_requests": self.n_requests,
            "n_ok": self.n_ok, "n_err": self.n_err,
            "wall_s": self.wall_s, "plans_per_s": self.plans_per_s,
            "latency_ms": self.latency_ms,
            "service": self.service,
        }


def run_open_loop(service, requests: list[PlanRequest], rate_hz: float,
                  seed: int = 0,
                  arrivals: Optional[np.ndarray] = None) -> LoadResult:
    """Drive ``service`` with the request list at offered load ``rate_hz``.

    Submits each request at its scheduled Poisson arrival (sleeping between
    arrivals; a late generator submits immediately and the lateness counts
    against latency), records completion timestamps via done-callbacks, and
    summarizes p50/p99 latency and completed plans/s."""
    n = len(requests)
    if arrivals is None:
        arrivals = poisson_arrivals(n, rate_hz, seed)
    done_t = [None] * n
    futures = []
    service.reset_stats()
    t0 = time.perf_counter()
    for i, (req, t_arr) in enumerate(zip(requests, arrivals)):
        lag = t_arr - (time.perf_counter() - t0)
        if lag > 0:
            time.sleep(lag)
        fut = service.submit(req)

        def _mark(f, i=i):
            done_t[i] = time.perf_counter() - t0

        fut.add_done_callback(_mark)
        futures.append(fut)
    wait(futures)
    wall = time.perf_counter() - t0
    errs = sum(1 for f in futures if f.exception() is not None)
    lat_ms = np.array([(done_t[i] - arrivals[i]) * 1e3 for i in range(n)])
    return LoadResult(
        offered_per_s=float(rate_hz), n_requests=n, n_ok=n - errs,
        n_err=errs, wall_s=wall,
        plans_per_s=(n - errs) / max(wall, 1e-9),
        latency_ms={
            "p50": float(np.percentile(lat_ms, 50)),
            "p99": float(np.percentile(lat_ms, 99)),
            "mean": float(lat_ms.mean()),
            "max": float(lat_ms.max()),
        },
        service=service.stats(),
    )
