"""repro_torch.serving — sampling-as-a-service over the port's PlanEngine
(counterpart of ``repro.serving``).

    from repro_torch.serving import PlanService

    with PlanService(max_batch=8, max_delay_ms=5.0) as svc:
        svc.warmup([(64, 16)])                  # off the serving path
        plan = svc.submit(PlanRequest(emb, seqs, "gcl")).result()

:class:`PlanService` coalesces requests into the engine's ``(points-bucket,
dim)`` groups and flushes a bucket when it fills to ``max_batch`` or its
deadline expires.  :mod:`repro_torch.serving.loadgen` drives it with
open-loop Poisson traffic (``python -m repro_torch.launch.plan_serve``).
"""

from repro_torch.serving.loadgen import (
    LoadResult, poisson_arrivals, run_open_loop, synthetic_fleet,
)
from repro_torch.serving.service import PlanService, parse_buckets

__all__ = [
    "LoadResult", "PlanService", "parse_buckets", "poisson_arrivals",
    "run_open_loop", "synthetic_fleet",
]
