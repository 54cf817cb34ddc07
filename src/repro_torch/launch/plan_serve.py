"""Plan-serving launcher: continuous-batched sampling-as-a-service
(counterpart of ``repro/launch/plan_serve.py``).

    python -m repro_torch.launch.plan_serve --load 100,300 --requests 120
    python -m repro_torch.launch.plan_serve --smoke --device cpu

Stands up a :class:`repro_torch.serving.PlanService` (continuous batcher
over the port's PlanEngine) on ``--device`` (default ``cuda``; ``cpu``
runs the kernels' plain versions), optionally warms every bucket of the
fleet, and drives it with open-loop Poisson traffic at each offered load,
reporting p50/p99 plan latency, plans/s, queue depth, and batch occupancy.

Knobs: ``--max-delay-ms`` (bucket flush deadline), ``--max-batch``
(requests per flush), ``--warmup-buckets 64x16,128x16`` / ``--no-warmup``
(the warm pool), ``--load`` (offered req/s, comma list).  The flags and the
``--json`` document are the JAX launcher's.

NOT the model-decode server: ``repro_torch.launch.serve`` serves
transformer prefill/decode traffic.  This CLI serves *sampling plans*.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.sampling.engine import bucket_key
from repro_torch.serving import (
    PlanService, parse_buckets, run_open_loop, synthetic_fleet,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.plan_serve")
    ap.add_argument("--requests", type=int, default=120,
                    help="requests per offered load")
    ap.add_argument("--load", default="100",
                    help="offered loads in req/s (comma list)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-delay-ms", type=float, default=5.0)
    ap.add_argument("--warmup-buckets", default=None,
                    help="explicit warm pool, e.g. '64x16,128x16' "
                         "(default: every bucket of the synthetic fleet)")
    ap.add_argument("--no-warmup", action="store_true",
                    help="serve cold: the first request of each bucket "
                         "pays its first sweep's costs")
    ap.add_argument("--d", type=int, default=16)
    ap.add_argument("--k-max", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the engine clusters: cuda (the hand-written "
                         "kernels) or cpu (their plain PyTorch versions)")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run (fewer requests, one load)")
    ap.add_argument("--json", default=None, help="write results JSON here")
    args = ap.parse_args(argv)

    n_requests = min(args.requests, 40) if args.smoke else args.requests
    loads = [float(x) for x in str(args.load).split(",") if x]
    if args.smoke:
        loads = loads[:1]

    fleet = synthetic_fleet(n_requests, d=args.d, seed=args.seed)
    buckets = sorted({bucket_key(r.embeddings) for r in fleet})
    rows = []
    with PlanService(max_batch=args.max_batch,
                     max_delay_ms=args.max_delay_ms, device=args.device,
                     k_max=args.k_max, iters=args.iters,
                     seed=args.seed) as svc:
        if not args.no_warmup:
            warm = (parse_buckets(args.warmup_buckets)
                    if args.warmup_buckets else buckets)
            built = svc.warmup(warm)
            print(f"[plan-serve] warm pool: {built} (bucket, batch) keys "
                  f"warmed for {len(warm)} buckets on {svc.engine.device}",
                  flush=True)
        for rate in loads:
            res = run_open_loop(svc, fleet, rate, seed=args.seed)
            s = res.service
            print(
                f"[plan-serve] load {rate:.0f}/s: {res.plans_per_s:.1f} "
                f"plans/s, p50 {res.latency_ms['p50']:.1f}ms, p99 "
                f"{res.latency_ms['p99']:.1f}ms, occupancy "
                f"{s['batch_occupancy'] and round(s['batch_occupancy'], 2)}, "
                f"mean queue {s['mean_queue_depth']:.1f}, flushes "
                f"{s['flush_causes']}", flush=True)
            rows.append(res.to_json())
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"buckets": [list(b) for b in buckets],
                       "loads": rows}, f, indent=1, sort_keys=True)
        print(f"[plan-serve] wrote {args.json}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
