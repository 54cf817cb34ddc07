"""Quickstart on the PyTorch/H100 port: every registered sampling method on
one workload through ``repro_torch.sampling`` (twin of ``quickstart.py``).

    PYTHONPATH=src python examples/quickstart_torch.py [--program nw]
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu --steps 2

Stages (paper Fig. 2, owned by the ``gcl`` method): trace -> HRG -> RGCN
contrastive training -> embeddings -> K-Means -> representative selection,
then one ``evaluate_metrics`` call per method for error/speedup against
full simulation.  On the card (``--device cuda``, the default) the fit runs
the hand-written K1 / K1b / K5 kernels, the embed K1 and the K sweep K2 /
K3; ``--device cpu`` takes their plain versions.  Artifacts land in
``--out`` and are replayed on re-runs.
"""

import argparse
import sys
import time

from repro_torch.sampling import (
    ArtifactStore, available_methods, evaluate_metrics, get_method,
)
from repro_torch.sim.simulate import simulate_program
from repro_torch.tracing.programs import PAPER_PROGRAMS, get_program

#: the methods that run on a device (the others are numpy only)
DEVICE_METHODS = ("gcl", "pka")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--program", default="nw", choices=PAPER_PROGRAMS)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--out", default="runs/quickstart_torch")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    prog = get_program(args.program)
    store = ArtifactStore(args.out)
    print(f"== {args.program}: {len(prog)} kernel invocations ==")

    metrics = simulate_program(prog, "P1")  # full simulation, once
    results = []
    for method_id in available_methods():
        kwargs = (
            dict(steps=args.steps, batch_size=8, cap_instr=64)
            if method_id == "gcl" else {}
        )
        if method_id in DEVICE_METHODS:
            kwargs["device"] = args.device
        method = get_method(method_id, **kwargs)
        t0 = time.time()
        plan, _ = method.run(prog, store=store)
        print(f"{plan.method}: K={plan.num_clusters} clusters, "
              f"{len(plan.rep_indices())} representative(s) "
              f"({time.time() - t0:.0f}s)")
        results.append(evaluate_metrics(plan, metrics, program=prog.name,
                                        platform="P1"))

    print(f"\n{'method':14s}{'clusters':>9s}{'reps':>6s}"
          f"{'error %':>9s}{'speedup':>9s}")
    for r in results:
        print(f"{r.method:14s}{r.num_clusters:9d}{r.num_reps:6d}"
              f"{r.error_pct['cycles']:9.2f}{r.speedup:8.1f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
