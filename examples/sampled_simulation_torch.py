"""Sampled simulation of a workload derived from an assigned architecture
config, on the PyTorch/H100 port (twin of ``sampled_simulation.py``): the
LM zoo is the simulation subject, driven through ``repro_torch.sampling``
— one ``run`` + one ``evaluate`` call owns the whole comparison.

    PYTHONPATH=src python examples/sampled_simulation_torch.py --arch granite-3-2b
    PYTHONPATH=src python examples/sampled_simulation_torch.py --device cpu \\
        --steps 2 --train-steps 2

On the card (the default) the ``gcl`` method's fit runs K1 / K1b / K5, its
embed K1 and its K sweep K2 / K3.
"""

import argparse
import sys

from repro_torch.configs import list_archs
from repro_torch.sampling import evaluate, get_method
from repro_torch.tracing.programs import lm_program


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b", choices=list_archs())
    ap.add_argument("--steps", type=int, default=2, help="inference steps")
    ap.add_argument("--train-steps", type=int, default=80)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    prog = lm_program(args.arch, steps=args.steps, seq_len=256)
    print(f"== lm:{args.arch}: {len(prog)} kernel invocations "
          f"(prefill + {args.steps - 1} decode steps) ==")

    method = get_method("gcl", steps=args.train_steps, batch_size=16,
                        cap_instr=64, device=args.device)
    plan, artifacts = method.run(prog)
    res = evaluate(plan, prog, "P1")

    print(f"\nclusters: {res.num_clusters}  reps: {res.num_reps}")
    print(f"cycles: full {res.full['cycles']:.3e} vs sampled "
          f"{res.sampled['cycles']:.3e} (err {res.error_pct['cycles']:.2f}%)")
    print(f"kernel-time speedup (eq.6): {res.speedup:.1f}x")
    print(f"simulator wall-time: {res.sim_time_full_s:.1f}s -> "
          f"{res.sim_time_sampled_s:.1f}s ({res.sim_speedup:.1f}x)")
    for m in ("ipc", "l1_hit", "l2_hit", "occupancy"):
        print(f"  {m:10s} full {res.full[m]:.4f} sampled {res.sampled[m]:.4f}")
    print(f"stage timings: "
          + " ".join(f"{k}={v:.1f}s" for k, v in artifacts.timings.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
