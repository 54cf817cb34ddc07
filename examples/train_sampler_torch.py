"""End-to-end driver on the PyTorch/H100 port (twin of
``train_sampler.py``): train the RGCN contrastive sampler on a real
workload's kernel graphs, with validation InfoNCE, then cluster and report
the achieved sampling quality through the unified evaluation harness.

This drives the STAGE-level surface (build_graphs / train / embed /
cluster on ``GCLSampler``) that the registered ``gcl`` method wraps; for the
one-call path see ``examples/quickstart_torch.py`` or
``repro_torch.launch.sample``.

    PYTHONPATH=src python examples/train_sampler_torch.py --program AlexNet --steps 200
    PYTHONPATH=src python examples/train_sampler_torch.py --device cpu --steps 2 --batch 4

On the card (the default) training runs K1 / K1b / K5, the embed K1 and
the K sweep K2 / K3.
"""

import argparse
import sys
import time

import numpy as np

from repro_torch.core.sampler import GCLSampler, GCLSamplerConfig
from repro_torch.core.train import GCLTrainConfig
from repro_torch.sampling import evaluate
from repro_torch.tracing.programs import PAPER_PROGRAMS, get_program


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--program", default="AlexNet", choices=PAPER_PROGRAMS)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    prog = get_program(args.program)
    cfg = GCLSamplerConfig(
        train=GCLTrainConfig(steps=args.steps, batch_size=args.batch,
                             log_every=20),
    )
    sampler = GCLSampler(cfg, device=args.device)

    print(f"== contrastive training on {args.program} "
          f"({len(prog)} kernels) ==")
    graphs = sampler.build_graphs(prog)
    print(f"graphs: {len(graphs)}, "
          f"~{int(np.mean([g.n_nodes for g in graphs]))} nodes / "
          f"~{int(np.mean([g.n_edges for g in graphs]))} edges each")

    t0 = time.time()
    info = sampler.train(graphs, verbose=True)
    print(f"training done in {time.time() - t0:.0f}s; "
          f"val_loss={info.get('val_loss', float('nan')):.4f} "
          f"val_acc={info.get('val_acc', float('nan')):.3f}")

    emb = sampler.embed(graphs)
    seqs = np.array([k.seq for k in prog.kernels])
    plan = sampler.cluster(emb, seqs)
    res = evaluate(plan, prog, "P1")
    print(f"K={res.num_clusters} (silhouette mode: {plan.extra.get('mode')})"
          f" -> error {res.error_pct['cycles']:.2f}%, "
          f"speedup {res.speedup:.1f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
