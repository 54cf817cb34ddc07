"""Steps/s of the GCL fit and wall time of ``embed`` with the one-ahead
staging on and off, in turns, on the card.

    python3 scripts/staging_turns.py [--turns 4] [--device cuda]

After one warm-up fit (kernels built, the caching allocators and pinned
memory warm), runs phi-2's default fit (120 steps of 16 of its training
graphs, the default encoder and optimizer) in turns of ``prefetch`` off,
on, on, off, repeated ``--turns`` times in this one process, then
``embed`` of all of phi-2's graphs from a cold embedding cache (a fresh
trainer) in the same turns.  For each run: steps/s (steps over the step
loop's seconds), the staging seconds, the consumer's wait seconds and
the overlap (``1 - wait_s / stage_s``); for each mode the median and the
range.  Prints one JSON line with the card's name and power limit
(``nvidia-smi``).  ``--device cpu`` runs it on the CPU (a rehearsal, not
a measurement).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _card_line(dev) -> str:
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _summary(runs: list, key: str) -> dict:
    out = {}
    for on in (False, True):
        vals = [r[key] for r in runs if r["prefetch"] is on]
        out["on" if on else "off"] = {
            "median": statistics.median(vals), "min": min(vals),
            "max": max(vals)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.core.rgcn import RGCNConfig
    from repro_torch.core.sampler import GCLSampler
    from repro_torch.core.train import ContrastiveTrainer, GCLTrainConfig
    from repro_torch.tracing.programs import get_program
    from repro_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    sampler = GCLSampler(device="cpu")
    prog = get_program("phi-2")
    graphs = sampler.training_graphs(sampler.iter_graphs(prog), len(prog))
    program = list(sampler.iter_graphs(prog))
    order = [False, True, True, False] * args.turns

    def fit(on):
        tc = GCLTrainConfig(steps=args.steps, prefetch=on)
        enc, info = ContrastiveTrainer(RGCNConfig(), tc, device=dev).fit(
            graphs)
        _sync(dev)
        return enc, info

    enc, _ = fit(True)                                   # warm-up
    fits = []
    for on in order:
        _, info = fit(on)
        fits.append({"prefetch": on,
                     "steps_per_s": len(info["history"]) / info["fit_s"],
                     "fit_s": info["fit_s"],
                     "stage_s": info["prefetch_stage_s"],
                     "wait_s": info["prefetch_wait_s"],
                     "overlap": info["prefetch_overlap"]})
    embeds = []
    for on in order:
        tr = ContrastiveTrainer(RGCNConfig(), GCLTrainConfig(prefetch=on),
                                device=dev)
        t0 = time.perf_counter()
        tr.embed(enc, program)
        _sync(dev)
        st = tr.embed_stats
        embeds.append({"prefetch": on, "wall_s": time.perf_counter() - t0,
                       "stage_s": st["prefetch_stage_s"],
                       "wait_s": st["prefetch_wait_s"],
                       "overlap": st["prefetch_overlap"]})
    print(json.dumps({
        "card": _card_line(dev), "steps": args.steps, "turns": order,
        "fit": fits, "fit_steps_per_s": _summary(fits, "steps_per_s"),
        "fit_overlap": _summary(fits, "overlap"),
        "embed": embeds, "embed_wall_s": _summary(embeds, "wall_s"),
        "embed_overlap": _summary(embeds, "overlap")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
