"""Device time of the sweep's K2 and K3 calls for one program, on the card.

    python3 scripts/sweep_kernel_times.py [--src DIR] [--records 5]

Times the port found under ``--src`` (default: this checkout's ``src``),
so two trees can be held against each other on one card in one run:
run it once per tree, alternating (A, B, B, A).  Every tree times the
same inputs, made from a fixed seed, through the one-program calls that
every version of the wrappers takes:

- ``k2_one``: ``kmeans_assign_fused``, one candidate (n 4096, d 256,
  k 48 with 40 live slots, 2425 real points);
- ``k2_step``: ``kmeans_assign_fused_batched``, one Lloyd step of a
  sweep (the same points, the candidates K = 2..48: C = 47);
- ``k3``: ``silhouette_sums``, 1200 live rows of the same points;
- ``k2_step_b8``, where the tree's K2 has a program axis: the step over
  8 programs of that bucket in one call.

Each number is the device time of one call, summed over the call's own
CUDA kernels from a torch.profiler record of ``--iters`` calls in which
each kernel appears exactly ``--iters`` times; the median of
``--records`` such records, all of them printed, and each kernel's
median.  Prints one JSON line with the card's name and power limit
(``nvidia-smi``).
"""

from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import sys
from pathlib import Path

K2 = ("k2_prep_kernel", "k2_assign_kernel", "k2_stats_kernel",
      "k2_reduce_kernel")
K3 = ("sil_rows_kernel", "sil_compact_kernel", "silhouette_sums_kernel")


def _record_ms(fn, iters, own):
    """{kernel: device ms a call} over the kernels ``own``, or None when
    the record does not hold each of them exactly ``iters`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        prof.step()
    times, counts = dict.fromkeys(own, 0.0), dict.fromkeys(own, 0)
    for ev in prof.key_averages():
        name = next((o for o in own if o in ev.key), None)
        if name is None:
            continue
        t = getattr(ev, "self_device_time_total", None)
        times[name] += ev.self_cuda_time_total if t is None else t
        counts[name] += ev.count
    if any(c != iters for c in counts.values()):
        return None
    return {o: t / 1e3 / iters for o, t in times.items()}


def _times(fn, iters, records, own):
    """The median over ``records`` accepted records of a call's device ms,
    every record's, and each kernel's median."""
    got = []
    for _ in range(4 * records):
        split = _record_ms(fn, iters, own)
        if split is not None:
            got.append(split)
        if len(got) == records:
            totals = [sum(g.values()) for g in got]
            return (statistics.median(totals), totals,
                    {o: statistics.median(g[o] for g in got) for o in own})
    raise RuntimeError(f"torch.profiler's records missed kernels of {own}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--records", type=int, default=5)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("sweep_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.kmeans_assign import ops

    dev = torch.device("cuda")
    n, n_real, d, k, k_live, C = 4096, 2425, 256, 48, 40, 47
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((k, d)).astype(np.float32) * 5
    x_np = (centers[rng.integers(0, k, n)]
            + rng.standard_normal((n, d)).astype(np.float32))
    x = torch.from_numpy(x_np).to(dev)
    cent = torch.from_numpy(centers + 0.1 * rng.standard_normal(
        (k, d)).astype(np.float32)).to(dev)
    cmask = (torch.arange(k, device=dev) < k_live).float()
    pmask = (torch.arange(n, device=dev) < n_real).float()
    cent_b = torch.from_numpy(centers[None] + 0.1 * rng.standard_normal(
        (C, k, d)).astype(np.float32)).to(dev)
    ks = torch.arange(2, k + 1, device=dev)
    cmask_b = (torch.arange(k, device=dev)[None] < ks[:, None]).float()
    ws = ops.K2Workspace(C, n, k, d, dev)
    labels = ops.kmeans_assign_fused(x, cent, cmask, pmask)[0]
    sil = torch.zeros(n, device=dev)
    sil[torch.from_numpy(rng.choice(n_real, 1200, replace=False)).to(dev)] = 1
    onehot = (torch.nn.functional.one_hot(labels.long(), k).float()
              * sil[:, None]).contiguous()

    calls = [
        ("k2_one", lambda: ops.kmeans_assign_fused(x, cent, cmask, pmask),
         K2),
        ("k2_step", lambda: ops.kmeans_assign_fused_batched(
            x, cent_b, cmask_b, pmask, out=ws), K2),
        ("k3", lambda: ops.silhouette_sums(x, onehot), K3)]
    if "B" in inspect.signature(ops.K2Workspace).parameters:
        # a tree with the program axis: the sweep's step over 8 programs
        # (each its own points, 2425 - 100 b real, and centroids)
        B = 8
        xs = x[None].repeat(B, 1, 1) + torch.from_numpy(
            rng.standard_normal((B, n, d)).astype(np.float32)).to(dev)
        cents = cent_b[None].repeat(B, 1, 1, 1).contiguous()
        pmasks = torch.stack([(torch.arange(n, device=dev)
                               < n_real - 100 * b).float() for b in range(B)])
        ws8 = ops.K2Workspace(C, n, k, d, dev, B)
        calls.append(("k2_step_b8", lambda: ops.kmeans_assign_fused_batched(
            xs, cents, cmask_b, pmasks, out=ws8), K2))
    out = {"src": args.src}
    for key, fn, own in calls:
        fn()
        torch.cuda.synchronize()
        (out[f"{key}_ms"], out[f"{key}_records"],
         out[f"{key}_kernels"]) = _times(fn, args.iters, args.records, own)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    out["card"] = smi.stdout.strip().splitlines()[0] if smi.stdout else None
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
