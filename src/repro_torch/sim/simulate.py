"""Copy of ``repro/sim/simulate.py`` for the PyTorch port (imports rewritten to
``repro_torch``; the port imports nothing of ``repro``).

Full vs sampled simulation: run the timing model over a program, apply a
SamplingPlan (clusters + representatives + weights), reconstruct full-workload
metrics, and compute the paper's error (eq. 5) and speedup (eq. 6).

The program path is vectorized end to end: :func:`simulate_program` stacks
the per-kernel stats (SoA) and times the WHOLE program in one
:func:`~repro_torch.sim.timing.simulate_batch` pass, returning a
:class:`~repro_torch.sim.timing.BatchKernelMetrics` (sequence-compatible with the
old ``list[KernelMetrics]``).  Reconstruction / speedup / wall-time read the
metric arrays directly instead of looping kernels.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.sim.hardware import PLATFORMS
from repro_torch.sim.timing import BatchKernelMetrics, simulate_batch, stack_stats
from repro_torch.tracing.programs import Program

METRIC_NAMES = ("cycles", "ipc", "l1_hit", "l2_hit", "occupancy")


@dataclass
class SamplingPlan:
    """labels[i] = cluster of invocation i; reps[c] = representative
    invocation indices (usually one; STEM+ROOT may pick several)."""
    labels: np.ndarray               # (n_kernels,) int
    reps: dict[int, list[int]]       # cluster -> kernel indices
    method: str = ""
    extra: dict = field(default_factory=dict)

    @property
    def num_clusters(self) -> int:
        return len(self.reps)

    def rep_indices(self) -> list[int]:
        out = set()
        for v in self.reps.values():
            out.update(v)
        return sorted(out)


def simulate_program(program: Program,
                     platform: str = "P1") -> BatchKernelMetrics:
    """Time every kernel of `program` in ONE vectorized pass.  The result
    supports the old list protocol (len / [i] / iteration) on top of the
    SoA metric arrays."""
    hw = PLATFORMS[platform]
    return simulate_batch(
        stack_stats([k.stats(platform) for k in program.kernels]), hw)


def _metric_arrays(metrics):
    """(cycles, per-metric arrays) for list-of-KernelMetrics or
    BatchKernelMetrics inputs — the batch form is a zero-copy view."""
    if not isinstance(metrics, BatchKernelMetrics):
        metrics = BatchKernelMetrics.from_list(list(metrics))
    return metrics


def _weighted_metrics(metrics, weights, indices=None):
    """Aggregate: cycles = weighted sum; rates/IPC = cycle-weighted mean."""
    m = _metric_arrays(metrics)
    cycles = m.cycles if indices is None else m.cycles[indices]
    w = np.asarray(weights, np.float64)
    tot_cycles = float(np.sum(cycles * w))
    cw = cycles * w
    denom = max(tot_cycles, 1e-12)
    out = {"cycles": tot_cycles}
    for name in ("ipc", "l1_hit", "l2_hit", "occupancy"):
        vals = getattr(m, name)
        if indices is not None:
            vals = vals[indices]
        out[name] = float(np.sum(vals * cw) / denom)
    return out


def reconstruct(plan: SamplingPlan, metrics):
    """Sampled estimate: each cluster contributes the mean of its
    representatives' metrics scaled by the cluster's invocation count."""
    reps, weights = [], []
    for c, rep_idx in plan.reps.items():
        count = int(np.sum(plan.labels == c))
        share = count / len(rep_idx)
        for r in rep_idx:
            reps.append(r)
            weights.append(share)
    return _weighted_metrics(metrics, weights, indices=np.asarray(reps, int))


def full_metrics(metrics):
    return _weighted_metrics(metrics, np.ones(len(metrics)))


def sampling_error(plan: SamplingPlan, metrics, name="cycles"):
    """Paper eq. 5: |full - sampled| / full * 100%."""
    full = full_metrics(metrics)[name]
    sampled = reconstruct(plan, metrics)[name]
    return abs(full - sampled) / max(abs(full), 1e-12) * 100.0


def speedup(plan: SamplingPlan, metrics) -> float:
    """Paper eq. 6: full kernel execution time / representative exec time."""
    m = _metric_arrays(metrics)
    # sequential sums (not np pairwise) keep the golden fixture bit-stable
    full_t = sum(m.time_s.tolist())
    rep_t = sum(m.time_s[plan.rep_indices()].tolist())
    return full_t / max(rep_t, 1e-12)


def sim_wall_time(metrics, indices=None) -> float:
    """End-to-end simulator wall-time (§5.4) for all or selected kernels."""
    m = _metric_arrays(metrics)
    if indices is None:
        return sum(m.sim_time_s.tolist())
    return sum(m.sim_time_s[np.asarray(list(indices), int)].tolist())
