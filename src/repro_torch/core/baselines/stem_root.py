"""Copy of ``repro/core/baselines/stem_root.py`` for the PyTorch port (imports rewritten to
``repro_torch``; the port imports nothing of ``repro``).

STEM+ROOT (2025) baseline.

Name-keyed grouping like Sieve, but the per-name signature is the *profiled
execution-time distribution*: fine-grained hierarchical clustering (1-d
single-link with a relative gap threshold), then ROOT's statistical error
model picks MULTIPLE representatives per cluster:

    n_c = ceil((z * cov_c / eps)^2),  z = 1.96, eps = 0.25 (paper setup)

spread evenly over the cluster.  Consistently low error, at the cost of a
much larger representative set (the paper's 56.57x vs 258.94x speedup gap).

``stem_root_times``/``stem_root_partition`` produce the profile and the
(labels, multi-rep selector) pair; representative selection goes through
the shared ``repro_torch.sampling.plan_from_labels``.  ``stem_root_plan`` is the
legacy free-function entry point — prefer
``repro_torch.sampling.get_method("stem_root")``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.sampling.base import plan_from_labels
from repro_torch.sim.hardware import PLATFORMS
from repro_torch.sim.simulate import SamplingPlan
from repro_torch.sim.timing import simulate_batch, stack_stats
from repro_torch.tracing.programs import Program

Z_SCORE = 1.96
GAP_REL = 0.15  # relative gap threshold for splitting time clusters


def stem_root_times(program: Program, platform: str = "P1") -> np.ndarray:
    """Profiled per-invocation execution times (the STEM signature),
    timed in one vectorized `simulate_batch` pass."""
    hw = PLATFORMS[platform]
    stats = [k.stats(platform) for k in program.kernels]
    return np.asarray(simulate_batch(stack_stats(stats), hw).time_s)


def stem_root_partition(times: np.ndarray, names: list, eps: float = 0.25):
    """STEM clustering + ROOT's representative policy.

    Returns ``(labels, rep_selector)`` where ``rep_selector(cluster,
    members)`` implements ROOT's error-model sample size, spread evenly over
    the cluster's sorted times — plugged into ``plan_from_labels``.
    """
    times = np.asarray(times)
    labels = np.full(len(names), -1, int)
    next_label = 0
    for name in sorted(set(names)):
        idx = np.array([i for i, n in enumerate(names) if n == name])
        order = idx[np.argsort(times[idx])]
        t = times[order]
        # STEM: hierarchical 1-d split at large relative gaps
        clusters = [[order[0]]]
        for j in range(1, len(order)):
            prev_t = times[clusters[-1][-1]]
            if prev_t > 0 and (t[j] - prev_t) / max(prev_t, 1e-12) > GAP_REL:
                clusters.append([])
            clusters[-1].append(order[j])
        for members in clusters:
            labels[np.asarray(members)] = next_label
            next_label += 1

    def rep_selector(cluster: int, members: np.ndarray) -> list[int]:
        mt = times[members]
        cov = mt.std() / max(mt.mean(), 1e-12)
        # ROOT: sample size from the statistical error model
        n_rep = int(np.clip(np.ceil((Z_SCORE * cov / eps) ** 2), 1, len(members)))
        # spread representatives evenly across the sorted cluster
        pos = np.linspace(0, len(members) - 1, n_rep).round().astype(int)
        return members[np.argsort(mt)][pos].tolist()

    return labels, rep_selector


def stem_root_plan(program: Program, platform: str = "P1",
                   eps: float = 0.25) -> SamplingPlan:
    """Deprecated shim — use ``repro_torch.sampling.get_method("stem_root")``."""
    times = stem_root_times(program, platform)
    names = [k.name for k in program.kernels]
    seqs = np.array([k.seq for k in program.kernels])
    labels, rep_selector = stem_root_partition(times, names, eps)
    return plan_from_labels(labels, seqs, "STEM+ROOT",
                            rep_selector=rep_selector)
