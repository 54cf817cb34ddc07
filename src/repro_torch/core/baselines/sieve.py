"""Copy of ``repro/core/baselines/sieve.py`` for the PyTorch port (imports rewritten to
``repro_torch``; the port imports nothing of ``repro``).

Sieve (ISPASS'23) baseline.

Strict kernel-name partitioning, then per-name stratification on dynamic
instruction count when its coefficient of variation (CoV) is high; the
representative is the first kernel with the maximum CTA count in each
stratum, weighted by stratum size.

Name-keyed grouping is Sieve's crippling constraint on workloads whose
invocations carry distinct names (nw / lu / 3mm): every kernel becomes its
own cluster and no reduction is possible.

``sieve_partition`` produces the (labels, CTA-priority) pair; representative
selection goes through the shared ``repro_torch.sampling.plan_from_labels``.
``sieve_plan`` is the legacy free-function entry point — prefer
``repro_torch.sampling.get_method("sieve")``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.sampling.base import plan_from_labels
from repro_torch.sim.simulate import SamplingPlan
from repro_torch.tracing.programs import Program

COV_THRESHOLD = 0.10


def sieve_partition(program: Program, platform: str = "P1"):
    """Name partition + recursive CoV stratification.

    Returns ``(labels, ctas)``: cluster labels per invocation and the CTA
    counts used as the representative priority (Sieve's "first kernel with
    the max CTA count" rule).
    """
    names = [k.name for k in program.kernels]
    instrs = np.array([k.stats(platform).warp_instructions for k in program.kernels])
    ctas = np.array([k.stats(platform).ctas for k in program.kernels])

    labels = np.full(len(names), -1, int)
    next_label = 0
    for name in sorted(set(names)):
        idx = np.array([i for i, n in enumerate(names) if n == name])

        # recursive CoV stratification: split at the largest relative gap
        # until every stratum's instruction-count CoV is below threshold
        # (keeps near-identical counts together regardless of group size).
        def stratify(members):
            v = instrs[members]
            if len(members) < 2 or v.std() / max(v.mean(), 1e-9) <= COV_THRESHOLD:
                return [members]
            order = members[np.argsort(instrs[members])]
            sv = instrs[order]
            rel_gap = (sv[1:] - sv[:-1]) / np.maximum(sv[:-1], 1e-9)
            cut = int(np.argmax(rel_gap)) + 1
            return stratify(order[:cut]) + stratify(order[cut:])

        for stratum in stratify(idx):
            labels[stratum] = next_label
            next_label += 1
    return labels, ctas


def sieve_plan(program: Program, platform: str = "P1") -> SamplingPlan:
    """Deprecated shim — use ``repro_torch.sampling.get_method("sieve")``."""
    labels, ctas = sieve_partition(program, platform)
    seqs = np.array([k.seq for k in program.kernels])
    return plan_from_labels(labels, seqs, "Sieve", priority=ctas)
