"""Copy of ``repro/core/baselines/pka.py`` for the PyTorch port (imports rewritten to
``repro_torch``; the port imports nothing of ``repro``).

PKA (Principal Kernel Analysis, MICRO'21) baseline.

Twelve microarchitecture-independent profiling features per kernel
(instruction mix over 10 classes + log dynamic instruction count + log CTA
count), z-scored, K-Means with the same silhouette K-selection as
GCL-Sampler, representative = first invocation per cluster.

The feature set deliberately excludes working-set / access-pattern /
dependence structure — exactly the limited expressiveness the paper blames
for PKA's 20.9% average error: kernels with matching mixes but different
cache behavior or loop trip counts collapse into one cluster.

``pka_plan`` is the legacy free-function entry point — prefer
``repro_torch.sampling.get_method("pka")``.  In this copy it takes the
clustering ``device`` (the card unless ``"cpu"`` is asked for): it runs
the sequential reference, whose Lloyd steps launch K4.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.clustering import select_k_and_cluster
from repro_torch.sampling.base import plan_from_labels
from repro_torch.sim.simulate import SamplingPlan
from repro_torch.tracing.programs import Program


def pka_features(program: Program, platform="P1") -> np.ndarray:
    feats = []
    for k in program.kernels:
        st = k.stats(platform)
        mix = st.instr_mix  # (10,)
        feats.append(
            np.concatenate([
                mix,
                [np.log1p(st.warp_instructions)],
                [st.divergence],
            ])
        )
    x = np.asarray(feats, np.float32)
    mu, sd = x.mean(0), x.std(0)
    return (x - mu) / np.maximum(sd, 1e-6)


def pka_plan(program: Program, k_max=48, seed=0, device=None) -> SamplingPlan:
    """Deprecated shim — use ``repro_torch.sampling.get_method("pka")``."""
    x = pka_features(program)
    labels, info = select_k_and_cluster(x, k_max=k_max, seed=seed,
                                        device=device)
    seqs = np.array([k.seq for k in program.kernels])
    return plan_from_labels(labels, seqs, "PKA", extra=info)
