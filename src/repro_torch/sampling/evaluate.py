"""Copy of ``repro/sampling/evaluate.py`` for the PyTorch port (imports rewritten to
``repro_torch``; the port imports nothing of ``repro``).

Single evaluation harness for every sampling method.

Owns the full-vs-sampled comparison that callers used to re-derive by hand
from :mod:`repro_torch.sim.simulate` primitives: weighted reconstruction, the
paper's error (eq. 5) over every metric, kernel-time speedup (eq. 6), and
simulator wall-time reduction (§5.4) — one call, one result object,
JSON-ready.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field

from repro_torch.sim.simulate import (
    METRIC_NAMES, SamplingPlan, _metric_arrays, full_metrics, reconstruct,
    sim_wall_time, simulate_program,
)
from repro_torch.tracing.programs import Program


@dataclass
class EvalResult:
    method: str                      # display name (plan.method)
    program: str
    platform: str
    num_kernels: int
    num_clusters: int
    num_reps: int
    error_pct: dict[str, float]      # eq. 5 per metric (cycles, ipc, ...)
    speedup: float                   # eq. 6 (kernel execution time)
    sim_time_full_s: float           # §5.4 simulator wall time
    sim_time_sampled_s: float
    full: dict[str, float]           # reconstructed full-workload metrics
    sampled: dict[str, float]
    timings: dict[str, float] = field(default_factory=dict)

    @property
    def sim_speedup(self) -> float:
        return self.sim_time_full_s / max(self.sim_time_sampled_s, 1e-12)

    def to_dict(self) -> dict:
        d = asdict(self)
        d["sim_speedup"] = self.sim_speedup
        return d


def evaluate_metrics(plan: SamplingPlan, metrics,
                     program: str = "", platform: str = "") -> EvalResult:
    """Evaluate a plan against already-simulated per-kernel metrics
    (``BatchKernelMetrics`` from the vectorized path, or a legacy
    ``list[KernelMetrics]``)."""
    m = _metric_arrays(metrics)
    full = full_metrics(m)
    sampled = reconstruct(plan, m)
    reps = plan.rep_indices()
    error = {
        name: abs(full[name] - sampled[name]) / max(abs(full[name]), 1e-12)
        * 100.0
        for name in METRIC_NAMES
    }
    # sequential sums (not np pairwise) keep the golden fixture bit-stable
    full_t = sum(m.time_s.tolist())
    rep_t = sum(m.time_s[reps].tolist())
    return EvalResult(
        method=plan.method, program=program, platform=platform,
        num_kernels=len(metrics), num_clusters=plan.num_clusters,
        num_reps=len(reps), error_pct=error,
        speedup=full_t / max(rep_t, 1e-12),
        sim_time_full_s=sim_wall_time(metrics),
        sim_time_sampled_s=sim_wall_time(metrics, reps),
        full=full, sampled=sampled,
        timings=dict(plan.extra.get("timings", {})),
    )


def evaluate(plan: SamplingPlan, program: Program,
             platform: str = "P1") -> EvalResult:
    """Simulate `program` on `platform` and evaluate `plan` against it."""
    metrics = simulate_program(program, platform)
    return evaluate_metrics(plan, metrics, program=program.name,
                            platform=platform)
