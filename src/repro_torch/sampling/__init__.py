"""repro_torch.sampling — the port's sampling API.

    from repro_torch.sampling import ArtifactStore, evaluate, get_method

    method = get_method("gcl", device="cuda")
    plan, artifacts = method.run(program, store=ArtifactStore("runs/x"))
    result = evaluate(plan, program, platform="P1")

The four paper methods are registered: ``gcl`` (fits its encoder in
``prepare`` unless one is adopted or replayed from the store), ``pka``,
``sieve`` and ``stem_root``.
"""

from repro_torch.sampling.base import (
    Artifacts, SamplingMethod, config_hash, plan_from_labels,
)
from repro_torch.sampling.engine import (
    PlanEngine, PlanEngineConfig, PlanRequest,
)
from repro_torch.sampling.evaluate import EvalResult, evaluate, evaluate_metrics
from repro_torch.sampling.registry import (
    SAMPLING_METHODS, available_methods, get_method, register_method,
)
from repro_torch.sampling.store import (
    ArtifactStore, flatten_tree, program_fingerprint, unflatten_tree,
)

__all__ = [
    "ArtifactStore", "Artifacts", "EvalResult", "PlanEngine", "PlanEngineConfig",
    "PlanRequest", "SAMPLING_METHODS", "SamplingMethod",
    "available_methods", "config_hash", "evaluate", "evaluate_metrics",
    "flatten_tree", "get_method", "plan_from_labels", "program_fingerprint",
    "register_method", "unflatten_tree",
]
