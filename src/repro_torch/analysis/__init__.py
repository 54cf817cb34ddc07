"""Runtime sanitizers of the port (counterpart of ``repro/analysis``):
:func:`~repro_torch.analysis.sanitize.recompile_guard` (a build budget on
the kernel library) and the NaN/inf tripwire
:func:`~repro_torch.analysis.sanitize.check_finite` /
:func:`~repro_torch.analysis.sanitize.nan_tripwire`, which
``PlanService(sanitize=True)`` runs on every served plan.

The JAX package's static linter (``lint.py``, ``rules.py``,
``callgraph.py``; its ``Finding`` and ``RULES``) checks JAX-specific
invariants and is not ported yet.
"""

from __future__ import annotations

from repro_torch.analysis.sanitize import (
    GuardStats, NonFiniteError, RecompileError, check_finite, nan_tripwire,
    recompile_guard,
)

__all__ = [
    "GuardStats",
    "NonFiniteError",
    "RecompileError",
    "check_finite",
    "nan_tripwire",
    "recompile_guard",
]
