"""repro_torch.analysis — the port's invariant linter and runtime
sanitizers (counterpart of ``repro/analysis``).

The port advertises invariants that plain pytest cannot see: no host sync
inside a step, no order-dependent sums, no fallback from a hand-written
kernel to a plain version, copies not imports.  This package machine-checks
them two ways:

- **statically** — ``python -m repro_torch.analysis.lint`` (from the
  repository root) runs an AST pass over ``src/repro_torch`` with rules
  R1–R5 (:mod:`repro_torch.analysis.rules`) over a call graph that knows
  which functions are hot (:mod:`repro_torch.analysis.callgraph`), scans
  ``csrc/*.cu`` / ``*.cuh`` for float atomics, drops inline waivers and
  diffs the rest against a checked-in baseline (``baseline.json``), so
  accepted findings never fail while any NEW (or fixed but still listed)
  one does:

  - R1 host sync: ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()``,
    ``float/int/bool(<tensor>)``, ``np.asarray(<tensor>)``, a tensor tested
    as a Python bool, ``torch.cuda.synchronize`` in a hot function (the fit
    step and its step loop, the sweep and its dispatch, prefill, decode,
    the LM train step, every ``autograd.Function``'s forward / backward),
    or on a hot call's output inside a loop;
  - R2 build hazard: ``ctypes.CDLL``, ``nvcc`` or ``cpp_extension.load``
    outside ``kernels.build`` / ``library``; ``torch.compile`` /
    ``torch.jit``;
  - R3 RNG discipline: draws from torch's or numpy's global RNG, global
    seeding, literal seeds in library code;
  - R4 order-dependent sums: ``index_add_`` / ``scatter_add_`` /
    ``scatter_reduce_`` / ``index_put_(accumulate=True)``, ``index_select``
    and ``F.embedding`` on a gradient path; float ``atomicAdd`` in CUDA;
  - R5 kernel conformance: fallbacks (an ``except`` around a kernel that
    runs a plain version or carries on, a CPU pick on
    ``torch.cuda.is_available()``, a device default other than ``cuda``),
    library kernels outside plain versions, imports of ``jax`` / ``repro``,
    bfloat16 casts outside the precision policy.

  A waiver is a comment ``# lint: allow[R1] reason`` (``// lint:
  allow[R4] reason`` in CUDA) on the finding's line, the line above it, or
  the enclosing ``def`` line (function-wide); it must give its reason.
- **at runtime** — :mod:`repro_torch.analysis.sanitize`:
  :func:`~repro_torch.analysis.sanitize.recompile_guard` (a build budget on
  the kernel library) and the NaN/inf tripwire
  :func:`~repro_torch.analysis.sanitize.check_finite` /
  :func:`~repro_torch.analysis.sanitize.nan_tripwire`, which
  ``PlanService(sanitize=True)`` runs on every served plan.
"""

from __future__ import annotations

from repro_torch.analysis.rules import RULES, Finding
from repro_torch.analysis.sanitize import (
    GuardStats, NonFiniteError, RecompileError, check_finite, nan_tripwire,
    recompile_guard,
)

__all__ = [
    "Finding",
    "RULES",
    "GuardStats",
    "NonFiniteError",
    "RecompileError",
    "check_finite",
    "nan_tripwire",
    "recompile_guard",
]
