"""Copy of ``repro/workloads/spec.py`` for the PyTorch port (imports rewritten to
``repro_torch``; the port imports nothing of ``repro``).

Seeded, reproducible scenario specifications.

A :class:`ScenarioSpec` fully determines one generated program: the family
(which generator composes kernel templates into a phase-structured stream),
the seed (every stochastic choice inside the generator), and a small set of
size knobs.  Specs round-trip through program names (``scn:<family>:k=v,...``)
so the launch grid, the `PROGRAMS` registry, and the artifact store can all
address generated programs by string, and two specs that differ in ANY field
— including the seed — hash to different content keys.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import asdict, dataclass, fields

SCN_PREFIX = "scn:"


@dataclass(frozen=True)
class ScenarioSpec:
    """One generated workload.  All fields are JSON-safe and round-trip
    through :meth:`name` / :func:`spec_from_name`.

    family    — generator id in `repro_torch.workloads.scenarios.FAMILIES`
    seed      — drives every stochastic choice (sizes, mixes, orderings)
    phases    — number of program phases (meaning is family-specific:
                convergence stages, pipeline frames, behavior shifts)
    phase_len — invocations (or distinct kernels, for `long_tail`) per phase
    scale     — multiplier on problem sizes (working sets, matrix dims)
    skew      — Zipf exponent for invocation-count skew (`long_tail`)
    """

    family: str
    seed: int = 0
    phases: int = 3
    phase_len: int = 12
    scale: float = 1.0
    skew: float = 1.2

    def __post_init__(self):
        # canonicalize field types so ScenarioSpec(scale=2) and
        # ScenarioSpec(scale=2.0) are the SAME spec (equal, same hash,
        # same name) — the name round-trip below depends on it
        for f in ("seed", "phases", "phase_len"):
            object.__setattr__(self, f, int(getattr(self, f)))
        for f in ("scale", "skew"):
            object.__setattr__(self, f, float(getattr(self, f)))

    def to_dict(self) -> dict:
        return asdict(self)

    @property
    def name(self) -> str:
        """Program name; omits fields left at their default.  Floats use
        repr (exact shortest round-trip), so spec -> name -> spec is
        lossless for every representable value."""
        parts = []
        for f in fields(self):
            if f.name == "family":
                continue
            v = getattr(self, f.name)
            if v != f.default:
                parts.append(f"{f.name}={v!r}")
        suffix = f":{','.join(parts)}" if parts else ""
        return f"{SCN_PREFIX}{self.family}{suffix}"

    def content_hash(self) -> str:
        """Stable hash over ALL fields (not just the non-default ones in the
        name) — folded into `program_fingerprint` so same-named programs
        from different specs/seeds never collide in the ArtifactStore."""
        blob = json.dumps(self.to_dict(), sort_keys=True).encode()
        return hashlib.sha1(blob).hexdigest()[:12]

    def rng_seed(self) -> list:
        """Entropy for numpy Generators: every field contributes."""
        return [int(hashlib.sha1(self.content_hash().encode())
                    .hexdigest()[:8], 16)]

    def kernel_seed(self) -> int:
        """Per-program seed handed to `make_kernel` (feeds the tracer RNG),
        so two seeds produce different traces, not just different params."""
        return int(self.content_hash()[:8], 16) % (2**31 - 1)


_FIELD_TYPES = {f.name: f.type for f in fields(ScenarioSpec)}


def is_scenario_name(name: str) -> bool:
    return name.startswith(SCN_PREFIX)


def spec_from_name(name: str) -> ScenarioSpec:
    """Inverse of :attr:`ScenarioSpec.name`.

    ``scn:pipeline`` / ``scn:long_tail:seed=3,phase_len=24`` ->
    :class:`ScenarioSpec`.  Raises ValueError on malformed names.
    """
    if not is_scenario_name(name):
        raise ValueError(f"not a scenario name (want {SCN_PREFIX!r} prefix): "
                         f"{name!r}")
    body = name[len(SCN_PREFIX):]
    family, _, kvs = body.partition(":")
    if not family:
        raise ValueError(f"scenario name {name!r} has no family")
    kwargs: dict = {}
    for part in filter(None, kvs.split(",")):
        key, eq, val = part.partition("=")
        if not eq or key not in _FIELD_TYPES or key == "family":
            raise ValueError(f"bad scenario field {part!r} in {name!r}")
        try:
            kwargs[key] = float(val) if key in ("scale", "skew") else int(val)
        except ValueError:
            raise ValueError(
                f"bad scenario value {part!r} in {name!r}: "
                f"{key} wants {'a float' if key in ('scale', 'skew') else 'an int'}"
            ) from None
    return ScenarioSpec(family=family, **kwargs)
