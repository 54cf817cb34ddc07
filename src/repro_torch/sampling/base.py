"""Copy of ``repro/sampling/base.py`` for the PyTorch port (imports rewritten to
``repro_torch``; the port imports nothing of ``repro``).

The one public surface for sampled-simulation methods.

A *sampling method* turns a traced :class:`~repro_torch.tracing.programs.Program`
into a :class:`~repro_torch.sim.simulate.SamplingPlan` in two stages:

    prepare(program) -> Artifacts     # the expensive, cacheable stage
    plan(program, artifacts) -> SamplingPlan

``prepare`` owns everything worth persisting (trained RGCN params, kernel
embeddings, profiled features, per-stage timings); ``plan`` is cheap and
deterministic given the artifacts.  The split is what lets the
:class:`~repro_torch.sampling.store.ArtifactStore` replay a trained GCL encoder
across programs and runs instead of refitting per call site.

All four paper methods (gcl / pka / sieve / stem_root) implement this
protocol and are registered under string keys in
:mod:`repro_torch.sampling.registry`.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.sim.simulate import SamplingPlan
from repro_torch.tracing.programs import Program


def plan_from_labels(
    labels: np.ndarray,
    seqs: np.ndarray,
    method: str,
    extra: Optional[dict] = None,
    *,
    priority: Optional[np.ndarray] = None,
    rep_selector: Optional[Callable[[int, np.ndarray], list]] = None,
) -> SamplingPlan:
    """Shared representative selection for every clustering-based method.

    Default rule (GCL-Sampler, PKA): representative = first invocation
    (min ``seq``) in each cluster.

    ``priority``: per-invocation score; candidates are restricted to the
    cluster members attaining the maximum priority, then min ``seq`` breaks
    ties (Sieve's "first kernel with the max CTA count" rule).

    ``rep_selector(cluster, members) -> list[int]``: full override returning
    one or MORE representative indices for a cluster (STEM+ROOT's
    error-model sample sizes).  Mutually exclusive with ``priority``.
    """
    if priority is not None and rep_selector is not None:
        raise ValueError("pass either priority or rep_selector, not both")
    labels = np.asarray(labels)
    seqs = np.asarray(seqs)
    reps: dict[int, list[int]] = {}
    for c in np.unique(labels):
        members = np.nonzero(labels == c)[0]
        if rep_selector is not None:
            chosen = rep_selector(int(c), members)
            reps[int(c)] = sorted({int(r) for r in chosen})
            continue
        if priority is not None:
            p = np.asarray(priority)[members]
            members = members[p == p.max()]
        first = members[np.argmin(seqs[members])]
        reps[int(c)] = [int(first)]
    return SamplingPlan(labels=labels, reps=reps, method=method,
                        extra=extra or {})


@dataclass
class Artifacts:
    """Everything a method's ``prepare`` stage produced, in storable form.

    ``payload`` values are numpy arrays or pytrees of arrays (nested
    dict/list, e.g. trained RGCN params); ``meta`` must be JSON-safe.
    ``provenance`` disambiguates artifacts whose content depends on state
    beyond (config, program) — e.g. a GCL encoder trained on a DIFFERENT
    program and reused here.
    """
    method: str                      # registry id, e.g. "gcl"
    program: str                     # program fingerprint (see store)
    config_hash: str                 # hash of the method's config()
    payload: dict[str, Any] = field(default_factory=dict)
    timings: dict[str, float] = field(default_factory=dict)
    meta: dict[str, Any] = field(default_factory=dict)
    provenance: str = ""             # extra key component (see docstring)

    @property
    def key(self) -> str:
        """Content key: same method + config + program (+ provenance) ->
        same artifacts."""
        base = f"{self.config_hash}-{self.program}"
        return f"{base}-{self.provenance}" if self.provenance else base


class SamplingMethod(abc.ABC):
    """Protocol every sampling method implements (see module docstring).

    Subclasses set ``id`` (registry key) and ``display_name`` (the
    ``SamplingPlan.method`` string used in tables/plots).
    """

    id: str = ""
    display_name: str = ""

    @abc.abstractmethod
    def config(self) -> dict:
        """JSON-safe configuration; hashed into the artifact content key."""

    @abc.abstractmethod
    def prepare(self, program: Program) -> Artifacts:
        """The expensive stage: train / profile / featurize."""

    @abc.abstractmethod
    def plan(self, program: Program, artifacts: Artifacts) -> SamplingPlan:
        """Cheap + deterministic given ``artifacts``."""

    def artifact_key(self, program: Program) -> str:
        """The content key ``prepare(program)`` would produce — the single
        source of truth shared by ``run``'s lookup and ``Artifacts.key``.
        Methods whose artifacts depend on instance state (e.g. a reused
        encoder) must override this consistently with their ``prepare``."""
        from repro_torch.sampling.store import program_fingerprint

        return f"{config_hash(self.config())}-{program_fingerprint(program)}"

    def attach_store(self, store) -> None:
        """Hook: called by ``run`` before prepare/load so methods with
        store-adjacent state (e.g. the GCL method's fit checkpoints under
        ``store.checkpoint_dir``) can pick the store up.  Default: nothing."""

    def run_prepare(self, program: Program, store=None) -> Artifacts:
        """The prepare half of ``run``: load-or-prepare(-and-save) through
        the store.  Exposed so grid drivers can prepare a whole program axis
        first and then serve every plan through ``plan_batch``."""
        artifacts = None
        if store is not None:
            self.attach_store(store)
            artifacts = store.load(self.id, self.artifact_key(program))
        if artifacts is None:
            artifacts = self.prepare(program)
            if store is not None:
                store.save(artifacts)
        else:
            self.adopt(artifacts)
        return artifacts

    def plan_request(self, program: Program, artifacts: Artifacts):
        """Engine-backed methods return the
        :class:`~repro_torch.sampling.engine.PlanRequest` their ``plan`` would
        serve through the PlanEngine (embeddings + seqs + seed), letting a
        server coalesce requests across methods and tenants
        (``repro_torch.serving.PlanService.submit_program``).  Methods that do
        not plan through the engine return None — servers fall back to
        their own ``plan``.  Default: None."""
        return None

    def plan_batch(self, items: list) -> list[SamplingPlan]:
        """Plan MANY prepared programs: ``items`` is [(program, artifacts)].

        Default: a plain loop over ``plan``.  Engine-backed methods (gcl,
        pka) override this to serve every program of a batch through one
        compiled multi-K sweep dispatch per size bucket
        (:class:`repro_torch.sampling.engine.PlanEngine`).
        """
        return [self.plan(p, a) for p, a in items]

    def run(self, program: Program, store=None) -> tuple[SamplingPlan, Artifacts]:
        """prepare + plan, with content-hash reuse through ``store``.

        When a store is given and already holds artifacts for
        (method, config, program), ``prepare`` is skipped entirely and the
        stored artifacts are replayed.
        """
        artifacts = self.run_prepare(program, store)
        return self.plan(program, artifacts), artifacts

    def adopt(self, artifacts: Artifacts) -> None:
        """Hook: absorb replayed artifacts into instance state (e.g. the GCL
        method picks up trained encoder params).  Default: nothing."""


def config_hash(cfg: dict) -> str:
    """Stable short hash of a JSON-safe config dict."""
    import hashlib
    import json

    blob = json.dumps(cfg, sort_keys=True, default=str).encode()
    return hashlib.sha1(blob).hexdigest()[:12]
