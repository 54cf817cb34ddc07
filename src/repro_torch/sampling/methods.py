"""The port's ``gcl`` sampling method (counterpart of ``GCLMethod`` in
``repro/sampling/methods.py``), registered in the port's own registry.

``prepare`` fits the contrastive encoder on the program's graphs when none
is adopted (on the method's device: ``cuda`` unless ``device="cpu"``), then
traces and embeds the program; ``plan`` / ``plan_request`` cluster through
the PlanEngine.  ``adopt`` takes trained params instead (JAX-trained ones
in ``flatten_tree`` layout, a nested pytree of arrays, or a port
``RGCNEncoder``), and one fitted encoder serves every later program.  Fit
checkpoints under ``prepare`` need the JAX package's ``ArtifactStore``,
which the port has not reached: ``checkpoint_every`` and ``resume`` are
accepted and recorded, and ``GCLSampler.train(checkpoint_dir=...)`` is the
resume entry point.  The baselines (pka / sieve / stem_root) come later.
"""

from __future__ import annotations

import time
from dataclasses import asdict, replace
from typing import Optional

import numpy as np

from repro_torch.core.rgcn import RGCNEncoder
from repro_torch.core.sampler import GCLSampler, GCLSamplerConfig
from repro_torch.interop import params_from_jax, params_to_numpy
from repro_torch.sampling.base import Artifacts, SamplingMethod, config_hash
from repro_torch.sampling.engine import PlanRequest
from repro_torch.sampling.registry import register_method
from repro_torch.sampling.store import flatten_tree, program_fingerprint
from repro_torch.sim.simulate import SamplingPlan
from repro_torch.tracing.programs import Program


def _seqs(program: Program) -> np.ndarray:
    return np.array([k.seq for k in program.kernels])


def _as_encoder(params, rc) -> RGCNEncoder:
    if isinstance(params, RGCNEncoder):
        return params
    if isinstance(params, dict) and any("/" in str(k) for k in params):
        return params_from_jax(params, rc)          # already flat
    return params_from_jax(flatten_tree(params), rc)


@register_method
class GCLMethod(SamplingMethod):
    """The paper's contribution, wrapping :class:`GCLSampler`."""

    id = "gcl"
    display_name = "GCL-Sampler"

    #: programs with at least this many invocations embed from a graph
    #: stream (bounded residency) instead of a materialized list
    STREAM_THRESHOLD = 512

    def __init__(self, cfg: Optional[GCLSamplerConfig] = None, *,
                 steps: Optional[int] = None,
                 batch_size: Optional[int] = None,
                 seed: Optional[int] = None,
                 checkpoint_every: Optional[int] = None,
                 resume: bool = True, device=None):
        cfg = cfg or GCLSamplerConfig()
        train_kw = {k: v for k, v in
                    [("steps", steps), ("batch_size", batch_size),
                     ("seed", seed), ("checkpoint_every", checkpoint_every)]
                    if v is not None}
        if train_kw:
            cfg = replace(cfg, train=replace(cfg.train, **train_kw))
        #: False = refit from scratch even where a fit checkpoint exists
        self.resume = resume
        self.cfg = cfg
        self.sampler = GCLSampler(self.cfg, device=device)
        self._trained_on: Optional[str] = None

    def config(self) -> dict:
        """JSON-safe config hashed into the artifact key; the checkpoint
        cadence is left out (it never changes the fitted encoder)."""
        cfg = asdict(self.cfg)
        cfg["train"].pop("checkpoint_every", None)
        return cfg

    def _encoder_provenance(self, program_fp: str) -> str:
        if self._trained_on and self._trained_on != program_fp:
            return f"enc-{self._trained_on}"
        return ""

    def artifact_key(self, program: Program) -> str:
        base = super().artifact_key(program)
        prov = self._encoder_provenance(program_fingerprint(program))
        return f"{base}-{prov}" if prov else base

    def prepare(self, program: Program) -> Artifacts:
        stream = len(program) >= self.STREAM_THRESHOLD
        t0 = time.time()
        graphs = None if stream else self.sampler.build_graphs(program)
        t1 = time.time()
        meta: dict = {"streaming": stream}
        if self.sampler.params is None:
            # n_total makes the streamed training subset the materialized
            # path's: streaming changes memory, not results
            info = (self.sampler.train_stream(
                        self.sampler.iter_graphs(program),
                        n_total=len(program), resume=self.resume)
                    if stream else
                    self.sampler.train(graphs, resume=self.resume))
            self._trained_on = program_fingerprint(program)
            meta["train"] = {
                k: info[k] for k in
                ("val_loss", "val_acc", "trunc_nodes", "engine",
                 "resumed_from", "checkpoint_saves", "host_syncs", "fit_s")
                if k in info}
        else:
            meta["encoder_reused"] = True
        meta["trained_on"] = self._trained_on
        t2 = time.time()
        if stream:
            emb = self.sampler.embed_stream(self.sampler.iter_graphs(program))
        else:
            emb = self.sampler.embed(graphs)
        t3 = time.time()
        meta["embed"] = {k: v for k, v in
                         self.sampler.trainer.embed_stats.items()
                         if k in ("cache_hits", "encoded", "microbatches")}
        meta["ingest"] = dict(self.sampler.ingest_stats)
        payload = {"params": params_to_numpy(self.sampler.params),
                   "embeddings": emb, "seqs": _seqs(program)}
        return Artifacts(
            method=self.id, program=program_fingerprint(program),
            config_hash=config_hash(self.config()), payload=payload,
            timings={"graphs_s": t1 - t0, "train_s": t2 - t1,
                     "embed_s": t3 - t2}, meta=meta,
            provenance=self._encoder_provenance(program_fingerprint(program)))

    def plan(self, program: Program, artifacts: Artifacts) -> SamplingPlan:
        return self.plan_batch([(program, artifacts)])[0]

    def plan_request(self, program: Program,
                     artifacts: Artifacts) -> PlanRequest:
        """The engine-ready request ``plan`` serves (``PlanService``)."""
        return PlanRequest(
            np.asarray(artifacts.payload["embeddings"]),
            np.asarray(artifacts.payload["seqs"]), self.display_name,
            seed=self.cfg.train.seed,
            extra=dict(artifacts.meta, timings=dict(artifacts.timings)))

    def plan_batch(self, items: list) -> list[SamplingPlan]:
        t0 = time.time()
        engine = self.sampler.plan_engine()
        plans = engine.plan_many([
            PlanRequest(np.asarray(a.payload["embeddings"]),
                        np.asarray(a.payload["seqs"]), self.display_name)
            for _, a in items])
        cluster_s = (time.time() - t0) / max(len(items), 1)
        for (_, artifacts), plan in zip(items, plans):
            plan.extra["timings"] = dict(artifacts.timings,
                                         cluster_s=cluster_s)
            plan.extra.update(artifacts.meta)
        return plans

    def adopt(self, artifacts: Artifacts) -> None:
        params = artifacts.payload.get("params")
        if params is not None:
            self.sampler.params = _as_encoder(params, self.cfg.rgcn)
            self._trained_on = artifacts.meta.get("trained_on",
                                                  artifacts.program)
