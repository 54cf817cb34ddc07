"""The four paper methods behind one protocol (counterpart of
``repro/sampling/methods.py``), registered in the port's own registry.

| id          | display name | prepare() artifact            | plan()                          |
|-------------|--------------|-------------------------------|---------------------------------|
| `gcl`       | GCL-Sampler  | trained RGCN params + z_k     | silhouette K-Means on z_k       |
| `pka`       | PKA          | 12-d profiled feature matrix  | silhouette K-Means on features  |
| `sieve`     | Sieve        | name/CoV strata + CTA counts  | max-CTA representative          |
| `stem_root` | STEM+ROOT    | profiled execution times      | STEM strata + ROOT multi-rep    |

``gcl`` and ``pka`` plan through the port's ``PlanEngine`` on the method's
device (``cuda`` unless ``device="cpu"``): K2 / K3 run the sweep.  ``gcl``'s
``prepare`` fits the contrastive encoder on the program's graphs when none
is adopted; ``adopt`` takes trained params instead (JAX-trained ones in
``flatten_tree`` layout, a nested pytree of arrays, or a port
``RGCNEncoder``), and one fitted encoder serves every later program.  The
encoder goes into artifacts in the JAX ``flatten_tree`` layout
(``repro_torch.interop.params_to_numpy``).  ``sieve`` and ``stem_root`` are
numpy only.
"""

from __future__ import annotations

import time
from dataclasses import asdict, replace
from typing import Optional

import numpy as np

from repro_torch.core.baselines.pka import pka_features
from repro_torch.core.baselines.sieve import sieve_partition
from repro_torch.core.baselines.stem_root import (
    stem_root_partition, stem_root_times,
)
from repro_torch.core.rgcn import RGCNEncoder
from repro_torch.core.sampler import GCLSampler, GCLSamplerConfig
from repro_torch.interop import params_from_jax, params_to_numpy
from repro_torch.sampling.base import (
    Artifacts, SamplingMethod, config_hash, plan_from_labels,
)
from repro_torch.sampling.engine import PlanEngine, PlanRequest
from repro_torch.sampling.registry import register_method
from repro_torch.sampling.store import (
    flatten_tree, program_fingerprint, unflatten_tree,
)
from repro_torch.sim.simulate import SamplingPlan
from repro_torch.tracing.programs import Program


def _seqs(program: Program) -> np.ndarray:
    return np.array([k.seq for k in program.kernels])


def _artifacts(method: SamplingMethod, program: Program, payload: dict,
               timings: dict, meta: Optional[dict] = None,
               provenance: str = "") -> Artifacts:
    return Artifacts(
        method=method.id, program=program_fingerprint(program),
        config_hash=config_hash(method.config()), payload=payload,
        timings=timings, meta=meta or {}, provenance=provenance,
    )


#: fields of the JAX package's ``GCLSamplerConfig`` that the port's config
#: leaves out, at the one value the port computes: the XLA-or-Pallas switch
#: (the port always runs its kernels), f32 params, the scan engine, and an
#: optimizer without micro-batches (neither package's fit reads
#: ``TrainConfig.microbatch``)
_JAX_ONLY = {
    "rgcn": {"use_pallas": False},
    "rgcn.policy": {"param_dtype": "float32"},
    "train": {"engine": "scan"},
    "train.opt": {"microbatch": 0},
}


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

    #: auto-streaming threshold: programs with at least this many
    #: invocations embed from a graph stream (bounded residency)
    STREAM_THRESHOLD = 512

    def __init__(self, cfg: Optional[GCLSamplerConfig] = None, *,
                 steps: Optional[int] = None,
                 batch_size: Optional[int] = None,
                 cap_instr: Optional[int] = None,
                 k_max: Optional[int] = None,
                 seed: Optional[int] = None,
                 streaming: Optional[bool] = None,
                 engine: Optional[str] = None,
                 checkpoint_every: Optional[int] = None,
                 ingest_workers: Optional[int] = None,
                 graph_cache: Optional[bool] = None,
                 resume: bool = True, device=None):
        if engine not in (None, "scan"):
            raise ValueError(f"engine={engine!r}: the port trains with one "
                             f"engine, JAX's 'scan' (the python shim is not "
                             f"ported)")
        #: None = auto (stream iff len(program) >= STREAM_THRESHOLD);
        #: True/False force the streaming / materialized ingestion path
        self.streaming = streaming
        #: False = refit from scratch even where a fit checkpoint exists
        self.resume = resume
        cfg = cfg or GCLSamplerConfig()
        train_kw = {k: v for k, v in
                    [("steps", steps), ("batch_size", batch_size),
                     ("seed", seed), ("checkpoint_every", checkpoint_every)]
                    if v is not None}
        cfg_kw = {k: v for k, v in
                  [("cap_instr", cap_instr), ("k_max", k_max)]
                  if v is not None}
        if train_kw:
            cfg_kw["train"] = replace(cfg.train, **train_kw)
        ingest_kw = {k: v for k, v in
                     [("workers", ingest_workers), ("cache", graph_cache)]
                     if v is not None}
        if ingest_kw:
            cfg_kw["ingest"] = replace(cfg.ingest, **ingest_kw)
        self.cfg = replace(cfg, **cfg_kw) if cfg_kw else cfg
        self.sampler = GCLSampler(self.cfg, device=device)
        self._trained_on: Optional[str] = None
        self._store = None                      # set by attach_store

    def config(self) -> dict:
        """JSON-safe config hashed into the artifact key; the checkpoint
        cadence and the ingest config are left out (neither changes the
        fitted encoder or the embeddings).  The JAX config's fields that
        the port has no option for are filled in at the values the port
        computes (``_JAX_ONLY``), so both packages hash one config to one
        key and either replays the other's store."""
        cfg = asdict(self.cfg)
        cfg["train"].pop("checkpoint_every", None)
        cfg.pop("ingest", None)
        for path, fields in _JAX_ONLY.items():
            node = cfg
            for part in path.split("."):
                node = node[part]
            node.update(fields)
        return dict(cfg, streaming=self.streaming)

    def attach_store(self, store) -> None:
        """Remember the store so ``prepare`` places fit checkpoints under
        ``store.checkpoint_dir`` (an interrupted prepare resumes from the
        last snapshot), and back ingestion with the run's graph cache."""
        self._store = store
        if self.cfg.ingest.cache and hasattr(store, "graph_store"):
            self.sampler.attach_graph_store(store.graph_store())

    def _fit_checkpoint_dir(self, program: Program) -> Optional[str]:
        if self._store is None or self.cfg.train.checkpoint_every <= 0:
            return None
        # a fit only happens with no adopted encoder, so the provenance
        # suffix is empty and this is the artifact's own key
        return self._store.checkpoint_dir(self.id, self.artifact_key(program))

    def _use_streaming(self, program: Program) -> bool:
        if self.streaming is not None:
            return self.streaming
        return len(program) >= self.STREAM_THRESHOLD

    def _encoder_provenance(self, program_fp: str) -> str:
        if self._trained_on and self._trained_on != program_fp:
            return f"enc-{self._trained_on}"
        return ""

    def artifact_key(self, program: Program) -> str:
        base = super().artifact_key(program)
        prov = self._encoder_provenance(program_fingerprint(program))
        return f"{base}-{prov}" if prov else base

    def prepare(self, program: Program) -> Artifacts:
        stream = self._use_streaming(program)
        t0 = time.time()
        graphs = None if stream else self.sampler.build_graphs(program)
        t1 = time.time()
        meta: dict = {"streaming": stream}
        if self.sampler.params is None:
            ckpt = dict(checkpoint_dir=self._fit_checkpoint_dir(program),
                        resume=self.resume)
            # n_total makes the streamed training subset the materialized
            # path's: streaming changes memory, not results
            info = (self.sampler.train_stream(
                        self.sampler.iter_graphs(program),
                        n_total=len(program), **ckpt)
                    if stream else self.sampler.train(graphs, **ckpt))
            self._trained_on = program_fingerprint(program)
            # JAX's keys: ``engine`` is the hashed config's (the scan
            # engine's step for step, run eagerly); ``step_compiles`` counts
            # the step executables JAX compiles, and eager PyTorch compiles
            # none; the step loop's seconds go to the timings
            info = dict(info, engine=_JAX_ONLY["train"]["engine"],
                        step_compiles=0)
            fit_s = info.pop("fit_s", None)
            meta["train"] = {
                k: info[k] for k in
                ("val_loss", "val_acc", "trunc_nodes", "step_compiles",
                 "engine", "resumed_from", "checkpoint_saves", "host_syncs")
                if k in info}
        else:
            meta["encoder_reused"] = True
            fit_s = None
        meta["trained_on"] = self._trained_on
        t2 = time.time()
        if stream:
            # one micro-batch of graphs resident at a time
            emb = self.sampler.embed_stream(self.sampler.iter_graphs(program))
            meta["embed"] = {
                k: v for k, v in self.sampler.trainer.embed_stats.items()
                if k in ("cache_hits", "encoded", "microbatches",
                         "peak_resident_graphs", "peak_resident_nodes")}
        else:
            emb = self.sampler.embed(graphs)
        t3 = time.time()
        ing = self.sampler.ingest
        meta["ingest"] = {
            "workers": self.cfg.ingest.workers,
            "kernels": ing.stats["kernels"], "traced": ing.stats["traced"],
            "memo_hits": ing.stats["memo_hits"],
            "store_hits": ing.stats["store_hits"],
            "corrupt": ing.stats["corrupt"],
            "overlap_fraction": round(ing.overlap_fraction, 4),
        }
        payload = {"params": unflatten_tree(params_to_numpy(
                       self.sampler.params)),
                   "embeddings": emb, "seqs": _seqs(program)}
        timings = {"graphs_s": t1 - t0, "train_s": t2 - t1, "embed_s": t3 - t2}
        if fit_s is not None:
            timings["fit_s"] = fit_s      # the step loop alone
        return _artifacts(
            self, program, payload, timings, meta,
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


@register_method
class PKAMethod(SamplingMethod):
    id = "pka"
    display_name = "PKA"

    def __init__(self, platform: str = "P1", k_max: int = 48, seed: int = 0,
                 device=None):
        self.platform = platform
        self.k_max = k_max
        self.seed = seed
        self.device = device

    def config(self) -> dict:
        """The JAX method's config: artifacts keep its content keys."""
        return {"platform": self.platform, "k_max": self.k_max,
                "seed": self.seed}

    def prepare(self, program: Program) -> Artifacts:
        t0 = time.time()
        x = pka_features(program, self.platform)
        return _artifacts(self, program, {"features": x},
                          {"features_s": time.time() - t0})

    def plan(self, program: Program, artifacts: Artifacts) -> SamplingPlan:
        return self.plan_batch([(program, artifacts)])[0]

    def plan_request(self, program: Program,
                     artifacts: Artifacts) -> PlanRequest:
        return PlanRequest(
            np.asarray(artifacts.payload["features"]), _seqs(program),
            self.display_name, seed=self.seed,
            extra={"timings": dict(artifacts.timings)})

    def plan_batch(self, items: list) -> list[SamplingPlan]:
        t0 = time.time()
        engine = PlanEngine(k_max=self.k_max, seed=self.seed,
                            device=self.device)
        plans = engine.plan_many([
            PlanRequest(np.asarray(a.payload["features"]), _seqs(p),
                        self.display_name)
            for p, a in items])
        cluster_s = (time.time() - t0) / max(len(items), 1)
        for (_, artifacts), plan in zip(items, plans):
            plan.extra["timings"] = dict(artifacts.timings,
                                         cluster_s=cluster_s)
        return plans


@register_method
class SieveMethod(SamplingMethod):
    id = "sieve"
    display_name = "Sieve"

    def __init__(self, platform: str = "P1"):
        self.platform = platform

    def config(self) -> dict:
        return {"platform": self.platform}

    def prepare(self, program: Program) -> Artifacts:
        t0 = time.time()
        labels, ctas = sieve_partition(program, self.platform)
        return _artifacts(self, program, {"labels": labels, "priority": ctas},
                          {"partition_s": time.time() - t0})

    def plan(self, program: Program, artifacts: Artifacts) -> SamplingPlan:
        plan = plan_from_labels(
            np.asarray(artifacts.payload["labels"]), _seqs(program),
            self.display_name,
            priority=np.asarray(artifacts.payload["priority"]))
        plan.extra["timings"] = dict(artifacts.timings)
        return plan


@register_method
class StemRootMethod(SamplingMethod):
    id = "stem_root"
    display_name = "STEM+ROOT"

    def __init__(self, platform: str = "P1", eps: float = 0.25):
        self.platform = platform
        self.eps = eps

    def config(self) -> dict:
        return {"platform": self.platform, "eps": self.eps}

    def prepare(self, program: Program) -> Artifacts:
        t0 = time.time()
        times = stem_root_times(program, self.platform)
        return _artifacts(self, program, {"times": times},
                          {"profile_s": time.time() - t0})

    def plan(self, program: Program, artifacts: Artifacts) -> SamplingPlan:
        names = [k.name for k in program.kernels]
        labels, rep_selector = stem_root_partition(
            np.asarray(artifacts.payload["times"]), names, self.eps)
        plan = plan_from_labels(labels, _seqs(program), self.display_name,
                                rep_selector=rep_selector)
        plan.extra["timings"] = dict(artifacts.timings)
        return plan
