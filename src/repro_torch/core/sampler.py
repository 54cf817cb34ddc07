"""GCL-Sampler serving pipeline (paper Fig. 2), counterpart of
``repro/core/sampler.py``:

  program -> traces -> HRGs -> contrastive RGCN encoder (fitted here, or
  adopted) -> kernel embeddings z_k -> K-Means (silhouette K) ->
  representatives -> SamplingPlan.

This class is the model behind the port's ``gcl`` sampling method.  Graphs
are traced through the ingestion engine (``repro_torch.ingest``: worker
pool, dedup memo, optional on-disk graph store, program order kept), as in
JAX.  ``train`` / ``train_stream`` fit the encoder on a subsample of at
most ``train_subsample`` graphs (the same ``rng.choice`` draw as JAX);
``params`` may also be adopted (``repro_torch.interop.params_from_jax``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Optional

import numpy as np

from repro_torch.core.graphs import KernelGraph
from repro_torch.core.rgcn import RGCNConfig, RGCNEncoder
from repro_torch.core.train import ContrastiveTrainer, GCLTrainConfig
from repro_torch.sim.simulate import SamplingPlan
from repro_torch.tracing.programs import Program

if TYPE_CHECKING:  # layering: ingest imports core, so core types it lazily
    from repro_torch.ingest.engine import IngestConfig


def _default_ingest():
    from repro_torch.ingest.engine import IngestConfig

    return IngestConfig()


@dataclass(frozen=True)
class GCLSamplerConfig:
    #: trace window; None = resolve per program (its `trace_caps`, else the
    #: defaults in repro_torch.config)
    cap_warps: Optional[int] = None
    cap_instr: Optional[int] = None
    k_max: int = 48
    train_subsample: int = 400  # cap graphs used for contrastive training
    rgcn: RGCNConfig = field(default_factory=RGCNConfig)
    train: GCLTrainConfig = field(default_factory=GCLTrainConfig)
    #: trace->graph ingestion (workers/depth/cache): never changes results,
    #: only how fast graphs arrive (left out of artifact content keys)
    ingest: "IngestConfig" = field(default_factory=_default_ingest)


class GCLSampler:
    def __init__(self, cfg: Optional[GCLSamplerConfig] = None, *,
                 device=None):
        self.cfg = cfg or GCLSamplerConfig()
        self.trainer = ContrastiveTrainer(self.cfg.rgcn, self.cfg.train,
                                          device=device)
        self.device = self.trainer.device
        self.params: Optional[RGCNEncoder] = None
        from repro_torch.ingest.engine import IngestEngine

        self.ingest = IngestEngine(self.cfg.ingest)

    # -- stages --------------------------------------------------------------
    def attach_graph_store(self, graph_store) -> None:
        """Back the ingestion engine with an on-disk ``GraphStore``: warm
        runs then trace nothing."""
        self.ingest.store = graph_store

    def iter_graphs(self, program: Program):
        """Lazy per-invocation trace + graph build through the ingestion
        engine, in program order; identical invocations are built once."""
        c = self.cfg
        return self.ingest.iter_graphs(program, c.cap_warps, c.cap_instr)

    def build_graphs(self, program: Program) -> list[KernelGraph]:
        return list(self.iter_graphs(program))

    def training_graphs(self, graphs_iter, n_total=None) -> list:
        """The training subset of a graph iterator, at most
        ``train_subsample`` graphs, without materializing the rest.  With
        ``n_total`` known (a Program: one graph per invocation) it is the
        same ``rng.choice`` draw as ``train(build_graphs(...))`` makes;
        without it, reservoir sampling (same cap, another subset)."""
        cap = self.cfg.train_subsample
        rng = np.random.default_rng(self.cfg.train.seed)
        if n_total is not None:
            if n_total <= cap:
                return list(graphs_iter)
            sel = rng.choice(n_total, cap, replace=False)
            want = set(int(i) for i in sel)
            picked = {i: g for i, g in enumerate(graphs_iter) if i in want}
            return [picked[int(i)] for i in sel]
        buf: list[KernelGraph] = []
        for i, g in enumerate(graphs_iter):
            if len(buf) < cap:
                buf.append(g)
            else:
                j = int(rng.integers(0, i + 1))
                if j < cap:
                    buf[j] = g
        return buf

    def train_stream(self, graphs_iter, n_total=None, verbose=False,
                     checkpoint_dir=None, resume=True) -> dict:
        """Fit on ``training_graphs(graphs_iter, n_total)``."""
        return self.train(self.training_graphs(graphs_iter, n_total),
                          verbose=verbose, checkpoint_dir=checkpoint_dir,
                          resume=resume)

    def train(self, graphs: list[KernelGraph], verbose=False,
              checkpoint_dir=None, resume=True) -> dict:
        """Fit the encoder on at most ``train_subsample`` of the graphs;
        the fitted encoder becomes ``params``.  Returns the fit's info."""
        rng = np.random.default_rng(self.cfg.train.seed)
        if len(graphs) > self.cfg.train_subsample:
            sel = rng.choice(len(graphs), self.cfg.train_subsample,
                             replace=False)
            graphs = [graphs[i] for i in sel]
        self.params, info = self.trainer.fit(
            graphs, verbose=verbose, checkpoint_dir=checkpoint_dir,
            resume=resume)
        return info

    def _require_params(self) -> RGCNEncoder:
        if self.params is None:
            raise RuntimeError(
                "GCLSampler has no encoder: call train / train_stream (or "
                "the end-to-end fit(program)) first, or adopt one (e.g. "
                "JAX-trained params through "
                "repro_torch.interop.params_from_jax)")
        return self.params

    def embed(self, graphs: list[KernelGraph]) -> np.ndarray:
        """Packed-bucketed embed with a content-hash cache."""
        return self.trainer.embed(self._require_params(), graphs)

    def embed_stream(self, graphs_iter) -> np.ndarray:
        """Streaming ``embed`` over a graph iterator."""
        return self.trainer.embed_stream(self._require_params(), graphs_iter)

    def plan_engine(self):
        """The planning engine configured for this sampler (k_max and seed
        from the config, on the sampler's device)."""
        from repro_torch.sampling.engine import PlanEngine

        return PlanEngine(k_max=self.cfg.k_max, seed=self.cfg.train.seed,
                          device=self.device)

    def cluster(self, embeddings: np.ndarray, seqs: np.ndarray) -> SamplingPlan:
        return self.plan_engine().plan(embeddings, seqs, "GCL-Sampler")

    def fit(self, program: Program, verbose=False) -> SamplingPlan:
        """End to end: train on a subsample of the program's graphs (traced
        lazily), embed every invocation, cluster."""
        t0 = time.time()
        train_info = self.train_stream(self.iter_graphs(program),
                                       n_total=len(program), verbose=verbose)
        t1 = time.time()
        emb = self.embed_stream(self.iter_graphs(program))
        t2 = time.time()
        plan = self.cluster(emb, np.array([k.seq for k in program.kernels]))
        plan.extra.update(
            train=train_info, embed=dict(self.trainer.embed_stats),
            timings={"train_s": t1 - t0, "embed_s": t2 - t1,
                     "cluster_s": time.time() - t2})
        return plan
