"""GCL-Sampler serving pipeline (paper Fig. 2), counterpart of
``repro/core/sampler.py``:

  program -> traces -> HRGs -> (adopted) RGCN encoder -> kernel embeddings
  z_k -> K-Means (silhouette K) -> representatives -> SamplingPlan.

This class is the model behind the port's ``gcl`` sampling method.  Graphs
are traced sequentially with an in-process memo over the trace identity
(template, params, seed, window) — what the JAX ingestion engine does at
``workers=0``; the parallel engine and its on-disk graph store are not
ported.  Contrastive training arrives with the next slice: ``params`` must
be adopted (``repro_torch.interop.params_from_jax``).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.config import resolve_trace_caps
from repro_torch.core.graphs import KernelGraph, build_kernel_graph
from repro_torch.core.rgcn import RGCNConfig, RGCNEncoder
from repro_torch.core.train import ContrastiveTrainer, GCLTrainConfig
from repro_torch.sim.simulate import SamplingPlan
from repro_torch.tracing.programs import Program


@dataclass(frozen=True)
class GCLSamplerConfig:
    #: trace window; None = resolve per program (its `trace_caps`, else the
    #: defaults in repro_torch.config)
    cap_warps: Optional[int] = None
    cap_instr: Optional[int] = None
    k_max: int = 48
    rgcn: RGCNConfig = field(default_factory=RGCNConfig)
    train: GCLTrainConfig = field(default_factory=GCLTrainConfig)


class GCLSampler:
    #: distinct traced graphs kept in the in-process memo
    MEMO = 128

    def __init__(self, cfg: Optional[GCLSamplerConfig] = None, *,
                 device=None):
        self.cfg = cfg or GCLSamplerConfig()
        self.trainer = ContrastiveTrainer(self.cfg.rgcn, self.cfg.train,
                                          device=device)
        self.device = self.trainer.device
        self.params: Optional[RGCNEncoder] = None
        self._memo: OrderedDict[tuple, KernelGraph] = OrderedDict()
        self.ingest_stats = {"kernels": 0, "traced": 0, "memo_hits": 0}

    # -- stages --------------------------------------------------------------
    def _graph(self, inv, cap_warps: int, cap_instr: int) -> KernelGraph:
        key = (inv.template, repr(sorted(inv.params.items())), inv.seed,
               cap_warps, cap_instr)
        g = self._memo.get(key)
        if g is not None:
            self._memo.move_to_end(key)
            self.ingest_stats["memo_hits"] += 1
            return g
        g = build_kernel_graph(inv.trace(cap_warps, cap_instr))
        self.ingest_stats["traced"] += 1
        self._memo[key] = g
        while len(self._memo) > self.MEMO:
            self._memo.popitem(last=False)
        return g

    def iter_graphs(self, program: Program):
        """Lazy per-invocation trace + graph build, in program order;
        identical invocations are traced once."""
        cap_warps, cap_instr = resolve_trace_caps(
            self.cfg.cap_warps, self.cfg.cap_instr, program)
        self.ingest_stats["kernels"] += len(program.kernels)
        for inv in program.kernels:
            yield self._graph(inv, cap_warps, cap_instr)

    def build_graphs(self, program: Program) -> list[KernelGraph]:
        return list(self.iter_graphs(program))

    def _require_params(self) -> RGCNEncoder:
        if self.params is None:
            raise RuntimeError(
                "GCLSampler has no encoder: adopt one (e.g. JAX-trained "
                "params through repro_torch.interop.params_from_jax); "
                "training comes with the port's next slice")
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
