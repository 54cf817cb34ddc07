"""The whole serving slice on the CPU: the port's ``PlanService`` against
the JAX ``gcl`` method, with one fixed encoder.

The JAX side adopts JAX ``init_rgcn`` params and runs ``prepare`` / ``plan``
/ ``evaluate``; the port adopts the same params (``flatten_tree`` layout)
and serves ``submit_program`` through a ``PlanService`` on the CPU.  K, the
representatives, eq. 5 and eq. 6 must be equal, and the embeddings agree
to 1e-5 relative to their largest magnitude.  Narrow widths keep it quick.
"""

import jax
import numpy as np
import pytest

from repro.core.rgcn import RGCNConfig as JRGCNConfig
from repro.core.rgcn import init_rgcn as jax_init_rgcn
from repro.core.sampler import GCLSamplerConfig as JSamplerConfig
from repro.sampling import Artifacts as JArtifacts
from repro.sampling import evaluate as jax_evaluate
from repro.sampling import get_method as jax_get_method
from repro.sampling.store import flatten_tree
from repro.tracing.programs import get_program as jax_get_program
from repro_torch.core.rgcn import RGCNConfig
from repro_torch.core.sampler import GCLSamplerConfig
from repro_torch.sampling import Artifacts, evaluate, get_method
from repro_torch.serving import PlanService
from repro_torch.tracing.programs import get_program

DIMS = (64, 32, 32, 48)


@pytest.fixture(scope="module")
def jparams():
    return jax_init_rgcn(jax.random.PRNGKey(7), JRGCNConfig(dims=DIMS))


@pytest.mark.parametrize("name", ["nw", "3mm"])
def test_served_plans_match_jax_gcl(name, jparams):
    jm = jax_get_method("gcl", cfg=JSamplerConfig(rgcn=JRGCNConfig(dims=DIMS)),
                        seed=0)
    jm.adopt(JArtifacts("gcl", "enc", "enc", payload={"params": jparams},
                        meta={"trained_on": "enc"}))
    jprog = jax_get_program(name)
    jart = jm.prepare(jprog)
    jplan = jm.plan(jprog, jart)
    jev = jax_evaluate(jplan, jprog, "P1")

    tm = get_method("gcl", cfg=GCLSamplerConfig(rgcn=RGCNConfig(dims=DIMS)),
                    seed=0, device="cpu")
    flat = {k: np.asarray(v) for k, v in flatten_tree(jparams).items()}
    tm.adopt(Artifacts("gcl", "enc", "enc", payload={"params": flat},
                       meta={"trained_on": "enc"}))
    prog = get_program(name)
    with PlanService(device="cpu", max_delay_ms=1.0) as svc:
        plan = svc.submit_program(tm, prog).result(timeout=600)
        stats = svc.stats()
    ev = evaluate(plan, prog, "P1")
    assert stats["served"] == 1 and stats["failed"] == 0

    z = tm.prepare(prog).payload["embeddings"]
    jz = np.asarray(jart.payload["embeddings"])
    np.testing.assert_allclose(z, jz, rtol=1e-5,
                               atol=1e-5 * float(np.abs(jz).max()))
    assert plan.num_clusters == jplan.num_clusters
    assert plan.rep_indices() == jplan.rep_indices()
    assert np.array_equal(plan.labels, jplan.labels)
    assert ev.error_pct["cycles"] == jev.error_pct["cycles"]
    assert ev.speedup == jev.speedup


def test_prepare_without_encoder_raises():
    """Embedding with no encoder raises and names the way out (train or
    adopt); ``prepare`` is that way out: with no adopted encoder it fits
    one (the port's training slice) instead of raising."""
    tm = get_method("gcl", cfg=GCLSamplerConfig(rgcn=RGCNConfig(dims=DIMS)),
                    steps=2, batch_size=4, device="cpu")
    prog = get_program("nw")
    with pytest.raises(RuntimeError, match="train"):
        tm.sampler.embed(tm.sampler.build_graphs(prog)[:2])
    art = tm.prepare(prog)
    assert "train" in art.meta and tm.sampler.params is not None


def test_entry_points_refuse_a_missing_card(monkeypatch):
    """Without a card and without an explicit CPU request the entry points
    raise; they never carry on on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_method("gcl")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PlanService()
