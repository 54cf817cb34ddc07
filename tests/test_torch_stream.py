"""The port's streaming embed and its gcl artifact ``meta`` against the JAX
package's, on the CPU.

Twins of ``tests/test_workloads.py``'s streaming tests: ``embed_stream``
equals the materialized ``embed`` (1e-5, as there) while holding at most one
micro-batch budget of graphs (the residency bound of ``stream_pack``), and
the streaming gcl plan equals the materialized one.  Then the artifact's
``meta`` of both packages on nw, streaming and not: the same keys at every
level (``meta["embed"]`` only when streaming, with the peak residency;
``meta["train"]`` with JAX's keys and the hashed config's engine).
"""

import numpy as np
import pytest
import torch

from repro.sampling import get_method as jax_get_method
from repro_torch.core.batching import MAX_NODES_PER_MICROBATCH
from repro_torch.core.sampler import GCLSampler, GCLSamplerConfig
from repro_torch.core.train import GCLTrainConfig
from repro_torch.sampling import get_method
from repro_torch.tracing.programs import get_program
from repro_torch.workloads import (
    ScenarioSpec, build_scenario, iter_program_graphs, stream_pack,
)

SMALL = dict(phases=2, phase_len=4)
CPU = torch.device("cpu")


def _tiny_sampler():
    return GCLSampler(GCLSamplerConfig(
        cap_warps=1, cap_instr=32,
        train=GCLTrainConfig(steps=4, batch_size=4)), device=CPU)


def test_stream_pack_peak_residency_bounded_by_one_bucket():
    prog = build_scenario(ScenarioSpec("long_tail", seed=0, phases=3,
                                       phase_len=8))
    max_nodes, max_edges, max_graphs = 2048, 4096, 16
    stats: dict = {}
    seen = 0
    for batch, meta, _ in stream_pack(
            iter_program_graphs(prog, 1, 32), max_nodes=max_nodes,
            max_edges=max_edges, max_graphs=max_graphs, stats=stats):
        seen += meta.n_graphs
        assert meta.n_graphs <= max_graphs
        assert batch["node_mask"].sum() <= max_nodes
    assert seen == len(prog)
    assert 0 < stats["peak_resident_graphs"] <= max_graphs
    assert stats["peak_resident_nodes"] <= max_nodes
    assert stats["peak_resident_graphs"] < len(prog)


def test_embed_stream_matches_materialized_embed():
    prog = build_scenario(ScenarioSpec("long_tail", seed=1, **SMALL))
    s = _tiny_sampler()
    graphs = s.build_graphs(prog)
    s.train(graphs)
    dense = s.embed(graphs)
    s.trainer._embed_cache.clear()
    stream = s.embed_stream(s.iter_graphs(prog))
    assert stream.shape == dense.shape
    np.testing.assert_allclose(stream, dense, atol=1e-5)
    st = s.trainer.embed_stats
    assert st["streaming"] and st["graphs"] == len(prog)
    assert st["peak_resident_graphs"] < max(len(prog), 2)
    assert 0 < st["peak_resident_nodes"] <= MAX_NODES_PER_MICROBATCH


def test_gcl_method_streaming_plan_matches_materialized():
    prog = build_scenario(ScenarioSpec("pipeline", seed=0, **SMALL))
    kw = dict(steps=4, batch_size=4, cap_instr=32, device=CPU)
    plan_s, art_s = get_method("gcl", streaming=True, **kw).run(prog)
    plan_m, art_m = get_method("gcl", streaming=False, **kw).run(prog)
    np.testing.assert_array_equal(plan_s.labels, plan_m.labels)
    assert plan_s.reps == plan_m.reps
    assert art_s.meta["streaming"] and not art_m.meta["streaming"]
    assert "peak_resident_graphs" in art_s.meta["embed"]
    assert "embed" not in art_m.meta
    assert art_s.key != art_m.key


def _key_tree(d):
    return {k: _key_tree(v) if isinstance(v, dict) else None
            for k, v in d.items()}


@pytest.mark.parametrize("streaming", [False, True])
def test_gcl_meta_has_jax_keys(streaming):
    """nw prepared by both packages (a short fit): the same meta keys at
    every level, the hashed engine, and the same config hash."""
    kw = dict(steps=3, batch_size=4, cap_instr=32, streaming=streaming)
    prog = get_program("nw")
    mine = get_method("gcl", device=CPU, **kw).prepare(prog)
    theirs = jax_get_method("gcl", **kw).prepare(prog)
    assert _key_tree(mine.meta) == _key_tree(theirs.meta)
    assert mine.meta["train"]["engine"] == theirs.meta["train"]["engine"]
    assert mine.meta["train"]["step_compiles"] == 0
    assert mine.config_hash == theirs.config_hash
    assert ("embed" in mine.meta) is streaming
    assert "fit_s" in mine.timings and "fit_s" not in mine.meta["train"]
