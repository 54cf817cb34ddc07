"""The port's copies of the numpy-only modules give what their originals
give, bit for bit: traces, graphs, packed batches, simulated metrics, plans
and program fingerprints, on a few paper programs."""

import dataclasses

import numpy as np
import pytest

import repro.core.batching as j_batching
import repro.core.graphs as j_graphs
import repro.sampling.base as j_base
import repro.sampling.store as j_store
import repro.sim.timing as j_timing
import repro.tracing.programs as j_programs
import repro_torch.core.batching as t_batching
import repro_torch.core.graphs as t_graphs
import repro_torch.sampling.base as t_base
import repro_torch.sampling.store as t_store
import repro_torch.sim.timing as t_timing
import repro_torch.tracing.programs as t_programs
from repro.sampling.evaluate import evaluate as j_evaluate
from repro.sim.hardware import PLATFORMS as J_PLATFORMS
from repro_torch.sampling.evaluate import evaluate as t_evaluate
from repro_torch.sim.hardware import PLATFORMS as T_PLATFORMS

PROGRAMS = ["nw", "3mm", "backprop", "bfs"]


def _same_arrays(a, b):
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


def _kernels(name, limit=6):
    jp, tp = j_programs.get_program(name), t_programs.get_program(name)
    assert len(jp) == len(tp)
    return list(zip(jp.kernels, tp.kernels))[:limit]


@pytest.mark.parametrize("name", PROGRAMS)
def test_trace_and_graph_are_bit_equal(name):
    for jk, tk in _kernels(name):
        jt, tt = jk.trace(), tk.trace()
        assert len(jt) == len(tt)
        for a, b in zip(jt, tt):
            _same_arrays(a, b)
        _same_arrays(j_graphs.build_kernel_graph(jt),
                     t_graphs.build_kernel_graph(tt))


@pytest.mark.parametrize("name", PROGRAMS)
def test_pack_graphs_is_bit_equal(name):
    ks = _kernels(name)
    jb, jm = j_batching.pack_graphs(
        [j_graphs.build_kernel_graph(jk.trace()) for jk, _ in ks],
        pad_graphs_to=8)
    tb, tm = t_batching.pack_graphs(
        [t_graphs.build_kernel_graph(tk.trace()) for _, tk in ks],
        pad_graphs_to=8)
    assert sorted(jb) == sorted(tb)
    for k in jb:
        assert jb[k].dtype == tb[k].dtype and np.array_equal(jb[k], tb[k]), k
    for f in ("node_off", "edge_off", "warp_off", "trunc_nodes",
              "trunc_edges"):
        assert np.array_equal(getattr(jm, f), getattr(tm, f)), f
    assert j_batching.bucket_key(jb) == t_batching.bucket_key(tb)


@pytest.mark.parametrize("name", PROGRAMS)
def test_simulate_plan_and_evaluate_are_bit_equal(name):
    jp, tp = j_programs.get_program(name), t_programs.get_program(name)
    for platform in ("P1", "P3"):
        jm = j_timing.simulate_batch(
            j_timing.stack_stats([k.stats(platform) for k in jp.kernels]),
            J_PLATFORMS[platform])
        tm = t_timing.simulate_batch(
            t_timing.stack_stats([k.stats(platform) for k in tp.kernels]),
            T_PLATFORMS[platform])
        _same_arrays(jm, tm)
    rng = np.random.default_rng(len(name))
    labels = rng.integers(0, 3, len(jp))
    seqs = np.array([k.seq for k in jp.kernels])
    jplan = j_base.plan_from_labels(labels, seqs, "x")
    tplan = t_base.plan_from_labels(labels, seqs, "x")
    assert jplan.reps == tplan.reps
    assert np.array_equal(jplan.labels, tplan.labels)
    je = j_evaluate(jplan, jp, "P1")
    te = t_evaluate(tplan, tp, "P1")
    assert je.to_dict() == te.to_dict()


@pytest.mark.parametrize("name", PROGRAMS + ["cfd", "phi-2"])
def test_program_fingerprint_is_equal(name):
    assert (j_store.program_fingerprint(j_programs.get_program(name))
            == t_store.program_fingerprint(t_programs.get_program(name)))


def test_flatten_tree_round_trip_is_equal():
    tree = {"a": np.arange(3.0), "layers": [{"w": np.ones((2, 2))},
                                            {"w": np.zeros(1)}]}
    jf, tf = j_store.flatten_tree(tree), t_store.flatten_tree(tree)
    assert sorted(jf) == sorted(tf)
    back = t_store.unflatten_tree(tf)
    assert np.array_equal(back["layers"][0]["w"], tree["layers"][0]["w"])
    assert isinstance(back["layers"], list)


@pytest.mark.parametrize("name", ["scn:x", "lm:granite-3-2b",
                                  "model:llama3.2-3b:prefill", "nope"])
def test_unported_program_names_raise(name):
    with pytest.raises(KeyError):
        t_programs.get_program(name)
