"""The port's copies of the numpy-only modules give what their originals
give, bit for bit: traces, graphs, packed batches, simulated metrics, plans
and program fingerprints on a few paper programs; the sieve / stem_root
partitions and PKA features; graph-store keys and entries (each package
reads the other's) and the ingestion engine; generated scenario programs;
``lm:`` / ``model:`` traces; the model configs; the plan-serving load
generator's fleets and arrival times; the train and mesh configs; the LM
token stream."""

import dataclasses

import numpy as np
import pytest

import repro.config as j_config
import repro.configs as j_configs
import repro.core.baselines.pka as j_pka
import repro.core.baselines.sieve as j_sieve
import repro.core.baselines.stem_root as j_stem
import repro.core.batching as j_batching
import repro.core.graphs as j_graphs
import repro.data as j_data
import repro.ingest as j_ingest
import repro.ingest.store as j_ingest_store
import repro.sampling.base as j_base
import repro.sampling.store as j_store
import repro.serving.loadgen as j_loadgen
import repro.sim.timing as j_timing
import repro.tracing.programs as j_programs
import repro.workloads as j_workloads
import repro_torch.config as t_config
import repro_torch.configs as t_configs
import repro_torch.core.baselines.pka as t_pka
import repro_torch.core.baselines.sieve as t_sieve
import repro_torch.core.baselines.stem_root as t_stem
import repro_torch.core.batching as t_batching
import repro_torch.core.graphs as t_graphs
import repro_torch.data as t_data
import repro_torch.ingest as t_ingest
import repro_torch.ingest.store as t_ingest_store
import repro_torch.sampling.base as t_base
import repro_torch.sampling.store as t_store
import repro_torch.serving.loadgen as t_loadgen
import repro_torch.sim.timing as t_timing
import repro_torch.tracing.programs as t_programs
import repro_torch.workloads as t_workloads
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
    """Every program name space of the original resolves in the copy (the
    ``workloads/`` and ``configs/`` copies are in), to the same program;
    names the original refuses, the copy refuses with the same error."""
    try:
        want = j_programs.get_program(name)
    except Exception as e:
        with pytest.raises(type(e)):
            t_programs.get_program(name)
        return
    got = t_programs.get_program(name)
    assert (j_store.program_fingerprint(want)
            == t_store.program_fingerprint(got))
    assert len(got) == len(want)


def _graphs_equal(ja, ta):
    assert len(ja) == len(ta)
    for a, b in zip(ja, ta):
        _same_arrays(a, b)


@pytest.mark.parametrize("name", PROGRAMS)
def test_baseline_partitions_are_bit_equal(name):
    jp, tp = j_programs.get_program(name), t_programs.get_program(name)
    for platform in ("P1", "P3"):
        np.testing.assert_array_equal(j_pka.pka_features(jp, platform),
                                      t_pka.pka_features(tp, platform))
        for a, b in zip(j_sieve.sieve_partition(jp, platform),
                        t_sieve.sieve_partition(tp, platform)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        jt = j_stem.stem_root_times(jp, platform)
        tt = t_stem.stem_root_times(tp, platform)
        assert jt.dtype == tt.dtype and np.array_equal(jt, tt)
        names = [k.name for k in jp.kernels]
        (jl, jsel), (tl, tsel) = (j_stem.stem_root_partition(jt, names),
                                  t_stem.stem_root_partition(tt, names))
        np.testing.assert_array_equal(jl, tl)
        for c in np.unique(jl):
            members = np.nonzero(jl == c)[0]
            assert jsel(int(c), members) == tsel(int(c), members)


def test_graph_store_keys_and_entries_are_bit_equal(tmp_path):
    """Same keys; an entry (and a manifest) written by either package is
    read by the other, and the two ingestion engines yield the same graphs
    (the port's with two workers)."""
    jp, tp = j_programs.get_program("bfs"), t_programs.get_program("bfs")
    for jk, tk in zip(jp.kernels[:4], tp.kernels[:4]):
        for caps in ((2, 96), (4, 48)):
            assert (j_ingest_store.kernel_graph_key(jk, *caps)
                    == t_ingest_store.kernel_graph_key(tk, *caps))
    jstore = j_ingest_store.GraphStore(str(tmp_path / "j"))
    j_graphs_ = j_ingest.IngestEngine(store=jstore).ingest(jp)
    tstore = t_ingest_store.GraphStore(str(tmp_path / "j"))   # same root
    teng = t_ingest.IngestEngine(t_ingest.IngestConfig(workers=2),
                                 store=tstore)
    t_graphs_ = teng.ingest(tp)
    assert teng.stats["traced"] == 0 and teng.stats["store_hits"] > 0
    _graphs_equal(j_graphs_, t_graphs_)
    assert tstore.warm(tp, 2, 96) and jstore.warm(jp, 2, 96)
    # the other way round: the port writes, JAX reads
    t2 = t_ingest.IngestEngine(store=t_ingest_store.GraphStore(
        str(tmp_path / "t")))
    t2.ingest(tp)
    j2 = j_ingest.IngestEngine(store=j_ingest_store.GraphStore(
        str(tmp_path / "t")))
    _graphs_equal(j2.ingest(jp), t_graphs_)
    assert j2.stats["traced"] == 0


@pytest.mark.parametrize("family", ["iterative", "pipeline", "long_tail"])
def test_scenario_programs_are_bit_equal(family):
    names = j_workloads.scenario_matrix([family], (0, 1), phases=2,
                                        phase_len=6)
    assert names == t_workloads.scenario_matrix([family], (0, 1), phases=2,
                                                phase_len=6)
    for name in names:
        jp, tp = j_programs.get_program(name), t_programs.get_program(name)
        assert (j_store.program_fingerprint(jp)
                == t_store.program_fingerprint(tp))
        assert (j_workloads.scenario_family_of(name)
                == t_workloads.scenario_family_of(name) == family)
        for jk, tk in list(zip(jp.kernels, tp.kernels))[:3]:
            _graphs_equal(jk.trace(), tk.trace())


@pytest.mark.parametrize("name", ["lm:granite-3-2b",
                                  "model:llama3.2-3b:prefill",
                                  "model:mamba2-780m:decode",
                                  "model:dbrx-132b:prefill"])
def test_lm_and_model_traces_are_bit_equal(name):
    jp, tp = j_programs.get_program(name), t_programs.get_program(name)
    assert j_store.program_fingerprint(jp) == t_store.program_fingerprint(tp)
    assert jp.trace_caps == tp.trace_caps
    caps = j_config.resolve_trace_caps(None, 48, jp)
    assert caps == t_config.resolve_trace_caps(None, 48, tp)
    for jk, tk in list(zip(jp.kernels, tp.kernels))[:3]:
        jt, tt = jk.trace(*caps), tk.trace(*caps)
        _graphs_equal(jt, tt)
        _same_arrays(j_graphs.build_kernel_graph(jt),
                     t_graphs.build_kernel_graph(tt))


def test_model_configs_are_equal():
    assert j_configs.list_archs() == t_configs.list_archs()
    for arch in j_configs.list_archs():
        jc, tc = j_configs.get_arch(arch), t_configs.get_arch(arch)
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert j_config.param_counts(jc) == t_config.param_counts(tc)
        for shape in j_config.SHAPES:
            assert (j_config.model_flops(jc, j_config.SHAPES[shape])
                    == t_config.model_flops(tc, t_config.SHAPES[shape]))


def test_train_and_mesh_configs_are_equal():
    """One ``TrainConfig`` with JAX's fields and defaults (the LM launcher's
    and the fit's); ``MeshConfig``'s shapes and axes."""
    assert (dataclasses.asdict(j_config.TrainConfig())
            == dataclasses.asdict(t_config.TrainConfig()))
    for multi in (False, True):
        jm, tm = j_config.MeshConfig(multi), t_config.MeshConfig(multi)
        assert (jm.shape, jm.axes, jm.num_devices, jm.batch_axes) == (
            tm.shape, tm.axes, tm.num_devices, tm.batch_axes)


@pytest.mark.parametrize("kw", [
    {}, {"seed": 3, "num_hosts": 2, "host_id": 1},
    {"frontend": "vision", "d_model": 8, "frontend_tokens": 4},
    {"frontend": "audio", "d_model": 8}], ids=["text", "host", "vision",
                                                "audio"])
def test_token_stream_is_bit_equal(kw):
    """``data/tokens.py`` is numpy only: the port's copy is the original
    byte for byte, ``data/__init__.py`` with its import rewritten, and the
    streams give equal batches, after a ``skip`` too."""
    from pathlib import Path

    src = Path(__file__).resolve().parent.parent / "src"
    assert ((src / "repro_torch" / "data" / "tokens.py").read_bytes()
            == (src / "repro" / "data" / "tokens.py").read_bytes())
    assert ((src / "repro_torch" / "data" / "__init__.py").read_text()
            == (src / "repro" / "data" / "__init__.py").read_text().replace(
                "from repro.", "from repro_torch."))
    streams = [m.TokenStream(97, 24, 4, **kw) for m in (j_data, t_data)]
    for step in range(3):
        if step == 2:
            for s in streams:
                s.skip(7)
        a, b = (s.next() for s in streams)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


@pytest.mark.parametrize("n,d,seed", [(6, 8, 3), (40, 16, 0), (3, 256, 7)])
def test_loadgen_fleet_and_arrivals_are_bit_equal(n, d, seed):
    """``serving/loadgen.py``: the synthetic fleet (embeddings, seqs,
    method, per-request seed) and the Poisson arrival times."""
    jf = j_loadgen.synthetic_fleet(n, d=d, seed=seed)
    tf = t_loadgen.synthetic_fleet(n, d=d, seed=seed)
    assert len(jf) == len(tf) == n
    for jr, tr in zip(jf, tf):
        assert jr.embeddings.dtype == tr.embeddings.dtype
        assert np.array_equal(jr.embeddings, tr.embeddings)
        assert np.array_equal(jr.seqs, tr.seqs)
        assert (jr.method, jr.seed, jr.extra) == (tr.method, tr.seed,
                                                   tr.extra)
    ja = j_loadgen.poisson_arrivals(n, 37.5, seed=seed)
    ta = t_loadgen.poisson_arrivals(n, 37.5, seed=seed)
    assert ja.dtype == ta.dtype and np.array_equal(ja, ta)


def test_fault_module_is_a_verbatim_copy():
    """``distributed/fault.py`` is standard library only: the port's copy
    is the original byte for byte (no imports to rewrite)."""
    from pathlib import Path

    import repro_torch.distributed.fault as t_fault

    src = Path(__file__).resolve().parent.parent / "src"
    assert (Path(t_fault.__file__).read_bytes()
            == (src / "repro" / "distributed" / "fault.py").read_bytes())
