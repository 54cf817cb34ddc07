"""The port's comparison grid (``repro_torch.launch.sample``) against the
JAX package's (``repro.launch.sample``), at the smoke size on the CPU.

- The four-method smoke grid (``SMOKE_GCL``: 10 steps, batch 4,
  ``cap_instr`` 48) passes both packages' ``validate_results`` with no
  failed cell and no ``plan_batch`` fallback; every pka / sieve /
  stem_root row equals JAX's (K, representatives, eq. 5 on every metric,
  eq. 6).  The gcl rows are not held equal: the port draws its training
  noise from ``torch`` generators, JAX from ``jax.random``.
- A second run on the same ``--out`` replays: no fit, no trace, the same
  rows.
- The artifact store is one format: a JAX-written gcl artifact replays in
  the port (the port re-embeds with the JAX encoder: 1e-5 of the largest
  magnitude, the tolerance of ``test_torch_reference.py``) and a
  port-written one replays in JAX.  Both packages hash one config to one
  content key: either package's grid, run on the other's ``--out``, finds
  every artifact there, fits and traces nothing, and gives the rows of
  the run that wrote it.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from repro.launch import sample as jsample
from repro.sampling import ArtifactStore as JArtifactStore
from repro.sampling import get_method as jax_get_method
from repro.tracing.programs import get_program as jax_get_program
from repro_torch.launch import sample as tsample
from repro_torch.sampling import ArtifactStore, get_method
from repro_torch.tracing.programs import get_program

METHODS = ["gcl", "pka", "sieve", "stem_root"]
PLATFORMS = ["P1", "P2"]
EMB_TOL = 1e-5



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small torch ops, which
    several test processes on one host slow down by oversubscribing the
    cores with spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def jax_doc(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_grid"))
    return out, jsample.run_grid(METHODS, jsample.SMOKE_PROGRAMS, PLATFORMS,
                                 out, smoke=True, verbose=False)


@pytest.fixture(scope="module")
def port_doc(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("port_grid"))
    return out, tsample.run_grid(METHODS, tsample.SMOKE_PROGRAMS, PLATFORMS,
                                 out, smoke=True, device="cpu", verbose=False)


def _rows(out, doc, store_cls):
    store = store_cls(os.path.join(out, "artifacts"))
    rows = {}
    for r in doc["results"]:
        plan = store.load_plan(r["method_id"], r["artifact_key"])
        rows[(r["method_id"], r["program"], r["platform"])] = (
            r["num_clusters"], plan.rep_indices(), r["error_pct"],
            r["speedup"])
    return rows


def test_smoke_grid_validates_and_baselines_match_jax(port_doc, jax_doc):
    (out, doc), (jout, jdoc) = port_doc, jax_doc
    tsample.validate_results(doc)
    jsample.validate_results(doc)
    assert doc["schema"] == jdoc["schema"] == "repro.sampling.results/v2"
    assert doc["failures"] == [] and doc["batch_plan_errors"] == []
    assert sorted(doc["method_wall_s"]) == sorted(METHODS)
    rows, jrows = _rows(out, doc, ArtifactStore), _rows(jout, jdoc,
                                                        JArtifactStore)
    assert sorted(rows) == sorted(jrows)
    assert len(rows) == len(METHODS) * 2 * len(PLATFORMS)
    for key, row in rows.items():
        if key[0] != "gcl":
            assert row == jrows[key], key


def test_warm_rerun_replays(port_doc, monkeypatch):
    """The second run on the same ``out`` adopts the stored encoder: the
    fit and the tracer are never called, and the rows are the first run's."""
    from repro_torch.core.sampler import GCLSampler
    from repro_torch.tracing.tracer import KernelInvocation

    out, doc = port_doc

    def refuse(*a, **k):
        raise AssertionError("a warm re-run must not fit or trace")

    monkeypatch.setattr(GCLSampler, "train", refuse)
    monkeypatch.setattr(KernelInvocation, "trace", refuse)
    again = tsample.run_grid(METHODS, tsample.SMOKE_PROGRAMS, PLATFORMS, out,
                             smoke=True, device="cpu", verbose=False)
    assert again["failures"] == [] and again["batch_plan_errors"] == []
    assert _rows(out, again, ArtifactStore) == _rows(out, doc, ArtifactStore)


def _gcl_key(doc, program):
    return next(r["artifact_key"] for r in doc["results"]
                if r["method_id"] == "gcl" and r["program"] == program)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=EMB_TOL,
        atol=EMB_TOL * float(np.abs(want).max()))


def test_jax_written_store_replays_in_port(jax_doc):
    jout, jdoc = jax_doc
    name = jsample.SMOKE_PROGRAMS[0]
    art = ArtifactStore(os.path.join(jout, "artifacts")).load(
        "gcl", _gcl_key(jdoc, name))
    assert art is not None and art.method == "gcl"
    m = get_method("gcl", device="cpu", **jsample.SMOKE_GCL)
    m.adopt(art)
    _close(m.prepare(get_program(name)).payload["embeddings"],
           art.payload["embeddings"])


def test_port_written_store_replays_in_jax(port_doc):
    out, doc = port_doc
    name = tsample.SMOKE_PROGRAMS[0]
    art = JArtifactStore(os.path.join(out, "artifacts")).load(
        "gcl", _gcl_key(doc, name))
    assert art is not None and art.method == "gcl"
    jm = jax_get_method("gcl", **jsample.SMOKE_GCL)
    jm.adopt(art)
    _close(jm.prepare(jax_get_program(name)).payload["embeddings"],
           art.payload["embeddings"])


def _replay_elsewhere(written, tmp_path, grid, store_cls):
    """Run ``grid`` on a copy of the ``(out, doc)`` another package's grid
    wrote; every artifact key and row must be the writer's."""
    out, doc = written
    copy = str(tmp_path / "copy")
    shutil.copytree(out, copy)
    again = grid(copy)
    assert again["failures"] == [] and again["batch_plan_errors"] == []
    keys = sorted((r["method_id"], r["program"], r["platform"],
                   r["artifact_key"]) for r in again["results"])
    assert keys == sorted((r["method_id"], r["program"], r["platform"],
                           r["artifact_key"]) for r in doc["results"])
    assert _rows(copy, again, store_cls) == _rows(out, doc, store_cls)


def _refuse(*a, **k):
    raise AssertionError("a grid on a written --out must not fit or trace")


def test_port_grid_replays_a_jax_written_out(jax_doc, tmp_path, monkeypatch):
    from repro_torch.core.sampler import GCLSampler
    from repro_torch.tracing.tracer import KernelInvocation

    for name in ("train", "train_stream"):
        monkeypatch.setattr(GCLSampler, name, _refuse)
    monkeypatch.setattr(KernelInvocation, "trace", _refuse)
    _replay_elsewhere(
        jax_doc, tmp_path,
        lambda out: tsample.run_grid(METHODS, tsample.SMOKE_PROGRAMS,
                                     PLATFORMS, out, smoke=True, device="cpu",
                                     verbose=False),
        ArtifactStore)


def test_jax_grid_replays_a_port_written_out(port_doc, tmp_path,
                                             monkeypatch):
    from repro.core.sampler import GCLSampler as JGCLSampler
    from repro.tracing.tracer import KernelInvocation as JKernelInvocation

    for name in ("train", "train_stream"):
        monkeypatch.setattr(JGCLSampler, name, _refuse)
    monkeypatch.setattr(JKernelInvocation, "trace", _refuse)
    _replay_elsewhere(
        port_doc, tmp_path,
        lambda out: jsample.run_grid(METHODS, jsample.SMOKE_PROGRAMS,
                                     PLATFORMS, out, smoke=True,
                                     verbose=False),
        JArtifactStore)


def test_validate_results_rejects_malformed_docs(port_doc):
    _, doc = port_doc
    for breakage in ({"schema": "x"}, {"results": None},
                     {"grid": dict(doc["grid"], suite="nope")}):
        with pytest.raises(ValueError):
            tsample.validate_results(dict(doc, **breakage))


def test_cli_runs_on_the_cpu(tmp_path):
    """``main`` with ``--device cpu`` writes a valid results JSON and
    exits 0 when no cell failed."""
    import json

    out = str(tmp_path / "cli")
    assert tsample.main(["--method", "sieve,stem_root", "--smoke",
                         "--device", "cpu", "--platforms", "P1,P3",
                         "--out", out]) == 0
    with open(os.path.join(out, "results.json")) as f:
        doc = json.load(f)
    tsample.validate_results(doc)
    assert len(doc["results"]) == 2 * 2 * 2


@pytest.mark.parametrize("arg", ["nw,3mm", "scn:long_tail:seed=3,phase_len=24,nw",
                                 "model:llama3.2-3b:decode,lm:granite-3-2b"])
def test_split_programs_matches_jax(arg):
    assert tsample.split_programs(arg) == jsample.split_programs(arg)


def test_prepare_checkpoints_its_fit_under_the_store(tmp_path):
    """With ``checkpoint_every`` the gcl fit snapshots under
    ``store.checkpoint_dir(method, artifact key)``, as in JAX."""
    out = str(tmp_path / "ck")
    doc = tsample.run_grid(["gcl"], ["3mm"], ["P1"], out, smoke=True,
                           checkpoint_every=5, device="cpu", verbose=False)
    assert doc["failures"] == []
    key = doc["results"][0]["artifact_key"]
    ck = ArtifactStore(os.path.join(out, "artifacts")).checkpoint_dir(
        "gcl", key)
    assert os.path.isdir(ck) and os.listdir(ck)
