"""The port's sequential K-Means reference against the JAX package's.

- K4: ``kmeans_assign_plain`` (what the card's kernel is held to) against
  the JAX Pallas ``kmeans_assign_fwd`` in interpret mode and its jnp
  oracle: labels equal (ties to the lowest index, also between duplicate
  centroids), min squared distance within 1e-5 of the distance scale
  (|x|^2 + |c|^2: both sides use the expanded formula and round its
  cancellation differently).
- ``kmeans`` / ``silhouette`` / ``select_k_and_cluster`` on the CPU
  against JAX's on blobs: K, labels and mode equal; per-K silhouette
  within SIL_TOL = 1e-3 of JAX's (JAX takes a dense sqrt of the expanded
  distance, whose self-distances are float32 noise; the port's K3 sums
  give exactly 0 there, see ``test_torch_clustering.py``); the chosen
  score within 1e-5 of an exact float64 silhouette.
- The same on the committed fixture's phi-2 and cfd embeddings, against
  the JAX results stored in ``reference_grid.json`` (JAX's sequential path
  at k_max = 48 compiles one executable per K and takes minutes): K,
  labels and representatives equal.  Scores: phi-2 has 15 distinct rows
  among 1125 points, so most distances are exact zeros, and JAX's float32
  scores sit up to 7.6e-3 from the exact float64 silhouette of JAX's own
  labels (stored as ``scores_exact``).  The port is held to that exact
  value instead: the chosen K's score within 1e-5, every other K's within
  EXACT_TOL = 1e-4 (float32 sums over <= 1200 distances a point; measured
  2.4e-5), and so within |JAX - exact| + EXACT_TOL of JAX's own score.
- ``PlanEngine(engine="sequential")`` and the ``errors="isolate"`` retry,
  held to the behaviour of JAX's
  ``test_errors_isolate_aligns_poison_requests``.
"""

import json
import os

import numpy as np
import pytest
import torch

from repro.core import clustering as jclust
from repro.kernels.kmeans_assign.kernel import kmeans_assign_fwd
from repro.kernels.kmeans_assign.ref import kmeans_assign_ref
from repro.sampling.engine import PlanEngine as JPlanEngine
from repro_torch.core import clustering as tclust
from repro_torch.kernels.kmeans_assign.ops import kmeans_assign_plain
from repro_torch.sampling import engine as tengine
from repro_torch.sampling.engine import PlanEngine, PlanRequest
from test_torch_clustering import on_jax_draws
from test_torch_reference import exact_silhouette as _exact_silhouette

SIL_TOL = 1e-3
EXACT_TOL = 1e-4
ASSETS = os.path.join(os.path.dirname(__file__), os.pardir, "src",
                      "repro_torch", "assets")



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small torch ops, which
    several test processes on one host slow down by oversubscribing the
    cores with spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _blobs(seed, n, d, k, spread=8.0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)) * spread
    return (centers[rng.integers(0, k, n)]
            + rng.standard_normal((n, d))).astype(np.float32)


def _duplicates(seed, n, d, m):
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((m, d)).astype(np.float32)
    return rows[rng.integers(0, m, n)]


# -- K4 ------------------------------------------------------------------------

K4_CASES = [
    ("blobs", lambda: (_blobs(0, 100, 16, 5), 5)),
    ("d12_k48", lambda: (_blobs(1, 300, 12, 6), 48)),
    ("k2_ragged", lambda: (_blobs(2, 37, 256, 3), 2)),
    ("duplicate_centroids", lambda: (_duplicates(3, 200, 32, 5), 12)),
]


@pytest.mark.parametrize("case", K4_CASES, ids=[c[0] for c in K4_CASES])
def test_k4_plain_matches_jax_kernel(case):
    x, k = case[1]()
    rng = np.random.default_rng(k)
    cent = x[rng.integers(0, len(x), k)]        # duplicates when x has them
    lab, mind = kmeans_assign_plain(torch.from_numpy(x),
                                    torch.from_numpy(cent))
    jlab, jmind = kmeans_assign_fwd(x, cent, interpret=True)
    rlab, rmind = kmeans_assign_ref(x, cent)
    scale = float((x * x).sum(1).max() + (cent * cent).sum(1).max())
    for wl, wm in ((jlab, jmind), (rlab, rmind)):
        np.testing.assert_array_equal(lab.numpy(), np.asarray(wl))
        np.testing.assert_allclose(mind.numpy(), np.asarray(wm), rtol=0,
                                   atol=1e-5 * scale)
    # ties go to the lowest index among identical centroids
    first = {}
    for i, row in enumerate(map(bytes, cent)):
        first.setdefault(row, i)
    assert all(first[bytes(cent[i])] == i for i in lab.numpy())


def test_k4_wrapper_routes_cpu_tensors_to_plain():
    x = torch.from_numpy(_blobs(4, 50, 8, 3))
    before = tclust.kmeans_assign.launches
    got = tclust.kmeans_assign(x, x[:3].contiguous())
    want = kmeans_assign_plain(x, x[:3].contiguous())
    assert tclust.kmeans_assign.launches == before      # no kernel launch
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# -- kmeans / silhouette / select_k_and_cluster ---------------------------------

def test_kmeans_and_silhouette_match_jax():
    x = _blobs(5, 120, 16, 4)
    lab, cent, inertia = tclust.kmeans(x, 4, seed=3, device="cpu")
    jlab, jcent, jinertia = jclust.kmeans(x, 4, seed=3)
    np.testing.assert_array_equal(lab, jlab)
    np.testing.assert_allclose(cent, jcent, rtol=0, atol=1e-5)
    assert inertia == pytest.approx(jinertia, rel=1e-5)
    s = tclust.silhouette(x, lab, device="cpu")
    assert s == pytest.approx(jclust.silhouette(x, jlab), abs=SIL_TOL)
    assert s == pytest.approx(_exact_silhouette(x, lab), abs=1e-5)
    # k >= n: every point its own cluster, as in JAX
    small = x[:3]
    np.testing.assert_array_equal(tclust.kmeans(small, 3, device="cpu")[0],
                                  jclust.kmeans(small, 3)[0])


SELECT_CASES = [
    ("blobs_3", lambda: _blobs(0, 60, 8, 3), dict(k_max=8)),
    ("blobs_5", lambda: _blobs(1, 120, 16, 5), dict(k_max=10)),
    ("subsampled", lambda: _blobs(2, 90, 8, 4), dict(k_max=8, sil_cap=40)),
    ("duplicates", lambda: _duplicates(3, 200, 32, 5), dict(k_max=12)),
    ("d12", lambda: _blobs(5, 150, 12, 6), dict(k_max=9, seed=4)),
    ("tiny", lambda: _blobs(7, 4, 8, 2), dict(k_max=8)),
    ("all_identical", lambda: np.ones((30, 8), np.float32), dict(k_max=8)),
]


def _check_against(got, want, x, kw):
    (gl, gi), (wl, wi) = got, want
    np.testing.assert_array_equal(np.asarray(gl), np.asarray(wl))
    assert gi["k"] == wi["k"] and gi["mode"] == wi["mode"]
    gs = {int(k): v for k, v in gi.get("scores", {}).items()}
    ws = {int(k): v for k, v in wi.get("scores", {}).items()}
    assert sorted(gs) == sorted(ws)
    for k in ws:
        assert gs[k] == pytest.approx(ws[k], abs=SIL_TOL), f"K={k}"
    if gi["mode"] == "silhouette":
        cap = kw.get("sil_cap", 1200)
        idx = (np.random.default_rng(kw.get("seed", 0)).choice(
            len(x), cap, replace=False) if len(x) > cap else np.arange(len(x)))
        assert gi["sil"] == pytest.approx(
            _exact_silhouette(x[idx], np.asarray(gl)[idx]), abs=1e-5)


@pytest.mark.parametrize("case", SELECT_CASES, ids=[c[0] for c in SELECT_CASES])
def test_select_k_and_cluster_matches_jax(case):
    _, build, kw = case
    x = build()
    _check_against(tclust.select_k_and_cluster(x, device="cpu", **kw),
                   jclust.select_k_and_cluster(x, **kw), x, kw)


@pytest.fixture(scope="module")
def grid_fixture():
    with open(os.path.join(ASSETS, "reference_grid.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["phi-2", "cfd"])
def test_select_k_and_cluster_on_fixture_embeddings(name, grid_fixture):
    """The fixture's JAX-trained embeddings through the port's sequential
    reference on the CPU: K, labels and representatives equal to JAX's
    (stored); scores against the exact silhouettes of JAX's labels (see
    the module docstring)."""
    from repro_torch.sampling import plan_from_labels
    from repro_torch.tracing.programs import get_program

    with np.load(os.path.join(ASSETS, "reference_phi2.npz")) as z:
        x = z[f"{name}:emb_distinct"][z[f"{name}:index"]]
    want = grid_fixture["sequential"][name]
    labels, info = tclust.select_k_and_cluster(x, device="cpu")
    np.testing.assert_array_equal(labels, want["labels"])
    assert info["k"] == want["k"] and info["mode"] == want["mode"]
    exact = {int(k): v for k, v in want["scores_exact"].items()}
    jax = {int(k): v for k, v in want["scores"].items()}
    assert sorted(info["scores"]) == sorted(exact) == sorted(jax)
    assert info["sil"] == pytest.approx(exact[info["k"]], abs=1e-5)
    for k, s in info["scores"].items():
        assert s == pytest.approx(exact[k], abs=EXACT_TOL), f"K={k}"
        assert abs(s - jax[k]) <= abs(exact[k] - jax[k]) + EXACT_TOL
    seqs = np.array([k.seq for k in get_program(name).kernels])
    assert plan_from_labels(labels, seqs, "x").rep_indices() == want["reps"]


DEVICE_CASES = [c for c in SELECT_CASES
                if c[0] in ("blobs_3", "duplicates", "d12", "all_identical")]


@pytest.mark.parametrize("case", DEVICE_CASES,
                         ids=[c[0] for c in DEVICE_CASES])
def test_select_k_and_cluster_device_init_matches_jax(case, monkeypatch):
    """init="device" on JAX's own Gumbel draws: the port's sequential
    reference equals JAX's (same tolerances as the host seeding)."""
    _, build, kw = case
    on_jax_draws(monkeypatch)
    x = build()
    _check_against(
        tclust.select_k_and_cluster(x, device="cpu", init="device", **kw),
        jclust.select_k_and_cluster(x, init="device", **kw), x, kw)


def test_device_init_engines_agree():
    """The port's own draws: the sweep engine, the sequential engine and
    the sequential reference seeded on the device serve equal labels and
    K; an unknown ``init`` is refused."""
    xs = [_blobs(s, 40 + 25 * s, 8, 2 + s) for s in range(3)]
    reqs = [PlanRequest(x, np.arange(len(x)), "m") for x in xs]
    sweep = PlanEngine(k_max=8, init="device", device="cpu").plan_many(reqs)
    seq = PlanEngine(k_max=8, init="device", engine="sequential",
                     device="cpu").plan_many(reqs)
    for x, a, b in zip(xs, sweep, seq):
        np.testing.assert_array_equal(a.labels, b.labels)
        assert a.num_clusters == b.num_clusters and a.reps == b.reps
        lab, info = tclust.select_k_and_cluster(x, k_max=8, init="device",
                                                device="cpu")
        np.testing.assert_array_equal(lab, a.labels)
    with pytest.raises(ValueError, match="init"):
        PlanEngine(init="numpy", device="cpu")


# -- PlanEngine: sequential engine and the isolate retry -----------------------

def test_sequential_engine_matches_jax_sequential_engine():
    xs = [_blobs(s, 40 + 10 * s, 8, 2 + s) for s in range(3)]
    reqs = [PlanRequest(x, np.arange(len(x)), "m") for x in xs]
    eng = PlanEngine(k_max=8, engine="sequential", device="cpu")
    got = eng.plan_many(reqs)
    from repro.sampling.engine import PlanRequest as JPlanRequest

    want = JPlanEngine(k_max=8, engine="sequential").plan_many(
        [JPlanRequest(x, np.arange(len(x)), "m") for x in xs])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.labels, w.labels)
        assert g.reps == w.reps
    assert eng.stats["dispatches"] == 3 and eng.stats["errors"] == 0
    with pytest.raises(ValueError):
        PlanEngine(engine="nope", device="cpu")


def test_errors_isolate_aligns_poison_requests():
    """The JAX test of the same name, on the port: a request that cannot be
    normalized fails alone, its siblings are served, the batch keeps its
    order, and ``errors`` must be 'raise' or 'isolate'."""
    good = _blobs(3, 45, 8, 3)
    poison = np.array([[1, 2], [3, "x"]], dtype=object)
    eng = PlanEngine(k_max=6, iters=10, device="cpu")
    with pytest.raises(ValueError):
        eng.cluster_many([good, poison])
    out = eng.cluster_many([good, poison, good], errors="isolate")
    assert isinstance(out[1], Exception)
    np.testing.assert_array_equal(out[0][0], out[2][0])
    assert eng.stats["errors"] >= 1
    plans = eng.plan_many([PlanRequest(x, np.arange(len(x)), "m")
                           for x in (good, poison)], errors="isolate")
    assert plans[0].labels.shape == (45,)
    assert isinstance(plans[1], Exception)
    with pytest.raises(ValueError):
        eng.cluster_many([good], errors="nope")


def test_isolate_retries_a_failed_sweep_through_the_sequential_path(
        monkeypatch):
    """A sweep that raises for a chunk holding one of three requests (one
    chunk of three, as JAX's engine chunks them): under
    ``errors="isolate"`` each program of the chunk is served by the
    sequential reference (its plan equals the sequential engine's) and
    counts no error; one that fails there too keeps its exception and
    counts one, and its siblings are served.  Under ``errors="raise"``
    the sweep's exception propagates."""
    xs = [_blobs(s, 50, 8, 3) for s in range(3)]
    real = tengine.sweep_cluster_stack
    calls = {"sweep": 0, "seq": 0}

    def flaky(batch, **kw):
        calls["sweep"] += 1
        if any(np.array_equal(x, xs[1]) for x in batch):
            raise RuntimeError("injected sweep failure")
        return real(batch, **kw)

    real_seq = tengine.select_k_and_cluster

    def seq(x, **kw):
        calls["seq"] += 1
        return real_seq(x, **kw)

    monkeypatch.setattr(tengine, "sweep_cluster_stack", flaky)
    monkeypatch.setattr(tengine, "select_k_and_cluster", seq)
    reqs = [PlanRequest(x, np.arange(len(x)), "m") for x in xs]
    eng = PlanEngine(k_max=6, iters=10, device="cpu")
    with pytest.raises(RuntimeError, match="injected"):
        eng.plan_many(reqs)
    plans = eng.plan_many(reqs, errors="isolate")
    assert calls["seq"] == 3 and eng.stats["errors"] == 0
    ref = PlanEngine(k_max=6, iters=10, engine="sequential",
                     device="cpu").plan_many(reqs)
    for got, want in zip(plans, ref):
        np.testing.assert_array_equal(got.labels, want.labels)
        assert got.reps == want.reps
        assert "engine" not in got.extra           # the sequential result

    def broken(x, **kw):
        if np.array_equal(x, xs[1]):
            raise RuntimeError("sequential failure too")
        return real_seq(x, **kw)

    monkeypatch.setattr(tengine, "select_k_and_cluster", broken)
    out = eng.cluster_many(xs, errors="isolate")
    assert isinstance(out[1], RuntimeError) and eng.stats["errors"] == 1
    assert not isinstance(out[0], Exception)
    assert not isinstance(out[2], Exception)
