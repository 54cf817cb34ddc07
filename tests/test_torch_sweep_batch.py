"""The sweep's program axis: many programs of a bucket in one dispatch, as
JAX's default engine clusters them, held to the JAX package on the CPU.

- K2 and K3 with a program axis (``kmeans_assign_fused_batched`` on x
  (B, n, d), ``silhouette_sums`` on x (B, n, d)), plain versions, against
  JAX's ``kmeans_assign_fused`` / ``silhouette_sums`` references run per
  program (labels exact, the rest at the tolerances of
  ``tests/test_torch_kernels.py``), and bit-equal to their one-program
  forms;
- the port's ``sweep_cluster_stack`` against JAX's vmapped
  ``sweep_cluster_stack`` (its default path) at B = 1, 2, 3, 5 and 8:
  mixed sizes within one bucket (different k_top), mixed buckets,
  per-program seeds, ``sil_cap`` subsampling, host fallbacks (tiny,
  trivial, featureless) mixed into the chunk, and ``init="device"`` on
  JAX's Gumbel draws: labels and K equal, every score within SIL_TOL;
- each program's result inside a chunk against its own one-program sweep
  (labels and K equal, scores within 1e-6);
- ``PlanEngine.cluster_many`` against JAX's engine: ``serve.batch`` stamps,
  ``dispatches``, ``programs`` and ``bucket_hist`` equal, with and without
  ``data_devices=2``; ``errors="isolate"`` with a poison request in the
  middle of a chunk; ``warmup``'s default batch sizes; the service's
  ``mean_batch`` read from the stamps.

Small sizes (d <= 16, k_max <= 12, n <= 300) and one torch thread.
"""

import numpy as np
import pytest
import torch

from repro.core.clustering import sweep_cluster_stack as jax_sweep
from repro.kernels.kmeans_assign.ref import (
    kmeans_assign_fused_ref, silhouette_sums_ref,
)
from repro.sampling import engine as jengine
from repro.sampling.engine import PlanEngine as JPlanEngine
from repro_torch.core.clustering import bucket_batch, sweep_cluster_stack
from repro_torch.kernels.kmeans_assign.ops import (
    kmeans_assign_fused_batched, silhouette_sums,
)
from repro_torch.sampling import engine as tengine
from repro_torch.sampling.engine import PlanEngine, PlanRequest
from repro_torch.serving import PlanService
from test_torch_clustering import on_jax_draws

SIL_TOL = 1e-3          # the port's sweep vs JAX's (test_torch_clustering)
SOLO_TOL = 1e-6         # a program in a chunk vs its one-program sweep
RTOL = 1e-5             # kernels vs the JAX reference (test_torch_kernels)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, atol=0.0):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * scale + atol)


def _blobs(seed, n, d, k, spread=8.0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)) * spread
    lab = rng.integers(0, k, n)
    return (centers[lab] + rng.standard_normal((n, d))).astype(np.float32)


# ---------------------------------------------------------------------------
# K2 and K3 with a program axis
# ---------------------------------------------------------------------------

def _k2_batch(B, n, d, k, C, seed):
    """B programs of blobs, each with its own points mask (a padded tail of
    a different length) and centroids near its own centres; the sweep's
    prefix candidate masks K = 2..C + 1, shared by the programs."""
    rng = np.random.default_rng(seed)
    x = np.zeros((B, n, d), np.float32)
    cent = np.zeros((B, C, k, d), np.float32)
    pmask = np.zeros((B, n), np.float32)
    for b in range(B):
        live = n - int(rng.integers(0, n // 3))
        centers = rng.standard_normal((k, d)).astype(np.float32) * 6
        lab = rng.integers(0, k, live)
        x[b, :live] = centers[lab] + rng.standard_normal((live, d))
        pmask[b, :live] = 1.0
        cent[b] = centers[None] + 0.2 * rng.standard_normal((C, k, d))
    cmask = (np.arange(k)[None] < (np.arange(C) + 2)[:, None]).astype(
        np.float32)
    return x, cent, cmask, pmask


@pytest.mark.parametrize("B,n,d,k,C", [(1, 64, 12, 8, 7), (3, 50, 16, 6, 5),
                                       (8, 40, 8, 12, 11)])
def test_k2_program_axis_plain_matches_jax(B, n, d, k, C):
    """Every (program, candidate) of one K2 call against JAX's
    ``kmeans_assign_fused_ref`` on that program and candidate: labels
    exact, min distances, sums and counts at 1e-5; each program's slice
    bit-equal to the one-program call."""
    x, cent, cmask, pmask = _k2_batch(B, n, d, k, C, seed=B + n)
    t = [torch.from_numpy(a) for a in (x, cent, cmask, pmask)]
    got = kmeans_assign_fused_batched(*t)
    assert got[0].shape == (B, C, n) and got[0].dtype == torch.int32
    assert got[2].shape == (B, C, k, d) and got[3].shape == (B, C, k)
    for b in range(B):
        one = kmeans_assign_fused_batched(t[0][b], t[1][b], t[2], t[3][b])
        for g, o in zip(got, one):
            assert torch.equal(g[b], o)
        for c in range(C):
            want = kmeans_assign_fused_ref(x[b], cent[b, c], cmask[c],
                                           pmask[b])
            np.testing.assert_array_equal(got[0][b, c].numpy(),
                                          np.asarray(want[0]))
            for g, w in zip(got[1:], want[1:]):
                _close(g[b, c].numpy(), np.asarray(w))
            assert float(got[3][b, c].sum()) == pytest.approx(
                float(pmask[b].sum()))


@pytest.mark.parametrize("B,n,d,k", [(1, 96, 16, 4), (3, 70, 12, 6),
                                     (8, 33, 8, 12)])
def test_k3_program_axis_plain_matches_jax(B, n, d, k):
    """One K3 call over B programs, each with its own point-masked
    one-hot, against JAX's ``silhouette_sums_ref`` per program (1e-5, plus
    the self-distance cancellation floor of test_torch_kernels); each
    program's slice bit-equal to the one-program call."""
    rng = np.random.default_rng(B * n + k)
    x = np.stack([_blobs(B + b, n, d, k) for b in range(B)])
    onehot = np.zeros((B, n, k), np.float32)
    for b in range(B):
        lab = rng.integers(0, k, n)
        live = rng.random(n) < 0.7
        onehot[b, np.arange(n), lab] = live
    got = silhouette_sums(torch.from_numpy(x), torch.from_numpy(onehot))
    assert got.shape == (B, n, k)
    eps = float(np.finfo(np.float32).eps)
    for b in range(B):
        floor = 2 * float(np.sqrt(3 * d * eps * (x[b] ** 2).sum(1).max()))
        _close(got[b].numpy(), np.asarray(silhouette_sums_ref(x[b],
                                                               onehot[b])),
               atol=floor)
        one = silhouette_sums(torch.from_numpy(x[b]),
                              torch.from_numpy(onehot[b]))
        assert torch.equal(got[b], one)


# ---------------------------------------------------------------------------
# the port's sweep against JAX's vmapped sweep
# ---------------------------------------------------------------------------

def _fallbacks():
    return [_blobs(40, 4, 8, 2), np.zeros((1, 8), np.float32),
            np.zeros((0, 8), np.float32), np.zeros((10, 0), np.float32)]


# (case id, inputs builder, sweep kwargs); B is the number of programs the
# chunk sends to the device (the host fallbacks never reach it)
SWEEP_CASES = [
    ("b1", lambda: [_blobs(1, 45, 8, 3)], dict(k_max=10, seed=[5])),
    ("b2_sil_cap", lambda: [_blobs(2, 150, 8, 4), _blobs(3, 80, 8, 3)],
     dict(k_max=8, sil_cap=50, seed=[1, 2])),
    ("b3_one_bucket_k_top", lambda: [_blobs(4, 6, 8, 2), _blobs(5, 9, 8, 3),
                                     _blobs(6, 20, 8, 4)],
     dict(k_max=12, seed=[0, 3, 7])),
    ("b5_mixed_buckets", lambda: [_blobs(10 + i, n, 12, 2 + i % 4)
                                  for i, n in enumerate((22, 40, 60, 90, 130))],
     dict(k_max=10, seed=[0, 1, 2, 3, 4])),
    ("b8_one_bucket", lambda: [_blobs(20 + i, n, 8, 2 + i % 5) for i, n in
                               enumerate((22, 30, 36, 41, 47, 52, 58, 60))],
     dict(k_max=12, seed=list(range(8)))),
    ("b5_with_fallbacks", lambda: (
        [_blobs(30 + i, n, 8, 3) for i, n in enumerate((25, 50, 70))]
        + _fallbacks() + [_blobs(33, 35, 8, 2), _blobs(34, 64, 8, 5)]),
     dict(k_max=8, seed=9)),
]


def _assert_like_jax(got, want):
    assert len(got) == len(want)
    for (gl, gi), (wl, wi) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(gl), np.asarray(wl))
        assert gi["k"] == wi["k"] and gi["mode"] == wi["mode"]
        np.testing.assert_allclose(gi["sil"], wi["sil"], rtol=0,
                                   atol=SIL_TOL)
        gs, ws = gi.get("scores", {}), wi.get("scores", {})
        assert sorted(gs) == sorted(ws)
        for k in ws:
            np.testing.assert_allclose(gs[k], ws[k], rtol=0, atol=SIL_TOL,
                                       err_msg=f"K={k}")


@pytest.mark.parametrize("case", SWEEP_CASES, ids=[c[0] for c in SWEEP_CASES])
def test_sweep_program_axis_matches_jax_vmapped_sweep(case):
    """One port dispatch of the chunk against JAX's vmapped sweep of the
    same chunk (its default engine path, ``use_pallas=False``)."""
    _, build, kw = case
    xs = build()
    got = sweep_cluster_stack(xs, device="cpu", iters=20, **kw)
    want = jax_sweep(xs, init="host", iters=20, **kw)
    _assert_like_jax(got, want)


@pytest.mark.parametrize("case", [c for c in SWEEP_CASES
                                  if c[0] in ("b3_one_bucket_k_top",
                                              "b5_mixed_buckets")],
                         ids=["b3_one_bucket_k_top", "b5_mixed_buckets"])
def test_sweep_program_axis_device_init_on_jax_draws(case, monkeypatch):
    """init="device" on JAX's Gumbel draws: each program draws at its own
    bucket inside the chunk, as JAX's does, and the chunk's results equal
    JAX's."""
    _, build, kw = case
    on_jax_draws(monkeypatch)
    xs = build()
    got = sweep_cluster_stack(xs, device="cpu", iters=20, init="device",
                              **kw)
    want = jax_sweep(xs, init="device", iters=20, **kw)
    _assert_like_jax(got, want)


@pytest.mark.parametrize("case", SWEEP_CASES, ids=[c[0] for c in SWEEP_CASES])
def test_program_in_a_chunk_equals_its_solo_sweep(case):
    """Batch independence: each program's labels and K in the chunk equal
    its one-program sweep's, its scores within 1e-6."""
    _, build, kw = case
    xs = build()
    seeds = kw.get("seed", 0)
    seeds = [seeds] * len(xs) if np.isscalar(seeds) else seeds
    kw = {k: v for k, v in kw.items() if k != "seed"}
    got = sweep_cluster_stack(xs, device="cpu", iters=20, seed=seeds, **kw)
    for x, s, (gl, gi) in zip(xs, seeds, got):
        (sl, si), = sweep_cluster_stack([x], device="cpu", iters=20, seed=s,
                                        **kw)
        np.testing.assert_array_equal(gl, sl)
        assert gi["k"] == si["k"] and gi["mode"] == si["mode"]
        assert gi["sil"] == pytest.approx(si["sil"], abs=SOLO_TOL)
        assert sorted(gi.get("scores", {})) == sorted(si.get("scores", {}))
        for k, v in si.get("scores", {}).items():
            assert gi["scores"][k] == pytest.approx(v, abs=SOLO_TOL)


def test_padded_program_rows_are_inert():
    """A chunk of 3 is padded to bucket_batch(3) = 4 programs; the padded
    row (all-zero pmask) is swept with the rest and leaves no trace: the
    three results equal theirs in a chunk whose fourth row is a real
    program, and every score is finite (no NaN reaches a plan)."""
    assert [bucket_batch(n) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8,
                                                           16]
    xs = [_blobs(50 + i, 30 + 7 * i, 8, 3) for i in range(3)]
    got = sweep_cluster_stack(xs, k_max=8, iters=20, seed=[0, 1, 2],
                              device="cpu")
    for _, info in got:
        assert all(np.isfinite(v) for v in info["scores"].values())
    four = sweep_cluster_stack(xs + [xs[0]], k_max=8, iters=20,
                               seed=[0, 1, 2, 0], device="cpu")
    for (gl, gi), (fl, fi) in zip(got, four):
        np.testing.assert_array_equal(gl, fl)
        assert gi["scores"] == fi["scores"]


# ---------------------------------------------------------------------------
# PlanEngine: chunks, stamps and counters as JAX's engine
# ---------------------------------------------------------------------------

KW = dict(k_max=6, iters=10)


def _two_bucket_requests():
    """7 requests: 4 in bucket (32, 8), 3 in bucket (64, 8), interleaved."""
    sizes = (20, 40, 25, 50, 30, 60, 28)
    return [_blobs(60 + i, n, 8, 3) for i, n in enumerate(sizes)]


@pytest.mark.parametrize("data_devices", [0, 2])
def test_cluster_many_chunks_like_jax(data_devices):
    """max_batch 3 over 7 requests in two buckets (and, with
    data_devices=2, chunks of 3 x 2): equal ``serve.batch`` on every result,
    equal ``dispatches``, ``programs`` and ``bucket_hist``, equal labels
    and K."""
    xs = _two_bucket_requests()
    seeds = list(range(len(xs)))
    eng = PlanEngine(device="cpu", max_batch=3, record_timings=True,
                     data_devices=data_devices, **KW)
    jeng = JPlanEngine(max_batch=3, record_timings=True,
                       data_devices=data_devices, **KW)
    got = eng.cluster_many(xs, seeds)
    want = jeng.cluster_many(xs, seeds)
    for (gl, gi), (wl, wi) in zip(got, want):
        np.testing.assert_array_equal(gl, wl)
        assert gi["k"] == wi["k"]
        assert gi["serve"]["batch"] == wi["serve"]["batch"]
        assert ((gi["serve"]["points_bucket"], gi["serve"]["dim"])
                == (wi["serve"]["points_bucket"], wi["serve"]["dim"]))
    for key in ("dispatches", "programs", "bucket_hist", "errors"):
        assert eng.stats[key] == jeng.stats[key], key
    expect = [3, 3, 3, 3, 3, 3, 1] if data_devices == 0 else [4, 3, 4, 3,
                                                              4, 3, 4]
    assert [r[1]["serve"]["batch"] for r in got] == expect


def test_isolate_poison_in_the_middle_of_a_chunk(monkeypatch):
    """A request whose program breaks the sweep and the sequential
    reference alike, in the middle of a chunk of 5 (as JAX's engine
    chunks them): its siblings are served with JAX's plans (both engines
    retry the failed chunk program by program through their sequential
    reference), and only it becomes an Exception entry."""
    xs = [_blobs(70 + i, 36 + 5 * i, 8, 3) for i in range(5)]   # one bucket
    poison = xs[2]

    def poisoned(real):
        def sweep(batch, **kw):
            if any(x is poison or np.array_equal(x, poison) for x in batch):
                raise RuntimeError("poisoned sweep")
            return real(batch, **kw)
        return sweep

    def poisoned_seq(real):
        def seq(x, **kw):
            if np.array_equal(x, poison):
                raise RuntimeError("poisoned program")
            return real(x, **kw)
        return seq

    for mod in (tengine, jengine):
        monkeypatch.setattr(mod, "sweep_cluster_stack",
                            poisoned(mod.sweep_cluster_stack))
        monkeypatch.setattr(mod, "select_k_and_cluster",
                            poisoned_seq(mod.select_k_and_cluster))
    reqs = [PlanRequest(x, np.arange(len(x)), "m", seed=i)
            for i, x in enumerate(xs)]
    jreqs = [jengine.PlanRequest(x, np.arange(len(x)), "m", seed=i)
             for i, x in enumerate(xs)]
    eng = PlanEngine(device="cpu", max_batch=8, **KW)
    jeng = JPlanEngine(max_batch=8, **KW)
    got = eng.plan_many(reqs, errors="isolate")
    want = jeng.plan_many(jreqs, errors="isolate")
    assert isinstance(got[2], RuntimeError) and isinstance(want[2],
                                                           RuntimeError)
    for i in (0, 1, 3, 4):
        np.testing.assert_array_equal(got[i].labels, want[i].labels)
        assert got[i].num_clusters == want[i].num_clusters
        assert got[i].reps == want[i].reps
    assert eng.stats["errors"] == jeng.stats["errors"] == 1
    assert eng.stats["dispatches"] == jeng.stats["dispatches"] == 1


@pytest.mark.parametrize("max_batch", [2, 8])
def test_warmup_default_batch_sizes_are_jax(max_batch, monkeypatch):
    """``warmup``'s default batch sizes are JAX's: the powers of two up to
    bucket_batch(max_batch), one key each; one seeded batch of the largest
    is swept a bucket."""
    jeng = JPlanEngine(max_batch=max_batch, **KW)
    jax_sizes = []

    def warm_sweep(b, *a, **kw):
        jax_sizes.append(b)
        return 0

    monkeypatch.setattr(jengine, "warm_sweep", warm_sweep)
    jeng.warmup([(32, 8)])
    eng = PlanEngine(device="cpu", max_batch=max_batch, **KW)
    swept = []
    real = eng._dispatch_chunk
    monkeypatch.setattr(eng, "_dispatch_chunk",
                        lambda xs, seeds: swept.append(len(xs))
                        or real(xs, seeds))
    assert eng.warmup([(32, 8)]) == len(jax_sizes)
    assert sorted(b for _, _, b in eng._warm) == jax_sizes
    assert swept == [max(jax_sizes)]


def test_service_mean_batch_reads_the_stamps():
    """A service flush of up to max_batch requests of one bucket reaches
    the engine as one dispatch: ``stats()`` reports the stamps' mean batch,
    its occupancy and one dispatch time a flush."""
    xs = [_blobs(80 + i, 40, 8, 3) for i in range(6)]
    with PlanService(max_batch=3, max_delay_ms=10_000.0, device="cpu",
                     **KW) as svc:
        futs = [svc.submit(PlanRequest(x, np.arange(len(x)), "m", seed=i))
                for i, x in enumerate(xs)]
        plans = [f.result(60.0) for f in futs]
        s = svc.stats()
    batches = [p.extra["serve"]["batch"] for p in plans]
    assert batches == [3] * 6
    assert s["mean_batch"] == pytest.approx(float(np.mean(batches)))
    assert s["batch_occupancy"] == pytest.approx(1.0)
    assert s["dispatches"] == s["engine"]["dispatches"] == 2
    assert s["mean_dispatch_ms"] > 0
