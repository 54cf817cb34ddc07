"""The port's plan-serving load path on the CPU, against the JAX package's:
twins of ``tests/test_serving.py``'s bucket spec, load generator, stats
window and warm-pool cases, the port's served plans on a synthetic fleet
against JAX's ``PlanService`` (K, labels and representatives equal), and
the ``plan_serve`` CLI (JAX's JSON keys; it refuses to carry on without a
card unless the CPU is asked for).  Every port object runs with
``device="cpu"``."""

import json

import numpy as np
import pytest

from repro.serving import PlanService as JPlanService
from repro.serving.loadgen import LoadResult as JLoadResult
from repro_torch.launch import plan_serve
from repro_torch.sampling.engine import PlanEngine, PlanRequest, bucket_key
from repro_torch.serving import (
    PlanService, parse_buckets, poisson_arrivals, run_open_loop,
    synthetic_fleet,
)
from repro_torch.sim.simulate import SamplingPlan

KW = dict(k_max=6, iters=10)


def _req(n, d=8, seed=0, method="t"):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    return PlanRequest(x, np.arange(n), method, seed=seed)


def test_parse_buckets():
    assert parse_buckets("64x16,128x8") == [(64, 16), (128, 8)]
    assert parse_buckets(" 32x4 ,") == [(32, 4)]


def test_loadgen_poisson_and_open_loop():
    arr = poisson_arrivals(50, rate_hz=100.0, seed=0)
    assert len(arr) == 50 and np.all(np.diff(arr) > 0)
    assert 0.1 < arr[-1] < 2.5  # ~0.5s expected span

    fleet = synthetic_fleet(8, d=8, seed=1)
    with PlanService(max_batch=4, max_delay_ms=2.0, device="cpu",
                     **KW) as svc:
        svc.warmup(sorted({bucket_key(r.embeddings) for r in fleet}))
        res = run_open_loop(svc, fleet, rate_hz=200.0, seed=2)
    assert res.n_ok == 8 and res.n_err == 0
    assert res.latency_ms["p99"] >= res.latency_ms["p50"] > 0
    assert res.plans_per_s > 0
    j = res.to_json()
    assert j["service"]["served"] == 8
    assert j["service"]["engine"]["programs"] == 8


def test_stats_reset_windows_counters():
    with PlanService(max_batch=2, max_delay_ms=2.0, device="cpu",
                     **KW) as svc:
        svc.submit(_req(16)).result(30.0)
        assert svc.stats()["served"] == 1
        assert len(svc.raw_latencies_s()) == 1
        svc.reset_stats()
        s = svc.stats()
        assert s["served"] == 0 and s["latency_ms"]["p50"] is None
        assert s["engine"]["programs"] == 0
        assert svc.raw_latencies_s() == []


def test_warmup_takes_builds_off_serving_path():
    """A bucket is warmed once per engine (one sweep of a seeded matrix of
    its shape); a second warmup of the same keys warms nothing, and
    serving warms nothing either."""
    with PlanService(max_batch=4, max_delay_ms=2.0, device="cpu",
                     **KW) as svc:
        built = svc.warmup("64x8", batch_sizes=[1, 2, 4])
        assert built == 3
        assert svc.warmup([(64, 8)], batch_sizes=[1, 2, 4]) == 0
        assert svc.warmup([{"points_bucket": 40, "dim": 8}]) == 0
        warm = set(svc.engine._warm)
        futs = [svc.submit(_req(40, seed=i)) for i in range(5)]
        for f in futs:
            assert isinstance(f.result(30.0), SamplingPlan)
        assert svc.engine._warm == warm
    assert svc.stats()["engine"]["warmed_executables"] == built


@pytest.mark.parametrize("form", ["pairs", "dicts", "spec"])
def test_warmup_forms_round_points_up_to_their_bucket(form):
    """JAX's argument forms: (points, dim) pairs, {"points_bucket", "dim"}
    dicts, and (through the service) a spec string; points are rounded
    up to their power-of-two bucket; no buckets loads the kernel library
    only, which the CPU has none of.  The default batch sizes are JAX's
    (every power of two up to max_batch = 2): two keys a bucket."""
    buckets = {"pairs": [(40, 8), (100, 8)],
               "dicts": [{"points_bucket": 40, "dim": 8},
                         {"points_bucket": 100, "dim": 8}],
               "spec": "40x8,100x8"}[form]
    with PlanService(max_batch=2, device="cpu", **KW) as svc:
        assert svc.warmup() == 0
        assert svc.warmup(buckets) == 4
        assert svc.engine._warm == {(64, 8, 1), (64, 8, 2), (128, 8, 1),
                                    (128, 8, 2)}
        assert svc.warmup(buckets) == 0


@pytest.mark.parametrize("engine", ["sweep", "sequential"])
def test_warmup_with_device_init_draws_once_per_bucket(engine, monkeypatch):
    """init="device": warming a bucket draws the device seeding once for
    each program of its warm batch (the sweep: a batch of the largest
    default batch size, bucket_batch(max_batch) = 8 programs, as JAX's
    engine dispatches them; the sequential engine: one program), every
    draw at the bucket's shape with k_up = min(k_max, points - 1), the
    key JAX's ``warm_sweep`` pre-builds its device init for; a warm
    bucket draws nothing more.  JAX's default batch sizes give four keys
    a bucket."""
    from repro_torch.core import clustering

    calls = []
    real = clustering._device_init

    def counted(xb, pmask, seed, k_up):
        calls.append((tuple(xb.shape), int(pmask.sum()), k_up))
        return real(xb, pmask, seed, k_up)

    monkeypatch.setattr(clustering, "_device_init", counted)
    eng = PlanEngine(device="cpu", init="device", engine=engine, **KW)
    assert eng.warmup([(40, 8), (100, 8)]) == 8
    per = 8 if engine == "sweep" else 1
    assert calls == ([((64, 8), 64, KW["k_max"])] * per
                     + [((128, 8), 128, KW["k_max"])] * per)
    assert eng.warmup([(64, 8)]) == 0 and len(calls) == 2 * per


def test_engine_cluster_and_reset_stats():
    eng = PlanEngine(device="cpu", **KW)
    x = synthetic_fleet(1, d=8, seed=4)[0].embeddings
    labels, info = eng.cluster(x)
    want_labels, want_info = eng.cluster_many([x])[0]
    assert np.array_equal(labels, want_labels) and info["k"] == want_info["k"]
    assert eng.stats["programs"] == 2
    eng.reset_stats()
    assert eng.stats == PlanEngine._fresh_stats()


def test_served_plans_match_jax_service():
    """The port's PlanService and JAX's serve the same synthetic fleet
    (blob-structured embeddings, per-request seeds): equal K, labels and
    representatives for every request."""
    fleet = synthetic_fleet(6, d=8, seed=3)
    with JPlanService(max_batch=4, max_delay_ms=2.0, **KW) as jsvc:
        want = [f.result(120.0) for f in [jsvc.submit(r) for r in fleet]]
    with PlanService(max_batch=4, max_delay_ms=2.0, device="cpu",
                     **KW) as svc:
        got = [f.result(120.0) for f in [svc.submit(r) for r in fleet]]
    for g, w in zip(got, want):
        assert g.num_clusters == w.num_clusters
        assert g.extra["k"] == w.extra["k"]
        assert np.array_equal(g.labels, w.labels)
        assert g.reps == w.reps


def test_plan_serve_cli_writes_jax_keys(tmp_path):
    """``--smoke --device cpu``: one load, 40 requests, every request
    served; the JSON has the JAX launcher's keys down to each load's
    service stats (the engine's own counters differ: no executables, one
    device)."""
    path = tmp_path / "ps.json"
    assert plan_serve.main(["--smoke", "--device", "cpu", "--json",
                            str(path)]) == 0
    doc = json.loads(path.read_text())
    assert set(doc) == {"buckets", "loads"}
    fleet = synthetic_fleet(40, d=16, seed=0)
    assert doc["buckets"] == [list(b) for b in sorted(
        {bucket_key(r.embeddings) for r in fleet})]
    (row,) = doc["loads"]
    jrow = JLoadResult(1.0, 1, 1, 0, 1.0, 1.0, {}).to_json()
    assert set(row) == set(jrow)
    assert set(row["latency_ms"]) == {"p50", "p99", "mean", "max"}
    assert row["n_requests"] == 40 and row["n_ok"] == 40
    assert row["n_err"] == 0 and row["offered_per_s"] == 100.0
    with JPlanService(max_batch=8, **KW) as jsvc:
        jstats = jsvc.stats()
    assert set(row["service"]) == set(jstats)
    assert row["service"]["served"] == 40


def test_plan_serve_cli_refuses_a_missing_card(monkeypatch):
    """Without ``--device`` the launcher runs on the card, and raises when
    there is none."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plan_serve.main(["--smoke"])
