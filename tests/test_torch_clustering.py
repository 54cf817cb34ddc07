"""The port's swept K-Means + silhouette K selection against the JAX sweep.

Both sides seed kmeans++ on the host with numpy (``init="host"``), so the
initial centroids are the same rows.  The on-device seeding
(``init="device"``) is held to JAX's on JAX's own Gumbel draws (equal
indices), and the port's sweep to its sequential reference.  The port runs K2/K3's plain versions
on the CPU; JAX runs its jnp sweep.  Labels, K and mode must be equal.

Silhouette scores: the port's score of its chosen K equals an exact float64
silhouette of its labels to 1e-5.  Against JAX, every per-K score agrees to
SIL_TOL = 1e-3: both evaluate distances as sqrt(|x|^2 - 2 x.y + |y|^2), and
a point's distance to itself comes out exactly 0 in the port (norms taken
from the Gram diagonal) but, depending on how XLA orders the two sums, as
float32 cancellation noise of up to sqrt(3 d eps max|x|^2) in JAX.  Spread
over a cluster of c points that is ~ noise / ((c-1) a) per point: 5e-4 on
these inputs (d = 8, |x|^2 ~ 520, a ~ 4), largest at large K where clusters
are small.  The measured gap here is <= 3.1e-4.  The port is held against
the JAX *sweep* only: JAX's sweep and its sequential reference disagree
with each other on some inputs (ROADMAP.md, C2).
"""

import numpy as np
import pytest
import torch

from repro.core.clustering import sweep_cluster_stack as jax_sweep
from repro_torch.core.clustering import (
    _host_preamble, _kmeanspp_init, _pad_bucket, _sweep_core, _tree_sum,
    bucket_points, device_gumbel, device_init_indices, device_kmeanspp,
    sweep_cluster_stack,
)
from repro_torch.kernels.kmeans_assign.ops import (
    kmeans_assign_fused_plain, silhouette_sums_plain,
)

SIL_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: several test processes on one host would
    otherwise oversubscribe the cores with spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _exact_silhouette(x, labels, sil_idx):
    """Float64 mean silhouette (clusters of one contribute 0) over the
    subset ``sil_idx`` — the definition the sweep vectorizes."""
    x = np.asarray(x, np.float64)[sil_idx]
    lab = np.asarray(labels)[sil_idx]
    d = np.sqrt(((x[:, None, :] - x[None, :, :]) ** 2).sum(-1))
    s = np.zeros(len(x))
    for i in range(len(x)):
        own = lab == lab[i]
        if own.sum() <= 1:
            continue
        a = d[i, own].sum() / (own.sum() - 1)
        b = min(d[i, lab == c].mean() for c in np.unique(lab) if c != lab[i])
        s[i] = (b - a) / max(a, b, 1e-12)
    return float(s.mean())


def _blobs(seed, n, d, k, spread=8.0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)) * spread
    lab = rng.integers(0, k, n)
    return (centers[lab] + rng.standard_normal((n, d))).astype(np.float32)


def _duplicates(seed, n, d, m):
    """n points that are copies of m distinct rows (the shape of real
    programs: cfd has 2425 invocations of 5 distinct kernels)."""
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((m, d)).astype(np.float32)
    return rows[rng.integers(0, m, n)]


# (case id, inputs builder, sweep kwargs)
CASES = [
    ("blobs_3", lambda: [_blobs(0, 60, 8, 3)], dict(k_max=8)),
    ("blobs_5_kmax48", lambda: [_blobs(1, 120, 16, 5)], dict(k_max=48)),
    ("subsampled_silhouette", lambda: [_blobs(2, 90, 8, 4)],
     dict(k_max=8, sil_cap=40)),
    ("duplicates", lambda: [_duplicates(3, 200, 32, 5)], dict(k_max=12)),
    ("stack_mixed", lambda: [_blobs(4, 40, 8, 2), _blobs(5, 70, 8, 4),
                             _blobs(6, 3, 8, 2)], dict(k_max=8, seed=[0, 1, 2])),
    ("tiny", lambda: [_blobs(7, 4, 8, 2)], dict(k_max=8)),
    ("trivial", lambda: [np.zeros((1, 8), np.float32),
                         np.zeros((0, 8), np.float32)], dict(k_max=8)),
    ("featureless", lambda: [np.zeros((10, 0), np.float32)], dict(k_max=8)),
    ("all_identical", lambda: [np.ones((30, 8), np.float32)], dict(k_max=8)),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_sweep_matches_jax_sweep(case):
    _, build, kw = case
    xs = build()
    got = sweep_cluster_stack(xs, device="cpu", **kw)
    want = jax_sweep(xs, init="host", **kw)
    assert len(got) == len(want) == len(xs)
    seeds = kw.get("seed", [0] * len(xs))
    for x, seed, (gl, gi), (wl, wi) in zip(xs, seeds, got, want):
        np.testing.assert_array_equal(np.asarray(gl), np.asarray(wl))
        assert gi["k"] == wi["k"] and gi["mode"] == wi["mode"]
        np.testing.assert_allclose(gi["sil"], wi["sil"], rtol=0,
                                   atol=SIL_TOL)
        gs, ws = gi.get("scores", {}), wi.get("scores", {})
        assert sorted(gs) == sorted(ws)
        for k in ws:
            np.testing.assert_allclose(gs[k], ws[k], rtol=0, atol=SIL_TOL,
                                       err_msg=f"K={k}")
        if gi["mode"] == "silhouette":
            cap = kw.get("sil_cap", 1200)
            sil_idx = (np.random.default_rng(seed).choice(len(x), cap,
                                                          replace=False)
                       if len(x) > cap else np.arange(len(x)))
            assert gi["sil"] == pytest.approx(
                _exact_silhouette(x, gl, sil_idx), abs=1e-5)


def jax_gumbel_rows(seed, k_up, n_pad):
    """JAX's draws for ``_device_kmeanspp``: draw t's Gumbel noise from
    ``fold_in(PRNGKey(seed), t)`` at the bucket shape (``categorical`` is
    the argmax of that noise plus the logits)."""
    import jax
    import jax.numpy as jnp

    key = jax.random.PRNGKey(seed)
    return np.stack([np.asarray(jax.random.gumbel(
        jax.random.fold_in(key, t), (n_pad,), jnp.float32))
        for t in range(k_up)])


def on_jax_draws(monkeypatch):
    """Patch JAX's Gumbel rows in for the port's own draws (the port's
    generators draw other numbers than JAX's threefry, as in the fit)."""
    from repro_torch.core import clustering

    monkeypatch.setattr(
        clustering, "device_gumbel", lambda seed, k_up, n_pad, device:
        torch.from_numpy(jax_gumbel_rows(seed, k_up, n_pad)).to(device))


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("n,d,k_up,case", [
    (20, 4, 8, "blobs"), (32, 8, 31, "blobs"), (45, 16, 12, "blobs"),
    (130, 3, 48, "blobs"), (60, 8, 10, "duplicates"),
    (40, 4, 10, "coincident"), (24, 1, 6, "normal")])
def test_device_kmeanspp_on_jax_draws_equals_jax(seed, n, d, k_up, case):
    """Fed JAX's own Gumbel rows, the port's on-device kmeans++ draws JAX's
    ``device_init_indices`` exactly: below the bucket (n < n_pad), at it,
    with duplicate rows, and with every point coincident (the total D^2
    falls to 0 after the first draw and the draws go uniform)."""
    from repro.core.clustering import device_init_indices as jax_init

    if case == "blobs":
        x = _blobs(seed, n, d, 4)
    elif case == "duplicates":
        x = _duplicates(seed, n, d, 5)
    elif case == "coincident":
        x = np.full((n, d), 1.5, np.float32)
    else:
        x = np.random.default_rng(seed).standard_normal((n, d)).astype(
            np.float32)
    xb, pmask = _pad_bucket(x)
    got = device_kmeanspp(torch.from_numpy(xb), torch.from_numpy(pmask),
                          torch.from_numpy(jax_gumbel_rows(seed, k_up,
                                                            len(xb))))
    assert got.dtype == torch.int32 and got.shape == (k_up,)
    np.testing.assert_array_equal(got.numpy(), jax_init(x, seed, k_up))
    assert got.max() < n                        # live points only


def test_device_init_draws_at_the_bucket_shape():
    """The port's own draws (torch generators seeded from (seed, t)):
    deterministic, live points only, and taken at the bucket shape, so the
    entry point and a direct call on the padded inputs agree."""
    x = _blobs(5, 50, 8, 3)
    a = device_init_indices(x, 7, 20, device="cpu")
    np.testing.assert_array_equal(a, device_init_indices(x, 7, 20,
                                                         device="cpu"))
    assert a.dtype == np.int32 and a.max() < 50
    xb, pmask = _pad_bucket(x)
    g = device_gumbel(7, 20, len(xb), "cpu")
    assert g.shape == (20, bucket_points(50)) and torch.isfinite(g).all()
    np.testing.assert_array_equal(a, device_kmeanspp(
        torch.from_numpy(xb), torch.from_numpy(pmask), g).numpy())
    assert not np.array_equal(a, device_init_indices(x, 8, 20,
                                                     device="cpu"))


DEVICE_CASES = [c for c in CASES if c[0] in (
    "blobs_3", "blobs_5_kmax48", "duplicates", "stack_mixed",
    "all_identical")]


@pytest.mark.parametrize("case", DEVICE_CASES,
                         ids=[c[0] for c in DEVICE_CASES])
def test_device_init_sweep_on_jax_draws_matches_jax_sweep(case,
                                                          monkeypatch):
    """init="device" on JAX's draws: the port's sweep equals JAX's sweep
    with its on-device seeding (labels, K, mode; scores within SIL_TOL)."""
    _, build, kw = case
    on_jax_draws(monkeypatch)
    xs = build()
    got = sweep_cluster_stack(xs, device="cpu", init="device", **kw)
    want = jax_sweep(xs, init="device", **kw)
    for (gl, gi), (wl, wi) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(gl), np.asarray(wl))
        assert gi["k"] == wi["k"] and gi["mode"] == wi["mode"]
        gs, ws = gi.get("scores", {}), wi.get("scores", {})
        assert sorted(gs) == sorted(ws)
        for k in ws:
            np.testing.assert_allclose(gs[k], ws[k], rtol=0, atol=SIL_TOL,
                                       err_msg=f"K={k}")


@pytest.mark.parametrize("seed", [0, 2])
def test_device_init_sweep_equals_sequential(seed):
    """init="device": the sweep and the sequential reference seed from the
    same draws and give equal labels and K (JAX's
    ``test_device_init_parity``)."""
    from repro_torch.core.clustering import select_k_and_cluster

    x = _blobs(11 + seed, 120, 8, 4)
    (ls, info_s), = sweep_cluster_stack([x], k_max=10, seed=seed,
                                        init="device", device="cpu")
    lq, info_q = select_k_and_cluster(x, k_max=10, seed=seed, init="device",
                                      device="cpu")
    np.testing.assert_array_equal(ls, lq)
    assert info_s["k"] == info_q["k"] and info_s["mode"] == info_q["mode"]
    assert info_s["sil"] == pytest.approx(info_q["sil"], abs=1e-5)


def test_device_init_independent_of_batch_composition():
    """A program's device draws are taken at its own points bucket, so a
    much larger program beside it changes nothing."""
    small = _blobs(1, 30, 8, 3)          # bucket 32
    big = _blobs(2, 240, 8, 4)           # bucket 256
    solo = sweep_cluster_stack([small], k_max=8, seed=3, init="device",
                               device="cpu")[0]
    batched = sweep_cluster_stack([small, big], k_max=8, seed=3,
                                  init="device", device="cpu")[0]
    np.testing.assert_array_equal(solo[0], batched[0])
    assert solo[1]["k"] == batched[1]["k"]


def test_unknown_init_raises():
    with pytest.raises(ValueError, match="init"):
        sweep_cluster_stack([_blobs(0, 20, 4, 2)], init="random",
                            device="cpu")


def _sweep_inputs(x, seed, k_max, sil_cap):
    """``sweep_cluster_stack``'s padded inputs for one program."""
    n, d = x.shape
    n_pad = bucket_points(n)
    xb = np.zeros((n_pad, d), np.float32)
    xb[:n] = x
    pmask = (np.arange(n_pad) < n).astype(np.float32)
    _, sil_idx = _host_preamble(x, seed, 4, sil_cap)
    silm = np.zeros(n_pad, np.float32)
    silm[np.arange(n) if sil_idx is None else sil_idx] = 1.0
    init_idx = np.zeros(k_max, np.int32)
    k_up = min(k_max, n - 1)
    init_idx[:k_up] = _kmeanspp_init(x, k_up, seed)
    return tuple(torch.from_numpy(a) for a in (xb, pmask, init_idx, silm))


def _sweep_core_per_candidate(x, pmask, init_idx, sil_mask, *, k_max, iters,
                              n_real):
    """The sweep with its candidate axis written out as a Python loop: one
    Lloyd fit per candidate K, each step one single-candidate assignment
    (``kmeans_assign_fused_plain``), then the same silhouette arithmetic."""
    n_pad = x.shape[0]
    num_k, k_top = k_max - 1, min(k_max, n_real - 1)
    cent0 = x[init_idx.long()]
    slots = torch.arange(k_max)
    labels_all = torch.zeros(num_k, n_pad, dtype=torch.int32)
    sums_all = torch.zeros(num_k, n_pad, k_max)
    onehot_all = torch.zeros_like(sums_all)
    for ki, k in enumerate(range(2, k_top + 1)):
        cmask = (slots < k).to(torch.float32)
        cent = cent0
        for _ in range(iters):
            _, _, sums, cnts = kmeans_assign_fused_plain(x, cent, cmask,
                                                         pmask)
            cent = torch.where((cnts > 0)[:, None],
                               sums / torch.clamp_min(cnts, 1)[:, None], cent)
        lab = kmeans_assign_fused_plain(x, cent.contiguous(), cmask,
                                        pmask)[0]
        onehot = (torch.nn.functional.one_hot(lab.long(), k_max)
                  .to(torch.float32) * sil_mask[:, None])
        labels_all[ki], onehot_all[ki] = lab, onehot
        sums_all[ki] = silhouette_sums_plain(x, onehot)
    inf = torch.tensor(float("inf"))
    cnt = onehot_all.sum(1)
    own_cnt = torch.einsum("knc,kc->kn", onehot_all, cnt)
    own_sum = torch.sum(sums_all * onehot_all, dim=2)
    a = own_sum / torch.clamp_min(own_cnt - 1, 1)
    mean_other = sums_all / torch.clamp_min(cnt[:, None, :], 1)
    mean_other = torch.where(onehot_all > 0, inf, mean_other)
    mean_other = torch.where(cnt[:, None, :] > 0, mean_other, inf)
    b = torch.min(mean_other, dim=2).values
    s = (b - a) / torch.clamp_min(torch.maximum(a, b), 1e-12)
    s = torch.where(own_cnt > 1, s, torch.zeros_like(s)) * sil_mask[None, :]
    sil = _tree_sum(s) / torch.clamp_min(torch.sum(sil_mask), 1.0)
    k_valid = torch.arange(2, k_max + 1) <= k_top
    return labels_all, sil, k_valid & (torch.sum(cnt > 0, dim=1) >= 2)


# (case id, inputs builder, k_max, sil_cap): n <= 64, d in {12, 24},
# k_max <= 8, so at most 7 candidates
CORE_CASES = [
    ("blobs_d12", lambda: _blobs(10, 60, 12, 4), 8, 1200),
    ("duplicates_d24", lambda: _duplicates(11, 64, 24, 3), 8, 1200),
    ("subsampled_d12", lambda: _blobs(12, 50, 12, 3), 8, 20),
    ("few_points_d24", lambda: _blobs(13, 5, 24, 2), 8, 1200),
    ("kmax_5_d12", lambda: _blobs(14, 33, 12, 5), 5, 1200),
]


@pytest.mark.parametrize("case", CORE_CASES, ids=[c[0] for c in CORE_CASES])
def test_sweep_core_equals_per_candidate_loop(case):
    """On the CPU, the sweep with all candidates in one K2 call per Lloyd
    step (one program on the program axis) gives the bits of the
    per-candidate loop: labels, silhouettes and ok flags exactly equal."""
    _, build, k_max, sil_cap = case
    x = build()
    inputs = _sweep_inputs(x, 0, k_max, sil_cap)
    got = [t[0] for t in _sweep_core(*(t[None] for t in inputs),
                                     k_max=k_max, iters=50,
                                     n_real=[len(x)])]
    want = _sweep_core_per_candidate(*inputs, k_max=k_max, iters=50,
                                     n_real=len(x))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
