"""The port's swept K-Means + silhouette K selection against the JAX sweep.

Both sides seed kmeans++ on the host with numpy (``init="host"``), so the
initial centroids are the same rows.  The port runs K2/K3's plain versions
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
    _host_preamble, _kmeanspp_init, _sweep_core, bucket_points,
    sweep_cluster_stack,
)
from repro_torch.kernels.kmeans_assign.ops import (
    kmeans_assign_fused_plain, silhouette_sums_plain,
)

SIL_TOL = 1e-3


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


def test_device_init_is_not_ported():
    with pytest.raises(NotImplementedError):
        sweep_cluster_stack([_blobs(0, 20, 4, 2)], init="device",
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
    sil = torch.sum(s, dim=1) / torch.clamp_min(torch.sum(sil_mask), 1.0)
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
    step gives the bits of the per-candidate loop: labels, silhouettes
    and ok flags exactly equal."""
    _, build, k_max, sil_cap = case
    x = build()
    inputs = _sweep_inputs(x, 0, k_max, sil_cap)
    kw = dict(k_max=k_max, iters=50, n_real=len(x))
    got = _sweep_core(*inputs, **kw)
    want = _sweep_core_per_candidate(*inputs, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
