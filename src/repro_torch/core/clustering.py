"""K-Means + silhouette K selection (paper §3.4), swept path.
Counterpart of the sweep in ``repro/core/clustering.py``.

For one program's embeddings, every candidate K in 2..k_max is fitted with
masked Lloyd iterations from a shared kmeans++ seeding (drawn on the host
with numpy, as the JAX default ``init="host"`` does), scored with a masked
silhouette on a deterministic subsample, and the K-selection rule picks the
result: maximise silhouette, prefer the smaller K on near-ties, collapse to
K=1 below the floor.  Tiny programs (n <= 4) fall back to distance-threshold
agglomeration on the host.

Where JAX ``vmap``s the candidates and ``lax.scan``s the Lloyd steps inside
one executable, the port writes the candidate axis out as a Python loop:
each Lloyd step is one ``kmeans_assign_fused`` call (K2) plus a plain
centroid update, each candidate's score one ``silhouette_sums`` call (K3);
the silhouette arithmetic over all candidates is plain torch.  Points are
padded to a power-of-two bucket with masks exactly as in JAX, so padding
never moves a result.  The sequential reference and on-device kmeans++
(``init="device"``) wait for later slices.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.kmeans_assign.ops import (
    kmeans_assign_fused, silhouette_sums,
)
from repro_torch.utils.device import resolve_device

#: points-axis power-of-two bucket floor for the swept engine
POINT_FLOOR = 32


def bucket_points(n: int) -> int:
    """Next power-of-two points bucket >= POINT_FLOOR (the sweep's padding
    unit; PlanEngine groups requests by this same key)."""
    b = POINT_FLOOR
    while b < n:
        b <<= 1
    return b


def _kmeanspp_init(x, k, seed):
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    idx = [int(rng.integers(n))]
    d = np.sum((x - x[idx[0]]) ** 2, axis=1)
    for _ in range(1, k):
        tot = d.sum()
        if not np.isfinite(tot) or tot <= 1e-20:
            nxt = int(rng.integers(n))  # degenerate: all points coincide
        else:
            nxt = int(rng.choice(n, p=d / tot))
        idx.append(nxt)
        d = np.minimum(d, np.sum((x - x[nxt]) ** 2, axis=1))
    return np.array(idx)


def _agglomerate_threshold(x, thresh=0.25):
    """Tiny-n fallback: single-link merge on relative euclidean distance."""
    n = len(x)
    labels = np.arange(n)
    scale = np.mean(np.linalg.norm(x, axis=1)) + 1e-9
    for i in range(n):
        for j in range(i + 1, n):
            if np.linalg.norm(x[i] - x[j]) / scale < thresh:
                labels[labels == labels[j]] = labels[i]
    _, labels = np.unique(labels, return_inverse=True)
    return labels


def _choose_k(scores: dict[int, float], sil_floor: float, tie_tol: float):
    """Maximize silhouette, prefer the smaller K on near-ties, collapse to
    K=1 below the floor.  Returns (chosen_k, best_score); chosen_k is None
    on the K=1 collapse."""
    best = max(scores.values())
    if best < sil_floor:
        return None, best
    return min(k for k, s in scores.items() if s >= best - tie_tol), best


def _host_preamble(x, seed, tiny_n, sil_cap):
    """Degenerate/tiny handling + the deterministic silhouette subsample.
    Returns either (labels, info) for an early exit or (None, sil_idx)."""
    n = len(x)
    if n <= 1:
        return (np.zeros(n, int),
                {"k": max(n, 0), "sil": 1.0, "mode": "trivial"}), None
    if n <= tiny_n:
        labels = _agglomerate_threshold(x)
        return (labels,
                {"k": int(labels.max()) + 1, "sil": 1.0, "mode": "tiny"}), None
    sil_idx = None
    if n > sil_cap:
        sil_idx = np.random.default_rng(seed).choice(n, sil_cap, replace=False)
    return None, sil_idx


def _sweep_core(x, pmask, init_idx, sil_mask, *, k_max: int, iters: int,
                n_real: int):
    """One program, every valid candidate K (2..min(k_max, n-1)).

    ``x`` (n_pad, d), ``pmask``/``sil_mask`` (n_pad,) and ``init_idx``
    (k_max,) live on one device.  Returns (labels (num_k, n_pad) int32,
    sil (num_k,), ok (num_k,) bool) on that device, num_k = k_max - 1;
    candidates above n-1 are not fitted and come back ``ok=False``."""
    n_pad = x.shape[0]
    dev = x.device
    num_k = k_max - 1
    k_top = min(k_max, n_real - 1)
    cent0 = x[init_idx.long()]                              # (k_max, d)
    slots = torch.arange(k_max, device=dev)
    labels_all = torch.zeros(num_k, n_pad, dtype=torch.int32, device=dev)
    sums_all = torch.zeros(num_k, n_pad, k_max, dtype=torch.float32,
                           device=dev)
    onehot_all = torch.zeros_like(sums_all)
    for ki, k in enumerate(range(2, k_top + 1)):
        cmask = (slots < k).to(torch.float32)
        cent = cent0
        for _ in range(iters):
            _, _, sums, cnts = kmeans_assign_fused(x, cent, cmask, pmask)
            cent = torch.where((cnts > 0)[:, None],
                               sums / torch.clamp_min(cnts, 1)[:, None], cent)
        lab, _, _, _ = kmeans_assign_fused(x, cent.contiguous(), cmask, pmask)
        onehot = (torch.nn.functional.one_hot(lab.long(), k_max)
                  .to(torch.float32) * sil_mask[:, None])
        labels_all[ki] = lab
        onehot_all[ki] = onehot
        sums_all[ki] = silhouette_sums(x, onehot.contiguous())

    # vectorized masked silhouette over the candidates (the JAX sweep's
    # arithmetic; empty clusters are excluded via cnt > 0)
    inf = torch.tensor(float("inf"), device=dev)
    cnt = onehot_all.sum(1)                                 # (num_k, k_max)
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
    n_live = torch.sum(cnt > 0, dim=1)
    k_valid = torch.arange(2, k_max + 1, device=dev) <= k_top
    ok = k_valid & (n_live >= 2)
    return labels_all, sil, ok


def _finish_one(labels_all, sil, ok, n, ks, sil_floor, tie_tol):
    """Host-side selection over the swept scores (shared ``_choose_k``)."""
    scores = {int(ks[i]): float(sil[i]) for i in range(len(ks)) if ok[i]}
    if not scores:
        return np.zeros(n, int), {"k": 1, "sil": 0.0, "mode": "degenerate",
                                  "engine": "sweep"}
    chosen, best = _choose_k(scores, sil_floor, tie_tol)
    if chosen is None:
        return np.zeros(n, int), {"k": 1, "sil": best, "mode": "weak->K=1",
                                  "engine": "sweep"}
    _, lab = np.unique(labels_all[chosen - 2][:n], return_inverse=True)
    return lab, {
        "k": int(lab.max()) + 1, "sil": scores[chosen], "mode": "silhouette",
        "scores": scores, "engine": "sweep",
    }


def sweep_cluster_stack(
    xs: list,
    k_max: int = 48,
    seed=0,
    sil_floor: float = 0.20,
    tie_tol: float = 0.02,
    tiny_n: int = 4,
    sil_cap: int = 1200,
    iters: int = 50,
    init: str = "host",
    device=None,
):
    """Plan many programs, one sweep dispatch each: every program is padded
    to its own power-of-two points bucket and every candidate K evaluated
    on ``device`` (the card unless ``"cpu"`` is asked for).  Tiny/trivial
    programs take the host fallback.  Returns a list of (labels, info)
    aligned with ``xs``; ``seed`` is an int or a per-program sequence."""
    if init != "host":
        raise NotImplementedError(
            f"init={init!r}: on-device kmeans++ is not in the PyTorch port "
            f"yet; the host seeding (init='host') is")
    dev = resolve_device(device)
    xs = [np.asarray(x, np.float32) for x in xs]
    seeds = ([int(seed)] * len(xs) if np.isscalar(seed)
             else [int(s) for s in seed])
    out: list = [None] * len(xs)
    ks = list(range(2, k_max + 1))
    for i, x in enumerate(xs):
        done, sil_idx = _host_preamble(x, seeds[i], tiny_n, sil_cap)
        if done is not None:
            out[i] = done
            continue
        if x.ndim != 2 or x.shape[1] == 0:
            # featureless embeddings: the degenerate K=1 collapse, decided
            # on the host
            out[i] = (np.zeros(len(x), int),
                      {"k": 1, "sil": 0.0, "mode": "degenerate",
                       "engine": "sweep"})
            continue
        n, d = x.shape
        n_pad = bucket_points(n)
        xb = np.zeros((n_pad, d), np.float32)
        xb[:n] = x
        pmask = np.zeros(n_pad, np.float32)
        pmask[:n] = 1.0
        silm = np.zeros(n_pad, np.float32)
        if sil_idx is None:
            silm[:n] = 1.0
        else:
            silm[sil_idx] = 1.0
        init_idx = np.zeros(k_max, np.int32)
        k_up = min(k_max, n - 1)
        init_idx[:k_up] = _kmeanspp_init(x, k_up, seeds[i])
        labels_all, sil, ok = _sweep_core(
            torch.from_numpy(xb).to(dev), torch.from_numpy(pmask).to(dev),
            torch.from_numpy(init_idx).to(dev),
            torch.from_numpy(silm).to(dev), k_max=k_max, iters=iters,
            n_real=n)
        out[i] = _finish_one(labels_all.cpu().numpy(), sil.cpu().numpy(),
                             ok.cpu().numpy(), n, ks, sil_floor, tie_tol)
    return out


def select_k_and_cluster_swept(x: np.ndarray, **kw):
    """Single-program front door for the K sweep."""
    return sweep_cluster_stack([np.asarray(x, np.float32)], **kw)[0]
