"""K-Means + silhouette K selection (paper §3.4).
Counterpart of ``repro/core/clustering.py``.

For one program's embeddings, every candidate K in 2..k_max is fitted with
Lloyd iterations from a kmeans++ seeding, scored with a silhouette on a
deterministic subsample, and the K-selection rule picks the result:
maximise silhouette, prefer the smaller K on near-ties, collapse to K=1
below the floor.  Tiny programs (n <= 4) fall back to distance-threshold
agglomeration on the host.  The seeding is drawn on the host with numpy
(``init="host"``, the default) or on the device (``init="device"``:
``device_init_indices``, D^2 sampling over the program's padded points
bucket, so both implementations draw the same indices).  Two
implementations share that rule:

- the sequential reference (``select_k_and_cluster``): one K-Means fit per
  candidate K, each Lloyd step one ``kmeans_assign`` call (K4) plus a
  one-hot matmul centroid update, and one silhouette per candidate from
  ``silhouette_sums`` (K3);
- the swept engine (``sweep_cluster_stack``): centroids padded to k_max
  with masked Lloyd steps, many programs a dispatch.  As JAX's default
  engine stacks a chunk of programs on a leading program axis and runs
  every candidate of every program inside one vmapped executable, each
  Lloyd step of the port is one K2 call for all the candidates of all the
  programs of a dispatch (their centroids one (B, C, k_max, d) tensor)
  plus the centroid update, and the final assignment one more; K3 runs
  once per candidate for every program, and the silhouette arithmetic
  over all programs and candidates is plain torch.  Points are padded to
  the chunk's largest power-of-two bucket and the program axis to a
  power of two (``bucket_batch``) with masks exactly as in JAX, so padding
  never moves a result: a program's labels, K and scores have the same
  bits alone and in any chunk.  A dispatch may be placed across devices
  (``data_shards``, JAX's ``_shard_args`` over a 1-D data mesh): its
  stacked program axis is split into equal slices, each swept on its own
  device, and the results are read back in program order.
"""

from __future__ import annotations

from contextlib import nullcontext as _nullctx

import numpy as np
import torch

from repro_torch.kernels.kmeans_assign.ops import (
    K2Workspace, kmeans_assign, kmeans_assign_fused_batched, silhouette_sums,
)
from repro_torch.launch.mesh import make_data_mesh, visible_devices
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


def bucket_batch(n: int) -> int:
    """Power-of-two program-axis padding for a chunk of n programs (JAX's
    rule; the padded rows have an all-zero pmask and are inert)."""
    b = 1
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


def _check_init(init: str) -> None:
    if init not in ("host", "device"):
        raise ValueError(f"init must be 'host'|'device': {init!r}")


def _pad_bucket(x: np.ndarray):
    """(x padded with zero rows to its points bucket, the points mask)."""
    n = len(x)
    n_pad = bucket_points(n)
    xb = np.zeros((n_pad, x.shape[1]), np.float32)
    xb[:n] = x
    return xb, (np.arange(n_pad) < n).astype(np.float32)


def device_gumbel(seed: int, k_up: int, n_pad: int, device) -> torch.Tensor:
    """(k_up, n_pad) float32 Gumbel noise on ``device``: row t is draw t's,
    from a generator seeded with ``draw_seed(seed, t)`` (the port's
    counterpart of ``fold_in(PRNGKey(seed), t)``), as JAX's ``gumbel``
    makes it: ``-log(-log(u))``, u uniform in [tiny, 1)."""
    from repro_torch.core.train import draw_seed

    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    rows = torch.empty(k_up, n_pad, dtype=torch.float32, device=dev)
    for t in range(k_up):
        gen.manual_seed(draw_seed(seed, t))
        rows[t].uniform_(generator=gen)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(rows.clamp_min_(tiny)))


def device_kmeanspp(x: torch.Tensor, pmask: torch.Tensor,
                    gumbel: torch.Tensor) -> torch.Tensor:
    """kmeans++ (D^2 sampling) over the live points (``pmask`` > 0) of
    ``x`` (n_pad, d), one draw per row of ``gumbel`` (k_up, n_pad): draw t
    is the argmax of its noise plus log D^2 (draw 0, and any draw once the
    total D^2 is <= 1e-20, over the live points uniformly), as JAX's
    ``categorical`` draws.  Returns (k_up,) int32 indices on ``x``'s
    device; every prefix is a valid seeding.  Nothing is read back to the
    host between draws."""
    ninf = float("-inf")
    base = torch.where(pmask > 0, 0.0, ninf)

    def sqdist(i):                            # i: (1,) index, no host sync
        # lint: allow[R4] seeding: no gradient flows through the clustering
        return torch.sum((x - x.index_select(0, i)) ** 2, dim=1) * pmask

    nxt = torch.argmax(gumbel[0] + base).view(1)
    d = sqdist(nxt)
    idx = [nxt]
    for t in range(1, gumbel.shape[0]):
        dlog = torch.where(d > 0, torch.log(torch.clamp_min(d, 1e-30)), ninf)
        logits = torch.where(torch.sum(d) > 1e-20, dlog, base)
        nxt = torch.argmax(gumbel[t] + logits).view(1)
        d = torch.minimum(d, sqdist(nxt))
        idx.append(nxt)
    return torch.cat(idx).to(torch.int32)


def _device_init(xb: torch.Tensor, pmask: torch.Tensor, seed: int,
                 k_up: int) -> torch.Tensor:
    return device_kmeanspp(xb, pmask, device_gumbel(seed, k_up, xb.shape[0],
                                                    xb.device))


def device_init_indices(x: np.ndarray, seed: int, k_up: int,
                        device=None) -> np.ndarray:
    """Host entry point of the on-device kmeans++ seeding: ``x`` (n, d) is
    padded to its points bucket on the host and the k_up indices are drawn
    on ``device`` (the card unless ``"cpu"``) at that shape, so the
    sequential reference and the sweep draw identical indices."""
    dev = resolve_device(device)
    xb, pmask = _pad_bucket(np.asarray(x, np.float32))
    idx = _device_init(torch.from_numpy(xb).to(dev),
                       torch.from_numpy(pmask).to(dev), int(seed), k_up)
    return idx.cpu().numpy()


# ---------------------------------------------------------------------------
# sequential reference path (one fit per candidate K)
# ---------------------------------------------------------------------------

def _kmeans_run(x, init_idx, k: int, iters: int = 50):
    """Lloyd's algorithm on the device of ``x`` (n, d) from the rows
    ``init_idx``: ``iters`` K4 assigns, each followed by a one-hot matmul
    centroid update (a fixed-order sum, as JAX's ``onehot.T @ x``; empty
    clusters keep their centroid), then one final assign.  Returns
    (labels (n,) int32, centroids (k, d), inertia) as tensors."""
    cent = x[init_idx.long()].contiguous()
    slots = torch.arange(k, device=x.device)
    for _ in range(iters):
        lab, _ = kmeans_assign(x, cent)
        onehot = (lab[:, None].long() == slots[None, :]).to(x.dtype)
        sums = onehot.T @ x
        cnts = onehot.sum(0)[:, None]
        cent = torch.where(cnts > 0, sums / torch.clamp_min(cnts, 1),
                           cent).contiguous()
    lab, mind = kmeans_assign(x, cent)
    return lab, cent, torch.sum(mind)


def kmeans(x: np.ndarray, k: int, seed: int = 0, iters: int = 50,
           init_idx=None, device=None):
    """Returns (labels (n,), centroids (k,d), inertia) as numpy / float.
    ``init_idx`` overrides the kmeans++ seeding."""
    x = np.asarray(x, np.float32)
    if k >= len(x):
        return np.arange(len(x)), x.copy(), 0.0
    dev = resolve_device(device)
    init = _kmeanspp_init(x, k, seed) if init_idx is None else init_idx[:k]
    lab, cent, inertia = _kmeans_run(
        torch.from_numpy(x).to(dev),
        torch.from_numpy(np.asarray(init, np.int64)).to(dev), k, iters)
    return lab.cpu().numpy(), cent.cpu().numpy(), float(inertia)


def _silhouette_t(x, labels, k: int):
    """Mean silhouette (a 0-d tensor) of ``labels`` (n,) in [0, k) over
    ``x`` (n, d) on one device, clusters of one contributing 0.  The (n, k)
    distance totals come from K3, whose self-distances are exactly 0 (JAX
    takes a dense sqrt of the expanded distance instead, which leaves
    float32 noise there)."""
    onehot = torch.nn.functional.one_hot(labels.long(), k).to(torch.float32)
    sums = silhouette_sums(x, onehot.contiguous())
    cnt = onehot.sum(0)
    own_cnt = onehot @ cnt
    own_sum = torch.sum(sums * onehot, dim=1)
    a = own_sum / torch.clamp_min(own_cnt - 1, 1)
    inf = torch.tensor(float("inf"), device=x.device)
    mean_other = sums / torch.clamp_min(cnt[None, :], 1)
    mean_other = torch.where(onehot > 0, inf, mean_other)
    mean_other = torch.where(cnt[None, :] > 0, mean_other, inf)
    b = torch.min(mean_other, dim=1).values
    s = (b - a) / torch.clamp_min(torch.maximum(a, b), 1e-12)
    s = torch.where(own_cnt > 1, s, torch.zeros_like(s))
    return torch.mean(s)


def silhouette(x: np.ndarray, labels: np.ndarray, device=None) -> float:
    dev = resolve_device(device)
    labels = np.asarray(labels, np.int64)
    return float(_silhouette_t(
        torch.from_numpy(np.asarray(x, np.float32)).to(dev),
        torch.from_numpy(labels).to(dev), int(labels.max()) + 1))


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


def select_k_and_cluster(
    x: np.ndarray,
    k_max: int = 48,
    seed: int = 0,
    sil_floor: float = 0.20,
    tie_tol: float = 0.02,
    tiny_n: int = 4,
    sil_cap: int = 1200,
    iters: int = 50,
    init: str = "host",
    device=None,
):
    """The sequential reference: one K-Means fit and one silhouette per
    candidate K, on ``device`` (the card unless ``"cpu"`` is asked for);
    returns (labels, info).  The silhouette is scored on a deterministic
    subsample when n > sil_cap.  One host sync per candidate (the compact
    relabel, as in JAX); the scores come back in one pull at the end.
    ``init="device"`` draws the seeding once on the device
    (``device_init_indices``' draws) and seeds each candidate K with its
    first K indices."""
    _check_init(init)
    x = np.asarray(x, np.float32)
    n = len(x)
    done, sil_idx = _host_preamble(x, seed, tiny_n, sil_cap)
    if done is not None:
        return done
    dev = resolve_device(device)
    xt = torch.from_numpy(x).to(dev)
    x_sil = xt if sil_idx is None else xt[torch.from_numpy(sil_idx).to(dev)]
    if init == "device":
        dev_init = torch.from_numpy(device_init_indices(
            x, seed, min(k_max, n - 1), device=dev)).to(dev)
    results = {}
    scores = {}
    for k in range(2, min(k_max, n - 1) + 1):
        init_idx = (dev_init[:k] if init == "device" else
                    torch.from_numpy(_kmeanspp_init(x, k, seed)).to(dev))
        lab, _, _ = _kmeans_run(xt, init_idx, k, iters)
        # re-label compactly (empty clusters possible)
        # lint: allow[R1] the sequential per-K reference reads each K's labels
        _, lab = np.unique(lab.cpu().numpy(), return_inverse=True)
        if lab.max() == 0:
            continue
        results[k] = lab
        if sil_idx is not None:
            sl = lab[sil_idx]
            if sl.max() == sl.min():
                continue
            _, sl = np.unique(sl, return_inverse=True)
        else:
            sl = lab
        scores[k] = _silhouette_t(x_sil, torch.from_numpy(sl).to(dev),
                                  int(sl.max()) + 1)
    if not scores:
        return np.zeros(n, int), {"k": 1, "sil": 0.0, "mode": "degenerate"}
    scores = dict(zip(scores, torch.stack(list(scores.values())).tolist()))
    chosen, best = _choose_k(scores, sil_floor, tie_tol)
    if chosen is None:
        return np.zeros(n, int), {"k": 1, "sil": best, "mode": "weak->K=1"}
    return results[chosen], {
        "k": int(results[chosen].max()) + 1, "sil": scores[chosen],
        "mode": "silhouette", "scores": scores,
    }


# ---------------------------------------------------------------------------
# swept engine: every candidate K of a program in one pass
# ---------------------------------------------------------------------------

def _tree_sum(t):
    """Sum over the last axis (a power of two long) by halving it: a fixed
    order that does not depend on the sizes of the other axes, nor on
    trailing zeros, so a program's score has the same bits alone, in any
    chunk, and padded into a larger points bucket."""
    while t.shape[-1] > 1:
        h = t.shape[-1] // 2
        t = t[..., :h] + t[..., h:]
    return t[..., 0]


def _sweep_core(x, pmask, init_idx, sil_mask, *, k_max: int, iters: int,
                n_real):
    """B programs, every candidate K (2..k_max), one dispatch.

    ``x`` (B, n_pad, d), ``pmask``/``sil_mask`` (B, n_pad) and ``init_idx``
    (B, k_max) live on one device; ``n_real`` holds each program's point
    count (0 for a padded row).  The candidates 2..k_top of the chunk's
    largest k_top = min(k_max, n - 1) are fitted for every program, as
    JAX's vmapped sweep fits them all.  Returns (labels (B, num_k, n_pad)
    int32, sil (B, num_k), ok (B, num_k) bool) on that device, num_k =
    k_max - 1; ``ok`` is JAX's rule: K <= min(k_max, n - 1) and at least
    two live clusters."""
    B, n_pad, d = x.shape
    dev = x.device
    num_k = k_max - 1
    k_tops = [min(k_max, n - 1) for n in n_real]
    C = max(max(k_tops) - 1, 0)                         # fitted: 2..C + 1
    rows = torch.arange(B, device=dev)[:, None]
    cent0 = x[rows, init_idx.long()]                    # (B, k_max, d)
    labels_all = torch.zeros(B, num_k, n_pad, dtype=torch.int32, device=dev)
    if C:
        ks = torch.arange(2, C + 2, device=dev)
        cmask = (torch.arange(k_max, device=dev)[None, :]
                 < ks[:, None]).to(torch.float32)       # (C, k_max)
        cent = cent0[:, None].expand(B, C, k_max, d).contiguous()
        ws = (K2Workspace(C, n_pad, k_max, d, dev, B) if dev.type == "cuda"
              else None)
        for _ in range(iters):
            _, _, sums, cnts = kmeans_assign_fused_batched(x, cent, cmask,
                                                           pmask, out=ws)
            cent = torch.where((cnts > 0)[..., None],
                               sums / torch.clamp_min(cnts, 1)[..., None],
                               cent)
        lab, _, _, _ = kmeans_assign_fused_batched(x, cent.contiguous(),
                                                   cmask, pmask, out=ws)
        labels_all[:, :C] = lab
    # candidate-major (num_k, B, n_pad, k_max): K3 takes one candidate of
    # every program a call
    onehot_all = (torch.nn.functional.one_hot(
        labels_all.transpose(0, 1).long(), k_max).to(torch.float32)
        * sil_mask[None, :, :, None])
    onehot_all[C:] = 0.0                                # not fitted
    sums_all = torch.zeros(num_k, B, n_pad, k_max, dtype=torch.float32,
                           device=dev)
    for ki in range(C):
        sums_all[ki] = silhouette_sums(x, onehot_all[ki])

    # vectorized masked silhouette over the programs and candidates (the
    # JAX sweep's arithmetic; empty clusters are excluded via cnt > 0)
    inf = torch.tensor(float("inf"), device=dev)
    cnt = onehot_all.sum(2)                             # (num_k, B, k_max)
    own_cnt = torch.einsum("kbnc,kbc->kbn", onehot_all, cnt)
    own_sum = torch.sum(sums_all * onehot_all, dim=3)
    a = own_sum / torch.clamp_min(own_cnt - 1, 1)
    mean_other = sums_all / torch.clamp_min(cnt[:, :, None, :], 1)
    mean_other = torch.where(onehot_all > 0, inf, mean_other)
    mean_other = torch.where(cnt[:, :, None, :] > 0, mean_other, inf)
    b = torch.min(mean_other, dim=3).values
    s = (b - a) / torch.clamp_min(torch.maximum(a, b), 1e-12)
    s = torch.where(own_cnt > 1, s, torch.zeros_like(s)) * sil_mask[None]
    sil = _tree_sum(s) / torch.clamp_min(torch.sum(sil_mask, dim=1), 1.0)
    n_live = torch.sum(cnt > 0, dim=2)
    k_valid = (torch.arange(2, k_max + 1, device=dev)[:, None]
               <= torch.tensor(k_tops, device=dev)[None, :])
    ok = k_valid & (n_live >= 2)
    return labels_all, sil.T, ok.T


def effective_shards(batch: int, data_shards: int, devices: int) -> int:
    """Program-axis slices of a dispatch (JAX's ``_effective_shards``):
    the largest power of two at most ``min(batch, data_shards, devices)``,
    which divides the power-of-two batch."""
    if data_shards <= 1 or batch <= 1:
        return 1
    s = 1
    while (s << 1) <= min(batch, data_shards, devices):
        s <<= 1
    return s


def _sweep_slice(dev, rows, xb, pmask, silm, init_idx, n_real, todo,
                 seeds, *, k_max, iters, init):
    """The sweep of the programs ``rows`` of a stacked dispatch, on
    ``dev``; the results stay on it."""
    xt, pt, st, it = (torch.from_numpy(a[rows]).to(dev)
                      for a in (xb, pmask, silm, init_idx))
    n_real = n_real[rows]
    if init == "device":
        # each program's draws at its own bucket: the leading rows of its
        # padded row are exactly its ``_pad_bucket`` matrix and mask
        for row in range(len(n_real)):
            n = n_real[row]
            if n:
                i = todo[rows.start + row]
                own, k_up = bucket_points(n), min(k_max, n - 1)
                it[row, :k_up] = _device_init(xt[row, :own], pt[row, :own],
                                              seeds[i], k_up)
    return _sweep_core(xt, pt, it, st, k_max=k_max, iters=iters,
                       n_real=n_real)


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
    data_shards: int = 1,
    devices=None,
):
    """Plan many programs in one sweep dispatch on ``device`` (the card
    unless ``"cpu"`` is asked for), as JAX's default engine does: the
    embeddings are padded to the largest program's power-of-two points
    bucket, stacked on a leading program axis padded to ``bucket_batch``
    (the padded rows all-zero, inert, discarded), and every candidate K of
    every program is evaluated together; labels, scores and flags come
    back to the host once for the dispatch.  Tiny/trivial/featureless
    programs take the host fallback.  Returns a list of (labels, info)
    aligned with ``xs``; ``seed`` is an int or a per-program sequence.
    Seeds (``init``) are drawn at each program's own points bucket, so a
    program's result never depends on the programs beside it.

    ``data_shards > 1`` places the dispatch across devices, as JAX's
    ``_shard_args`` commits the program axis to a 1-D mesh: the stacked
    program axis is cut into ``effective_shards`` equal slices, slice s
    swept on device s of ``devices`` (a device may repeat; default:
    ``launch/mesh.make_data_mesh``'s first cards, the CPU alone on the
    CPU), all slices launched before any result is read.  The labels, K
    and scores are those of the unplaced dispatch."""
    _check_init(init)
    dev = resolve_device(device)
    xs = [np.asarray(x, np.float32) for x in xs]
    seeds = ([int(seed)] * len(xs) if np.isscalar(seed)
             else [int(s) for s in seed])
    out: list = [None] * len(xs)
    todo: list[int] = []
    sil_idxs: dict[int, np.ndarray] = {}
    for i, x in enumerate(xs):
        done, sil_idx = _host_preamble(x, seeds[i], tiny_n, sil_cap)
        if done is not None:
            out[i] = done
        elif x.ndim != 2 or x.shape[1] == 0:
            # featureless embeddings: the degenerate K=1 collapse, decided
            # on the host
            out[i] = (np.zeros(len(x), int),
                      {"k": 1, "sil": 0.0, "mode": "degenerate",
                       "engine": "sweep"})
        else:
            todo.append(i)
            sil_idxs[i] = sil_idx
    if not todo:
        return out

    n_pad = bucket_points(max(len(xs[i]) for i in todo))
    d = xs[todo[0]].shape[1]
    B = bucket_batch(len(todo))
    xb = np.zeros((B, n_pad, d), np.float32)
    pmask = np.zeros((B, n_pad), np.float32)
    silm = np.zeros((B, n_pad), np.float32)
    init_idx = np.zeros((B, k_max), np.int32)
    n_real = [0] * B
    for row, i in enumerate(todo):
        x = xs[i]
        n = n_real[row] = len(x)
        xb[row, :n] = x
        pmask[row, :n] = 1.0
        sil_idx = sil_idxs[i]
        silm[row, np.arange(n) if sil_idx is None else sil_idx] = 1.0
        if init == "host":
            k_up = min(k_max, n - 1)
            init_idx[row, :k_up] = _kmeanspp_init(x, k_up, seeds[i])
    shards = effective_shards(B, data_shards, len(
        visible_devices(dev.type) if devices is None else devices))
    if shards == 1:
        place = [dev]
    elif devices is None:
        place = list(make_data_mesh(shards, device_type=dev.type).devices)
    else:
        place = [resolve_device(d) for d in devices[:shards]]
    per = B // shards
    parts = []
    for s, d in enumerate(place):
        rows = slice(s * per, (s + 1) * per)
        if not any(n_real[rows]):           # padding rows only: inert
            parts.append(None)
            continue
        with torch.cuda.device(d) if d.type == "cuda" else _nullctx():
            parts.append(_sweep_slice(d, rows, xb, pmask, silm, init_idx,
                                      n_real, todo, seeds, k_max=k_max,
                                      iters=iters, init=init))
    num_k = k_max - 1
    labels_all = np.zeros((B, num_k, n_pad), np.int32)
    sil = np.zeros((B, num_k), np.float32)
    ok = np.zeros((B, num_k), bool)
    for s, part in enumerate(parts):
        if part is not None:
            rows = slice(s * per, (s + 1) * per)
            labels_all[rows], sil[rows], ok[rows] = (t.cpu().numpy()
                                                     for t in part)
    ks = list(range(2, k_max + 1))
    for row, i in enumerate(todo):
        out[i] = _finish_one(labels_all[row], sil[row], ok[row], n_real[row],
                             ks, sil_floor, tie_tol)
    return out


def select_k_and_cluster_swept(x: np.ndarray, **kw):
    """Single-program front door for the K sweep."""
    return sweep_cluster_stack([np.asarray(x, np.float32)], **kw)[0]
