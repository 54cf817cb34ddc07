"""K2, K3 and K4 wrappers with their plain PyTorch versions.

Counterpart of ``repro/kernels/kmeans_assign/{ops,ref}.py``.

``kmeans_assign``       the sequential reference's unmasked assignment
                        (K4): CUDA tensors launch
                        ``csrc/kmeans_assign_seq.cu``.
``kmeans_assign_fused`` one mask-aware Lloyd step's statistics: CUDA
                        tensors launch ``csrc/kmeans_assign.cu``.
``silhouette_sums``     per-(point, cluster) distance totals: CUDA tensors
                        launch ``csrc/silhouette_sums.cu``.

CPU tensors take the ``*_plain`` version (the JAX ``ref.py`` formulas).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import check, launch, route

#: points per block of the K2 kernel (its partial-sum scratch is per block)
_K2_POINTS = 32


def kmeans_assign_plain(x, cent):
    """(labels (n,) int32, min squared distance (n,)): the expanded
    distance clamped at 0, first index on ties (``ref.py:kmeans_assign_ref``)."""
    x2 = torch.sum(x * x, dim=1, keepdim=True)
    c2 = torch.sum(cent * cent, dim=1)
    d = torch.clamp_min(x2 - 2.0 * x @ cent.T + c2[None], 0.0)
    mind, lab = torch.min(d, dim=1)
    return lab.to(torch.int32), mind


def kmeans_assign(x, cent):
    """x (n,d), cent (k,d), float32 -> (labels (n,) int32, min_sq (n,))."""
    if route(x) == "cpu":
        return kmeans_assign_plain(x, cent)
    dev = x.device
    if x.dim() != 2 or cent.dim() != 2:
        raise ValueError("kmeans_assign: x and cent must be 2-D")
    n, d = x.shape
    k = cent.shape[0]
    check("x", x, dtype=torch.float32, shape=(n, d), device=dev)
    check("cent", cent, dtype=torch.float32, shape=(k, d), device=dev)
    if k < 1 or d < 1:
        raise ValueError(f"kmeans_assign kernel takes k >= 1, d >= 1; got "
                         f"k={k}, d={d}")
    labels = torch.empty(n, dtype=torch.int32, device=dev)
    mind = torch.empty(n, dtype=torch.float32, device=dev)
    launch("kmeans_assign",
           *(t.data_ptr() for t in (x, cent, labels, mind)), n, d, k)
    kmeans_assign.launches += 1
    return labels, mind


#: kernel launches made through this wrapper (CUDA tensors only)
kmeans_assign.launches = 0


def kmeans_assign_fused_plain(x, cent, cmask, pmask):
    """(labels (n,) int32, masked min sq dist (n,), cluster sums (k,d),
    counts (k,)); dead slots (cmask 0) never win, padding (pmask 0)
    contributes nothing."""
    x2 = torch.sum(x * x, dim=1, keepdim=True)
    c2 = torch.sum(cent * cent, dim=1)
    d = torch.clamp_min(x2 - 2.0 * (x @ cent.T) + c2[None], 0.0)
    d = torch.where(cmask[None, :] > 0, d, torch.full_like(d, float("inf")))
    mind, lab = torch.min(d, dim=1)
    k = cent.shape[0]
    onehot = (lab[:, None] == torch.arange(k, device=x.device)[None, :])
    onehot = onehot.to(torch.float32) * pmask[:, None]
    return lab.to(torch.int32), mind * pmask, onehot.T @ x, onehot.sum(0)


def kmeans_assign_fused(x, cent, cmask, pmask):
    """x (n,d), cent (k,d), cmask (k,), pmask (n,), all float32 ->
    (labels (n,) int32, masked min_sq_dist (n,), sums (k,d), counts (k,))."""
    if route(x) == "cpu":
        return kmeans_assign_fused_plain(x, cent, cmask, pmask)
    dev = x.device
    if x.dim() != 2 or cent.dim() != 2:
        raise ValueError("kmeans_assign_fused: x and cent must be 2-D")
    n, d = x.shape
    k = cent.shape[0]
    check("x", x, dtype=torch.float32, shape=(n, d), device=dev)
    check("cent", cent, dtype=torch.float32, shape=(k, d), device=dev)
    check("cmask", cmask, dtype=torch.float32, shape=(k,), device=dev)
    check("pmask", pmask, dtype=torch.float32, shape=(n,), device=dev)
    if k > 64 or d > 512:
        raise ValueError(f"kmeans_assign kernel takes k <= 64, d <= 512; "
                         f"got k={k}, d={d}")
    nblk = (n + _K2_POINTS - 1) // _K2_POINTS
    labels = torch.empty(n, dtype=torch.int32, device=dev)
    mind = torch.empty(n, dtype=torch.float32, device=dev)
    psums = torch.empty(max(nblk, 1), k, d, dtype=torch.float32, device=dev)
    pcnts = torch.empty(max(nblk, 1), k, dtype=torch.float32, device=dev)
    sums = torch.empty(k, d, dtype=torch.float32, device=dev)
    cnts = torch.empty(k, dtype=torch.float32, device=dev)
    launch("kmeans_assign_fused",
           *(t.data_ptr() for t in (x, cent, cmask, pmask, labels, mind,
                                    psums, pcnts, sums, cnts)),
           n, d, k)
    kmeans_assign_fused.launches += 1
    return labels, mind, sums, cnts


#: kernel launches made through this wrapper (CUDA tensors only)
kmeans_assign_fused.launches = 0


def silhouette_sums_plain(x, onehot):
    """Per-(point, cluster) total euclidean distance via the full (n, n)
    matrix (the plain version materialises what the kernel never does).
    The squared norms are the Gram matrix's diagonal, so a point's distance
    to itself cancels to exactly 0 instead of leaving the float32 residual
    of two differently ordered sums under the sqrt."""
    g = x @ x.T
    x2 = torch.diagonal(g)
    d2 = torch.clamp_min(x2[:, None] - 2.0 * g + x2[None, :], 0.0)
    return torch.sqrt(d2) @ onehot


def silhouette_sums(x, onehot):
    """x (n,d), point-masked onehot (n,k), float32 -> sums (n,k)."""
    if route(x) == "cpu":
        return silhouette_sums_plain(x, onehot)
    dev = x.device
    if x.dim() != 2 or onehot.dim() != 2:
        raise ValueError("silhouette_sums: x and onehot must be 2-D")
    n, d = x.shape
    k = onehot.shape[1]
    check("x", x, dtype=torch.float32, shape=(n, d), device=dev)
    check("onehot", onehot, dtype=torch.float32, shape=(n, k), device=dev)
    if k > 64:
        raise ValueError(f"silhouette_sums kernel takes k <= 64; got {k}")
    if d % 4 or x.data_ptr() % 16:
        # 16-byte rows for the kernel's vector loads; zero columns add
        # fmaf(0, 0, s) = s, so every sum is unchanged
        xp = x.new_zeros(n, d + (-d) % 4)
        xp[:, :d] = x
        x = xp
    nb = (n + 31) // 32
    iscratch = torch.empty(3 * n + 2 * nb + n * k + 2, dtype=torch.int32,
                           device=dev)
    fscratch = torch.empty(2 * n + n * k, dtype=torch.float32, device=dev)
    out = torch.empty(n, k, dtype=torch.float32, device=dev)
    launch("silhouette_sums",
           *(t.data_ptr() for t in (x, onehot, iscratch, fscratch, out)),
           n, x.shape[1], k)
    silhouette_sums.launches += 1
    return out


#: kernel launches made through this wrapper (CUDA tensors only)
silhouette_sums.launches = 0
