"""K2, K3 and K4 wrappers with their plain PyTorch versions.

Counterpart of ``repro/kernels/kmeans_assign/{ops,ref}.py``.

``kmeans_assign``       the sequential reference's unmasked assignment
                        (K4): CUDA tensors launch
                        ``csrc/kmeans_assign_seq.cu``.
``kmeans_assign_fused_batched``
                        one mask-aware Lloyd step's statistics for every
                        program and candidate of a sweep dispatch: CUDA
                        tensors launch ``csrc/kmeans_assign.cu``;
                        ``kmeans_assign_fused`` is its one-program,
                        one-candidate form.
``silhouette_sums``     per-(point, cluster) distance totals for every
                        program of a dispatch: CUDA tensors launch
                        ``csrc/silhouette_sums.cu``.

CPU tensors take the ``*_plain`` version (the JAX ``ref.py`` formulas).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import check, launch, route

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


def kmeans_assign_fused_batched_plain(x, cent, cmask, pmask):
    """``kmeans_assign_fused_plain`` of each program b and candidate c
    (x[b], cent[b, c], cmask[c], pmask[b]), stacked: for x (B,n,d), cent
    (B,C,k,d), cmask (C,k), pmask (B,n): (labels (B,C,n) int32, mind
    (B,C,n), sums (B,C,k,d), counts (B,C,k)); for one program, x (n,d),
    cent (C,k,d), pmask (n,): the same without the program axis."""
    if x.dim() == 3:
        outs = [kmeans_assign_fused_batched_plain(x[b], cent[b], cmask,
                                                  pmask[b])
                for b in range(x.shape[0])]
        return tuple(torch.stack(o) for o in zip(*outs))
    outs = [kmeans_assign_fused_plain(x, cent[c], cmask[c], pmask)
            for c in range(cent.shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


#: csrc/kmeans_assign.cu: points of a statistics segment, columns of a
#: tile, and the kernel's limits on k, d, C and the programs B
_K2_SEG, _K2_TC = 256, 64
_K2_MAX_K, _K2_MAX_D, _K2_MAX_C, _K2_MAX_B = 64, 512, 1024, 1024


class K2Workspace:
    """Outputs and scratch of ``kmeans_assign_fused_batched`` for one shape
    (C candidates, n points, k slots, d features, B programs) on one card,
    made once per sweep so that its Lloyd steps allocate nothing.  Each
    call overwrites ``labels`` (B, C, n), ``mind``, ``sums`` and ``cnts``.
    It also keeps the kernel's column plan, built from the cmask it was
    called with; a later call with the same cmask tensor, unmodified,
    reuses it."""

    def __init__(self, C: int, n: int, k: int, d: int, device, B: int = 1):
        dev = torch.device(device)
        nseg = -(-n // _K2_SEG)
        self.shape = (B, C, n, k, d)
        self.labels = torch.empty(B, C, n, dtype=torch.int32, device=dev)
        self.mind = torch.empty(B, C, n, dtype=torch.float32, device=dev)
        self.sums = torch.empty(B, C, k, d, dtype=torch.float32, device=dev)
        self.cnts = torch.empty(B, C, k, dtype=torch.float32, device=dev)
        # the plan (csrc plan_ints) and the touched flags per (program,
        # candidate, slot, segment); the norms, partial counts and sums
        self.iscratch = torch.empty(1 + 4 * C + 2 * C * _K2_TC
                                    + B * nseg * C * k, dtype=torch.int32,
                                    device=dev)
        self.fscratch = torch.empty(B * (n + C * k + nseg * C * k * (d + 1)),
                                    dtype=torch.float32, device=dev)
        self._plan_of = None          # (cmask, its version) of the plan

    def has_plan(self, cmask) -> bool:
        return (self._plan_of is not None and self._plan_of[0] is cmask
                and self._plan_of[1] == cmask._version)


def kmeans_assign_fused_batched(x, cent, cmask, pmask, out=None):
    """One masked Lloyd step's statistics for every program and candidate
    of a sweep dispatch in one K2 call (four launches).  x (B,n,d), cent
    (B,C,k,d), cmask (C,k) shared by the programs, pmask (B,n), all
    float32 -> (labels (B,C,n) int32, masked min_sq_dist (B,C,n), sums
    (B,C,k,d), counts (B,C,k)); the one-program form takes x (n,d), cent
    (C,k,d), pmask (n,) and returns the same without the program axis (a
    view of the call with B = 1).  On the card the results are the
    tensors of ``out`` (a ``K2Workspace`` of this shape; a new one when
    None), which the next call with it overwrites.  CPU tensors take the
    plain version and ignore ``out``."""
    if route(x) == "cpu":
        return kmeans_assign_fused_batched_plain(x, cent, cmask, pmask)
    dev = x.device
    one = x.dim() == 2
    if one:
        if cent.dim() != 3 or pmask.dim() != 1:
            raise ValueError("kmeans_assign_fused_batched: one program "
                             "takes x (n,d), cent (C,k,d) and pmask (n,)")
        x, cent, pmask = x[None], cent[None], pmask[None]
    if x.dim() != 3 or cent.dim() != 4:
        raise ValueError("kmeans_assign_fused_batched: x must be 3-D and "
                         "cent 4-D (or 2-D and 3-D for one program)")
    B, n, d = x.shape
    C, k = cent.shape[1:3]
    check("x", x, dtype=torch.float32, shape=(B, n, d), device=dev)
    check("cent", cent, dtype=torch.float32, shape=(B, C, k, d), device=dev)
    check("cmask", cmask, dtype=torch.float32, shape=(C, k), device=dev)
    check("pmask", pmask, dtype=torch.float32, shape=(B, n), device=dev)
    if not (1 <= C <= _K2_MAX_C and 1 <= k <= _K2_MAX_K
            and 1 <= d <= _K2_MAX_D and 1 <= B <= _K2_MAX_B
            and B * n < 2 ** 31):
        raise ValueError(f"kmeans_assign kernel takes 1 <= C <= "
                         f"{_K2_MAX_C}, 1 <= k <= {_K2_MAX_K}, 1 <= d <= "
                         f"{_K2_MAX_D}, 1 <= B <= {_K2_MAX_B} and B n < "
                         f"2^31; got C={C}, k={k}, d={d}, B={B}, n={n}")
    ws = K2Workspace(C, n, k, d, dev, B) if out is None else out
    if ws.shape != (B, C, n, k, d) or ws.labels.device != dev:
        raise ValueError(f"kmeans_assign_fused_batched: workspace of shape "
                         f"{ws.shape} on {ws.labels.device}, expected "
                         f"{(B, C, n, k, d)} on {dev}")
    replan = not ws.has_plan(cmask)
    launch("kmeans_assign_fused_batched",
           *(t.data_ptr() for t in (x, cent, cmask, pmask, ws.labels,
                                    ws.mind, ws.sums, ws.cnts, ws.iscratch,
                                    ws.fscratch)),
           n, d, k, C, B, int(replan))
    ws._plan_of = (cmask, cmask._version)
    kmeans_assign_fused_batched.launches += 1
    res = (ws.labels, ws.mind, ws.sums, ws.cnts)
    return tuple(t[0] for t in res) if one else res


#: calls that launched the K2 kernels (CUDA tensors only), single-candidate
#: calls through ``kmeans_assign_fused`` included; one call covers every
#: program and candidate given to it
kmeans_assign_fused_batched.launches = 0


def kmeans_assign_fused(x, cent, cmask, pmask):
    """x (n,d), cent (k,d), cmask (k,), pmask (n,), all float32 ->
    (labels (n,) int32, masked min_sq_dist (n,), sums (k,d), counts (k,)):
    the batched kernel with one program and one candidate."""
    if route(x) == "cpu":
        return kmeans_assign_fused_plain(x, cent, cmask, pmask)
    if x.dim() != 2 or cent.dim() != 2 or cmask.dim() != 1:
        raise ValueError("kmeans_assign_fused: x and cent must be 2-D, "
                         "cmask 1-D")
    out = kmeans_assign_fused_batched(x, cent[None], cmask[None], pmask)
    kmeans_assign_fused.launches += 1
    return tuple(t[0] for t in out)


#: single-candidate calls that launched K2 (CUDA tensors only)
kmeans_assign_fused.launches = 0


def silhouette_sums_plain(x, onehot):
    """Per-(point, cluster) total euclidean distance via the full (n, n)
    matrix (the plain version materialises what the kernel never does),
    for x (n,d) / onehot (n,k), or per program for x (B,n,d) / onehot
    (B,n,k).  The squared norms are the Gram matrix's diagonal, so a
    point's distance to itself cancels to exactly 0 instead of leaving
    the float32 residual of two differently ordered sums under the sqrt."""
    if x.dim() == 3:
        return torch.stack([silhouette_sums_plain(x[b], onehot[b])
                            for b in range(x.shape[0])])
    g = x @ x.T
    x2 = torch.diagonal(g)
    d2 = torch.clamp_min(x2[:, None] - 2.0 * g + x2[None, :], 0.0)
    return torch.sqrt(d2) @ onehot


def silhouette_sums(x, onehot):
    """x (B,n,d), point-masked onehot (B,n,k), float32 -> sums (B,n,k):
    one K3 call (three launches) for every program of a sweep dispatch;
    x (n,d) / onehot (n,k) is the one-program form (B = 1, no program
    axis in the result)."""
    if route(x) == "cpu":
        return silhouette_sums_plain(x, onehot)
    dev = x.device
    one = x.dim() == 2
    if one:
        x, onehot = x[None], onehot[None]
    if x.dim() != 3 or onehot.dim() != 3:
        raise ValueError("silhouette_sums: x and onehot must be 3-D (or "
                         "2-D for one program)")
    B, n, d = x.shape
    k = onehot.shape[2]
    check("x", x, dtype=torch.float32, shape=(B, n, d), device=dev)
    check("onehot", onehot, dtype=torch.float32, shape=(B, n, k),
          device=dev)
    if k > 64 or not 1 <= B <= 65535:
        raise ValueError(f"silhouette_sums kernel takes k <= 64 and "
                         f"1 <= B <= 65535; got k={k}, B={B}")
    if d % 4 or x.data_ptr() % 16:
        # 16-byte rows for the kernel's vector loads; zero columns add
        # fmaf(0, 0, s) = s, so every sum is unchanged
        xp = x.new_zeros(B, n, d + (-d) % 4)
        xp[..., :d] = x
        x = xp
    nb = (n + 31) // 32
    iscratch = torch.empty(B * (3 * n + 2 * nb + n * k + 2),
                           dtype=torch.int32, device=dev)
    fscratch = torch.empty(B * (2 * n + n * k), dtype=torch.float32,
                           device=dev)
    out = torch.empty(B, n, k, dtype=torch.float32, device=dev)
    launch("silhouette_sums",
           *(t.data_ptr() for t in (x, onehot, iscratch, fscratch, out)),
           n, x.shape[2], k, B)
    silhouette_sums.launches += 1
    return out[0] if one else out


#: kernel launches made through this wrapper (CUDA tensors only); one call
#: covers every program given to it
silhouette_sums.launches = 0
