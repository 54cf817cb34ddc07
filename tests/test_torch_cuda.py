"""The port's CUDA kernels on the card (``cuda`` marker).

Each hand-written kernel against its plain PyTorch version on the same
CUDA tensors, at sizes that are not multiples of the kernels' tiles; the
wrappers' input checks; one program served end to end on the card against
the same program served on the CPU; one training step on the card against
the same step on the CPU, with the same draws; the sequential reference
(K4 + K3) on the card against the CPU.  This file imports no JAX (the
machine with the card has none).  Without a card every test skips with a
reason, decided inside the test.

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance: 1e-5 of the largest magnitude (the kernel and the plain version
sum in different orders); labels exactly, on separated data.  A training
step: the loss 1e-5, every parameter 1e-4 (the backward sums in other
orders, and Adam divides by sqrt(v), which magnifies that noise where a
gradient is small).
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels.kmeans_assign.ops import (
    K2Workspace, kmeans_assign, kmeans_assign_fused,
    kmeans_assign_fused_batched, kmeans_assign_fused_batched_plain,
    kmeans_assign_fused_plain, kmeans_assign_plain, silhouette_sums,
    silhouette_sums_plain,
)
from repro_torch.kernels.rgcn_fused.ops import (
    rgcn_fused_agg_flat, rgcn_fused_agg_flat_plain, rgcn_fused_bwd,
    rgcn_fused_bwd_plain,
)
from repro_torch.kernels.rgcn_spmm.ops import (
    rgcn_message_agg, rgcn_message_agg_flat, rgcn_spmm_dense,
    rgcn_spmm_dense_plain, rgcn_spmm_flat, rgcn_spmm_flat_plain,
)

TOL = 1e-5


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, want):
    """Within TOL of the largest |want|; for a bfloat16 result, within one
    bfloat16 rounding (2^-7 relative) of float32 sums taken in another
    order."""
    tol = 2 ** -7 if got.dtype == torch.bfloat16 else TOL
    got, want = got.float().cpu(), want.float().cpu()
    scale = float(want.abs().max()) if want.numel() else 0.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    assert err <= tol * max(scale, 1e-30), (err, scale)


def _offset(t, offset):
    """``t``'s values in a contiguous view that starts ``offset`` elements
    into its storage (so its address is no multiple of 16 bytes)."""
    if not offset:
        return t
    flat = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = flat[offset:].view(t.shape)
    view.copy_(t)
    return view


@functools.lru_cache(maxsize=None)
def _phi2_batches():
    """phi-2's main-path batches: the first micro-batch the packed embed
    packs (its padded tail, src = dst = 0, on node 0) and the first batch
    of 64 graphs ``embed_dense`` pads."""
    from repro_torch.core.batching import (
        bucket_size, graph_content_hash, pack_graphs, plan_microbatches,
    )
    from repro_torch.core.graphs import pad_batch
    from repro_torch.core.sampler import GCLSampler
    from repro_torch.tracing.programs import get_program

    graphs = list(GCLSampler(device="cpu").iter_graphs(get_program("phi-2")))
    seen = {}
    for g in graphs:
        seen.setdefault(graph_content_hash(g), g)
    distinct = list(seen.values())
    first = [distinct[i] for i in plan_microbatches(distinct)[0]]
    packed, _ = pack_graphs(first, pad_graphs_to=bucket_size(len(first), 8))
    full, _ = pad_batch(graphs)
    return packed, {k: v[:64] for k, v in full.items()}


def _k1_args(dev, P, D, Q, O, dtype, seed=0, offset=0, pile=0):
    """Random K1 / K1b inputs; ``pile="phi-2"`` takes P, Q and the edges
    of phi-2's first packed embed batch in its own order."""
    rng = np.random.default_rng(seed)
    if pile == "phi-2":
        packed = _phi2_batches()[0]
        src, dst = packed["edge_src"], packed["edge_dst"]
        wnorm = (packed["edge_mask"] * packed["edge_norm"]).astype(np.float32)
        P, Q = len(packed["node_mask"]), len(src)
        perm = np.arange(Q)
    else:
        src = rng.integers(0, P, Q).astype(np.int32)
        dst = rng.integers(0, P, Q).astype(np.int32)
        wnorm = rng.random(Q).astype(np.float32)
        dst[Q // 2:], wnorm[Q // 2:] = 0, 0.0     # padded tail ...
        if pile:                                  # ... a row 3 -> 3 of
            src = np.concatenate([src, np.full(pile, 3, np.int32)])  # degree
            dst = np.concatenate([dst, np.full(pile, 3, np.int32)])  # >= pile
            wnorm = np.concatenate([wnorm,
                                    rng.random(pile).astype(np.float32) + 0.5])
            Q += pile
        perm = rng.permutation(Q)                 # ... in no order
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    h = _offset(t(rng.standard_normal((P, D)).astype(np.float32)).to(dtype),
                offset)
    basis = _offset(t((rng.standard_normal((2, D, O))
                       / np.sqrt(D)).astype(np.float32)), offset)
    coef = t(rng.standard_normal((Q, 2)).astype(np.float32)[perm])
    return (h, basis, t(src[perm]), t(dst[perm]), coef, t(wnorm[perm]), P)


def _blobs(dev, n, d, k, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)).astype(np.float32) * 5
    lab = rng.integers(0, k, n)
    x = centers[lab] + rng.standard_normal((n, d)).astype(np.float32)
    cent = centers + 0.1 * rng.standard_normal((k, d)).astype(np.float32)
    return (torch.from_numpy(x.astype(np.float32)).to(dev),
            torch.from_numpy(cent.astype(np.float32)).to(dev), lab)


_K1_SHAPES = [(64, 128, 0), (128, 256, 0), (40, 24, 0), (128, 200, 0),
              (256, 200, 0), (37, 23, 1), (64, 128, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "D,O,offset", _K1_SHAPES,
    ids=[f"{D}-{O}" + (f"-offset{o}" if o else "") for D, O, o in _K1_SHAPES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rgcn_fused_kernel_matches_plain(D, O, offset, dtype):
    """K1 at the main path's widths and ragged ones; with ``offset``, h and
    the basis start off a 16-byte boundary, so the gather and the basis
    staging take their scalar paths (and at D = 37, O = 23 the partial
    feature blocks and the odd-width stores)."""
    dev = _card()
    args = _k1_args(dev, 700, D, 1500, O, getattr(torch, dtype),
                    offset=offset)
    before = rgcn_fused_agg_flat.launches
    got = rgcn_fused_agg_flat(*args)
    torch.cuda.synchronize()
    assert rgcn_fused_agg_flat.launches == before + 1
    _close(got, rgcn_fused_agg_flat_plain(*args))
    again = rgcn_fused_agg_flat(*args)
    assert torch.equal(got, again)                # deterministic


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rgcn_fused_kernel_gathers_the_last_row_of_h_at_a_segment_end(dtype):
    """h (D = 64, half of a 128-feature block) fills a device allocation of
    its own, so its last row ends where the allocation ends, and edges
    gather that row: the kernel must read no byte past h (a lane whose
    features start at D loads nothing) and still match plain."""
    dev = _card()
    P, D, O, Q = 81920, 64, 128, 1500        # h: 20 or 10 MiB, 2 MiB-aligned
    _, basis, src, dst, coef, wnorm, _ = _k1_args(dev, P, D, Q, O,
                                                  torch.float32)
    src[::3] = P - 1
    gen = torch.Generator(device=dev).manual_seed(5)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()                 # no cached block to split
    h = torch.empty(P, D, dtype=getattr(torch, dtype), device=dev)
    h.copy_(torch.randn(P, D, generator=gen, device=dev))
    args = (h, basis, src, dst, coef, wnorm, P)
    got = rgcn_fused_agg_flat(*args)
    torch.cuda.synchronize()
    _close(got, rgcn_fused_agg_flat_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rgcn_fused_kernel_dead_tiles_write_exact_zeros(dtype):
    """No live in-edge into whole 64-node tiles (and into 16-node strips of
    live tiles): those output rows are exactly 0, the rest match plain."""
    dev = _card()
    h, basis, src, dst, coef, wnorm, P = _k1_args(dev, 700, 128, 1500, 200,
                                                  getattr(torch, dtype))
    v = torch.arange(P, device=dev)
    dead = ((v >= 64) & (v < 192)) | ((v >= 272) & (v < 288)) | (v >= 640)
    live_dst = torch.nonzero(~dead).flatten().to(torch.int32)
    dst = live_dst[dst.long() % live_dst.numel()].contiguous()
    args = (h, basis, src, dst, coef, wnorm, P)
    got = rgcn_fused_agg_flat(*args)
    torch.cuda.synchronize()
    assert not bool(got[dead].any())
    _close(got, rgcn_fused_agg_flat_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k", [(1000, 256, 48), (37, 19, 5), (1, 8, 3)])
def test_kmeans_assign_kernel_matches_plain(n, d, k):
    dev = _card()
    x, cent, _ = _blobs(dev, n, d, k)
    cmask = (torch.arange(k, device=dev) < max(k - 2, 1)).float()
    pmask = (torch.arange(n, device=dev) < max(n - 7, 1)).float()
    got = kmeans_assign_fused(x, cent, cmask, pmask)
    torch.cuda.synchronize()
    want = kmeans_assign_fused_plain(x, cent, cmask, pmask)
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        _close(g, w)


def _k2_batched_inputs(dev, n_pad, d, C, kind, seed=0):
    """The sweep's shapes: k = 48 slots, n_pad points of which the first
    ~60 % are real, centroids near blob centres (each candidate its own
    perturbation); ``kind`` "prefix" gives candidate c the live slots
    0..c+1 (the sweep's K = c + 2), "scattered" a random half of them with
    at least one live."""
    k = 48
    rng = np.random.default_rng(seed + n_pad + d + C)
    centers = rng.standard_normal((k, d)).astype(np.float32) * 5
    x = centers[rng.integers(0, k, n_pad)] + rng.standard_normal(
        (n_pad, d)).astype(np.float32)
    cent = centers[None] + 0.1 * rng.standard_normal((C, k, d)).astype(
        np.float32)
    if kind == "prefix":
        cmask = np.arange(k)[None] < np.minimum(np.arange(C) + 2, k)[:, None]
    else:
        cmask = rng.random((C, k)) < 0.5
        cmask[np.arange(C), rng.integers(0, k, C)] = True
    n_real = max(1, (n_pad * 3) // 5)
    pmask = (np.arange(n_pad) < n_real).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    return (t(x.astype(np.float32)), t(cent.astype(np.float32)),
            t(cmask.astype(np.float32)), t(pmask))


def _check_k2_batched(got, x, cent, cmask, pmask):
    """K2 over candidates against the plain version: labels equal wherever
    the two nearest live centroids are further apart than 1e-6 of the
    distance scale (elsewhere float32 summation order may decide), the
    masked min distance within TOL of that scale, and sums / counts within
    TOL of the plain sums of the kernel's own labels."""
    want = kmeans_assign_fused_batched_plain(x, cent, cmask, pmask)
    x2 = (x * x).sum(1)
    for c in range(cent.shape[0]):
        d2 = torch.clamp_min(x2[:, None] - 2 * x @ cent[c].T
                             + (cent[c] * cent[c]).sum(1)[None], 0)
        d2 = torch.where(cmask[c][None] > 0, d2, float("inf"))
        scale = float(x2.max() + (cent[c] * cent[c]).sum(1).max())
        if int((cmask[c] > 0).sum()) > 1:
            top2 = torch.topk(d2, 2, dim=1, largest=False).values
            clear = top2[:, 1] - top2[:, 0] > 1e-6 * scale
        else:
            clear = torch.ones_like(x2, dtype=torch.bool)
        assert torch.equal(got[0][c][clear], want[0][c][clear])
        assert float((got[1][c] - want[1][c]).abs().max()) <= TOL * scale
        onehot = (torch.nn.functional.one_hot(got[0][c].long(),
                                              cent.shape[1]).float()
                  * pmask[:, None])
        _close(got[2][c], onehot.T @ x)
        _close(got[3][c], onehot.sum(0))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 5, 47])
@pytest.mark.parametrize("n_pad", [32, 256, 4096])
@pytest.mark.parametrize("d", [12, 256])
@pytest.mark.parametrize("kind", ["prefix", "scattered"])
def test_kmeans_assign_batched_kernel_matches_plain(C, n_pad, d, kind):
    """The batched K2 at the sweep's shapes against its plain version, one
    launch counted per call."""
    dev = _card()
    args = _k2_batched_inputs(dev, n_pad, d, C, kind)
    before = kmeans_assign_fused_batched.launches
    got = kmeans_assign_fused_batched(*args)
    torch.cuda.synchronize()
    assert kmeans_assign_fused_batched.launches == before + 1
    assert got[0].shape == (C, n_pad) and got[2].shape == (C, 48, d)
    _check_k2_batched(got, *args)


@pytest.mark.cuda
def test_kmeans_assign_batched_single_equals_fused_and_repeats():
    """One candidate through the batched wrapper gives the bits of
    ``kmeans_assign_fused``; a workspace reused over calls (the plan kept,
    then rebuilt for a new cmask) gives the bits of fresh calls, and two
    runs are bit-equal."""
    dev = _card()
    x, cent, cmask, pmask = _k2_batched_inputs(dev, 256, 256, 5, "scattered")
    one = kmeans_assign_fused(x, cent[0], cmask[0], pmask)
    many = kmeans_assign_fused_batched(x, cent[:1].contiguous(), cmask[:1],
                                       pmask)
    for a, b in zip(one, many):
        assert torch.equal(a, b[0])
    fresh = [t.clone() for t in kmeans_assign_fused_batched(x, cent, cmask,
                                                           pmask)]
    ws = K2Workspace(5, 256, 48, 256, dev)
    for _ in range(2):
        got = kmeans_assign_fused_batched(x, cent, cmask, pmask, out=ws)
        assert all(torch.equal(a, b) for a, b in zip(got, fresh))
    other = cmask.flip(0).contiguous()            # a new cmask: replanned
    got = [t.clone() for t in kmeans_assign_fused_batched(x, cent, other,
                                                         pmask, out=ws)]
    want = kmeans_assign_fused_batched(x, cent, other, pmask)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    other[0] = 1.0                                # changed in place
    got = [t.clone() for t in kmeans_assign_fused_batched(x, cent, other,
                                                         pmask, out=ws)]
    want = kmeans_assign_fused_batched(x, cent, other, pmask)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_kmeans_assign_batched_dead_slots_and_duplicates():
    """Dead slots of a candidate with live ones get exactly 0 sums and
    counts (a candidate with none live: label 0 and +inf everywhere, as in
    the plain version); among identical centroids, points equal to them go
    to the lowest live index at distance exactly 0."""
    dev = _card()
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((5, 256)).astype(np.float32)
    x_np = rows[rng.integers(0, 5, 300)]
    cent_np = np.stack([x_np[rng.integers(0, 300, 48)] for _ in range(4)])
    cent_np[:, 7] = cent_np[:, 3]                 # duplicated slots
    cmask_np = np.ones((4, 48), np.float32)
    cmask_np[1, ::2] = 0.0
    cmask_np[2] = 0.0
    cmask_np[3, 3] = 0.0                          # the first copy dead
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    x, cent, cmask = t(x_np), t(cent_np), t(cmask_np)
    pmask = torch.ones(300, device=dev)
    lab, mind, sums, cnts = kmeans_assign_fused_batched(x, cent, cmask,
                                                        pmask)
    torch.cuda.synchronize()
    dead = (cmask == 0) & (cmask.sum(1, keepdim=True) > 0)
    assert torch.equal(cnts[dead], torch.zeros_like(cnts[dead]))
    assert torch.equal(sums[dead], torch.zeros_like(sums[dead]))
    # no live slot: every point takes slot 0 at +inf, as the reference's
    # argmin over all-inf rows does, and slot 0 collects them
    assert torch.equal(lab[2], torch.zeros_like(lab[2]))
    assert bool(torch.isinf(mind[2]).all())
    assert float(cnts[2, 0]) == 300.0 and float(cnts[2, 1:].abs().sum()) == 0
    _close(sums[2, 0], x.sum(0))
    for c in (0, 1, 3):
        live = torch.nonzero(cmask[c] > 0).flatten().cpu().numpy()
        first = {}
        for i in live:
            first.setdefault(bytes(cent_np[c, i]), int(i))
        for p in range(300):                      # every point is a centroid
            key = bytes(x_np[p])
            if key in first:
                assert int(lab[c, p]) == first[key]
                assert float(mind[c, p]) == 0.0
    again = kmeans_assign_fused_batched(x, cent, cmask, pmask)
    for a, b in zip((lab, mind, sums, cnts), again):
        assert torch.equal(a, b)


def _k2_program_inputs(dev, B, n_pad, d, C, seed=0):
    """B programs of the sweep's prefix candidates (k = 48): program b has
    its own points (its own live count, the rest padding with pmask 0)
    and centroids; the candidate masks are shared, as the sweep shares
    them."""
    per = [_k2_batched_inputs(dev, n_pad, d, C, "prefix", seed=seed + b)
           for b in range(B)]
    x = torch.stack([a[0] for a in per])
    cent = torch.stack([a[1] for a in per])
    pmask = torch.stack([(torch.arange(n_pad, device=dev)
                          < max(1, n_pad - 3 * b)).float()
                         for b in range(B)])
    return x, cent, per[0][2], pmask


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("n_pad,d,C", [(64, 256, 47), (256, 12, 5),
                                       (4096, 256, 47)])
def test_kmeans_assign_program_axis_matches_plain(B, n_pad, d, C):
    """K2 over B programs in one call (one launch counted) against the
    plain version of each program, and each program's slice bit-equal to
    its own one-program call (B = 1: the one-program call's bits)."""
    dev = _card()
    x, cent, cmask, pmask = _k2_program_inputs(dev, B, n_pad, d, C)
    before = kmeans_assign_fused_batched.launches
    got = [t.clone() for t in kmeans_assign_fused_batched(x, cent, cmask,
                                                          pmask)]
    torch.cuda.synchronize()
    assert kmeans_assign_fused_batched.launches == before + 1
    assert got[0].shape == (B, C, n_pad) and got[2].shape == (B, C, 48, d)
    for b in range(B):
        _check_k2_batched([g[b] for g in got], x[b], cent[b], cmask,
                          pmask[b])
        one = kmeans_assign_fused_batched(x[b], cent[b], cmask, pmask[b])
        for g, o in zip(got, one):
            assert torch.equal(g[b], o)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("n,d,k,live", [(4096, 256, 48, 1200),
                                        (64, 256, 48, 40), (301, 12, 5, 29)])
def test_silhouette_sums_program_axis_matches_plain(B, n, d, k, live):
    """K3 over B programs in one call against the plain version of each
    program, and each program's slice bit-equal to its own one-program
    call (B = 1: the one-program call's bits)."""
    dev = _card()
    per = [_sil_inputs(dev, n, d, k, max(0, live - 5 * b), seed=b)
           for b in range(B)]
    x = torch.stack([a[0] for a in per])
    onehot = torch.stack([a[1] for a in per])
    before = silhouette_sums.launches
    got = silhouette_sums(x, onehot)
    torch.cuda.synchronize()
    assert silhouette_sums.launches == before + 1 and got.shape == (B, n, k)
    for b in range(B):
        _close(got[b], silhouette_sums_plain(x[b], onehot[b]))
        assert torch.equal(got[b], silhouette_sums(x[b], onehot[b]))


@pytest.mark.cuda
def test_sweep_chunk_bit_equal_to_solo_dispatches():
    """Eight programs of one bucket (n 40-63, d 256, k_max 12) in one sweep
    dispatch on the card: each program's labels, K and scores are the bits
    of its own one-program dispatch; and programs of another bucket padded
    into the chunk's larger one keep theirs too."""
    from repro_torch.core.clustering import sweep_cluster_stack

    dev = _card()
    rng = np.random.default_rng(7)
    xs = []
    for i in range(8):
        k = 2 + i % 4
        centers = rng.standard_normal((k, 256)) * 6
        n = 40 + 3 * i
        xs.append((centers[rng.integers(0, k, n)]
                   + rng.standard_normal((n, 256))).astype(np.float32))
    kw = dict(k_max=12, iters=20, device=dev)
    for chunk in (xs, xs[:3] + [xs[0][:25]]):
        got = sweep_cluster_stack(chunk, seed=list(range(len(chunk))), **kw)
        for i, (x, (gl, gi)) in enumerate(zip(chunk, got)):
            (sl, si), = sweep_cluster_stack([x], seed=i, **kw)
            assert np.array_equal(gl, sl) and gi["k"] == si["k"]
            assert gi["sil"] == si["sil"]
            assert gi.get("scores") == si.get("scores")


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k", [(1000, 200, 48), (33, 12, 3)])
def test_silhouette_sums_kernel_matches_plain(n, d, k):
    dev = _card()
    x, _, lab = _blobs(dev, n, d, k)
    onehot = torch.nn.functional.one_hot(torch.from_numpy(lab), k).float()
    onehot = (onehot * (torch.rand(n, 1) < 0.6)).to(dev).contiguous()
    got = silhouette_sums(x, onehot)
    torch.cuda.synchronize()
    _close(got, silhouette_sums_plain(x, onehot))


def _sil_inputs(dev, n, d, k, live, seed=0):
    """Points and a point-masked one-hot with ``live`` live rows."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=gen) * 3
    lab = torch.randint(0, k, (n,), generator=gen)
    mask = torch.zeros(n)
    mask[torch.randperm(n, generator=gen)[:live]] = 1
    onehot = torch.nn.functional.one_hot(lab, k).float() * mask[:, None]
    return x.to(dev), onehot.contiguous().to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k,live", [(4096, 256, 48, 300),
                                        (1000, 200, 48, 60),
                                        (4096, 12, 48, 1200),
                                        (301, 12, 5, 29)])
def test_silhouette_sums_live_rows_match_plain(n, d, k, live):
    """K3 over a mostly masked onehot (at most 10 % live rows, or PKA's
    d = 12): only live rows j are walked, and the sums are the plain
    version's."""
    dev = _card()
    x, onehot = _sil_inputs(dev, n, d, k, live)
    got = silhouette_sums(x, onehot)
    torch.cuda.synchronize()
    _close(got, silhouette_sums_plain(x, onehot))


@pytest.mark.cuda
def test_silhouette_sums_all_rows_masked_gives_zeros():
    dev = _card()
    x, onehot = _sil_inputs(dev, 300, 64, 7, 0)
    got = silhouette_sums(x, onehot)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.zeros_like(got))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [256, 12, 19])
def test_silhouette_sums_duplicates_are_exactly_zero(d):
    """Points with identical copies, each copy set its own cluster: every
    point's sum over its own cluster is exactly 0.0 (the norms accumulate
    in the tile dot product's order)."""
    dev = _card()
    gen = torch.Generator().manual_seed(d)
    base = torch.randn(50, d, generator=gen) * 4
    x = torch.cat([base, base[:20], base[:5]]).contiguous().to(dev)
    lab = torch.cat([torch.arange(50), torch.arange(20),
                     torch.arange(5)]).to(dev)          # cluster c: base[c]
    onehot = torch.nn.functional.one_hot(lab, 50).float().contiguous()
    got = silhouette_sums(x, onehot)
    torch.cuda.synchronize()
    own = got[torch.arange(75, device=dev), lab]
    assert torch.equal(own, torch.zeros_like(own))
    _close(got, silhouette_sums_plain(x, onehot))


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take():
    dev = _card()
    h, basis, src, dst, coef, wnorm, P = _k1_args(dev, 50, 32, 80, 16,
                                                  torch.float32)
    with pytest.raises(TypeError):
        rgcn_fused_agg_flat(h, basis, src.long(), dst, coef, wnorm, P)
    with pytest.raises(ValueError):
        rgcn_fused_agg_flat(h, basis, src, dst, coef.cpu(), wnorm, P)
    with pytest.raises(ValueError):
        rgcn_fused_agg_flat(h.t().contiguous().t(), basis, src, dst, coef,
                            wnorm, P)
    with pytest.raises(IndexError):
        rgcn_fused_agg_flat(h, basis, src, dst + P, coef, wnorm, P)
    x, cent, _ = _blobs(dev, 20, 8, 70)
    with pytest.raises(ValueError):               # k > 64
        kmeans_assign_fused(x, cent, torch.ones(70, device=dev),
                            torch.ones(20, device=dev))
    # the batched K2
    cb, cm, pm = cent[None, :6], torch.ones(1, 6, device=dev), \
        torch.ones(20, device=dev)
    kmeans_assign_fused_batched(x, cb.contiguous(), cm, pm)
    with pytest.raises(ValueError):               # cent must be 3-D
        kmeans_assign_fused_batched(x, cent[:6], cm, pm)
    with pytest.raises(ValueError):               # k > 64
        kmeans_assign_fused_batched(x, cent[None], torch.ones(1, 70,
                                                              device=dev), pm)
    with pytest.raises(ValueError):               # C > 1024
        kmeans_assign_fused_batched(
            x, cb.expand(1025, 6, 8).contiguous(),
            torch.ones(1025, 6, device=dev), pm)
    with pytest.raises(ValueError):               # d > 512
        kmeans_assign_fused_batched(
            torch.ones(20, 513, device=dev), torch.ones(1, 6, 513,
                                                        device=dev), cm, pm)
    with pytest.raises(ValueError):               # cmask on the CPU
        kmeans_assign_fused_batched(x, cb.contiguous(), cm.cpu(), pm)
    with pytest.raises(ValueError):               # cmask's shape
        kmeans_assign_fused_batched(x, cb.contiguous(), cm[0], pm)
    with pytest.raises(TypeError):                # float64 centroids
        kmeans_assign_fused_batched(x, cb.double().contiguous(), cm, pm)
    with pytest.raises(ValueError):               # not contiguous
        kmeans_assign_fused_batched(x, cent[None, :12:2], cm, pm)
    with pytest.raises(ValueError):               # workspace of another shape
        kmeans_assign_fused_batched(x, cb.contiguous(), cm, pm,
                                    out=K2Workspace(2, 20, 6, 8, dev))
    with pytest.raises(ValueError):               # B > 1024 programs
        kmeans_assign_fused_batched(
            x[None].expand(1025, 20, 8).contiguous(),
            cb[None].expand(1025, 1, 6, 8).contiguous(), cm,
            pm[None].expand(1025, 20).contiguous())
    with pytest.raises(ValueError):               # pmask without programs
        kmeans_assign_fused_batched(x[None], cb[None].contiguous(), cm, pm)


@pytest.mark.cuda
def test_program_served_on_card_matches_cpu():
    """nw through the whole slice on the card and on the CPU, same random
    encoder: same K, representatives and labels."""
    _card()
    from repro_torch.core.rgcn import RGCNConfig, init_rgcn
    from repro_torch.interop import params_to_numpy
    from repro_torch.sampling import Artifacts, get_method
    from repro_torch.serving import PlanService
    from repro_torch.tracing.programs import get_program

    params = params_to_numpy(init_rgcn(0, RGCNConfig()))
    plans = {}
    for device in ("cuda", "cpu"):
        m = get_method("gcl", device=device)
        m.adopt(Artifacts("gcl", "enc", "enc", payload={"params": params}))
        with PlanService(device=device) as svc:
            plans[device] = svc.submit_program(m, get_program("nw")).result()
            assert svc.stats()["failed"] == 0
    assert plans["cuda"].num_clusters == plans["cpu"].num_clusters
    assert plans["cuda"].rep_indices() == plans["cpu"].rep_indices()
    assert np.array_equal(plans["cuda"].labels, plans["cpu"].labels)


# (D, offset, pile): the gathers' layouts (16 lanes a row up to D = 64,
# 32 beyond, two slots a lane past 128, scalars for D % 4 != 0), h one
# element off its 16-byte boundary (the scalar path), and one row of
# degree >= 1200 (38 steps of 32 edge slots), and phi-2's first packed
# embed batch (P = 4096, 2072 padded edges on node 0); every case has rows
# of degree 0 and a padded tail of zero weight at node 0
_GATHER_SHAPES = [(64, 0, 0), (128, 0, 0), (40, 0, 0), (37, 0, 0),
                  (256, 0, 0), (200, 0, 0), (64, 1, 0), (128, 1, 0),
                  (64, 0, 1200), (128, 0, 1200), (128, 0, "phi-2")]
_GATHER_IDS = [str(D) + (f"-offset{o}" if o else "")
               + (f"-{p}-embed-batch" if isinstance(p, str)
                  else f"-pile{p}" if p else "")
               for D, o, p in _GATHER_SHAPES]


@pytest.mark.cuda
@pytest.mark.parametrize("D,offset,pile", _GATHER_SHAPES, ids=_GATHER_IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rgcn_spmm_kernel_matches_plain(D, offset, pile, dtype):
    """K5 against its plain version, equal bits on a repeat, and Q = 0."""
    dev = _card()
    h, _, src, dst, coef, wnorm, P = _k1_args(
        dev, 700, D, 1500, 8, getattr(torch, dtype), offset=offset,
        pile=pile)
    w = (coef * wnorm[:, None]).contiguous()
    before = rgcn_spmm_flat.launches
    got = rgcn_spmm_flat(h, src, dst, w, P)
    torch.cuda.synchronize()
    assert rgcn_spmm_flat.launches == before + 1
    _close(got, rgcn_spmm_flat_plain(h, src, dst, w, P))
    assert torch.equal(got, rgcn_spmm_flat(h, src, dst, w, P))
    empty = torch.zeros(0, dtype=torch.int32, device=dev)
    zero = rgcn_spmm_flat(h, empty, empty, w[:0], P)
    assert zero.shape == (P, 2 * D) and not zero.any()


@pytest.mark.cuda
@pytest.mark.parametrize("D,offset,pile", _GATHER_SHAPES, ids=_GATHER_IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rgcn_fused_bwd_kernel_matches_plain(D, offset, pile, dtype):
    """K1b against its plain version (dh and dcoef; equal bits on a
    repeat); the kernel writes every dcoef entry, the wnorm = 0 ones as 0,
    into outputs that start as NaN; Q = 0; then K1's whole backward on the
    card (K5 + K1b + the matmuls) and the unfused layer's (K5 + matmul
    forward, K1b with unit norms backward, the padded tail moved to src =
    dst = 0 as pack_graphs leaves it) against the same backward on the
    CPU."""
    dev = _card()
    from repro_torch.kernels import launch, weight_csr

    tdt = getattr(torch, dtype)
    h, basis, src, dst, coef, wnorm, P = _k1_args(
        dev, 700, D, 1500, 96, tdt, offset=offset, pile=pile)
    Q = src.shape[0]
    t = torch.randn(P, 2 * D, device=dev)
    before = rgcn_fused_bwd.launches
    dh, dcoef = rgcn_fused_bwd(h, t, src, dst, coef, wnorm, P)
    torch.cuda.synchronize()
    assert rgcn_fused_bwd.launches == before + 1 and dh.dtype == tdt
    want_dh, want_dc = rgcn_fused_bwd_plain(h, t, src, dst, coef, wnorm, P)
    _close(dh, want_dh)
    _close(dcoef, want_dc)
    again = rgcn_fused_bwd(h, t, src, dst, coef, wnorm, P)
    assert torch.equal(dh, again[0]) and torch.equal(dcoef, again[1])

    csr = weight_csr(src, coef * wnorm[:, None], P)
    nan_dh = torch.full_like(dh, float("nan"))
    nan_dc = torch.full_like(dcoef, float("nan"))
    launch("rgcn_fused_bwd", h.data_ptr(), int(tdt == torch.bfloat16),
           *(x.data_ptr() for x in (t, src, dst, csr.perm, csr.rowptr, coef,
                                    wnorm, nan_dh, nan_dc)),
           P, Q, D, 2)
    torch.cuda.synchronize()
    assert torch.equal(nan_dh, dh) and torch.equal(nan_dc, dcoef)
    assert not dcoef[wnorm == 0].any()
    empty = torch.zeros(0, dtype=torch.int32, device=dev)
    zh, zc = rgcn_fused_bwd(h, t, empty, empty, coef[:0], wnorm[:0], P)
    assert zc.shape == (0, 2) and not zh.float().any()

    g = torch.randn(P, 96, device=dev)
    pad = wnorm == 0
    src0 = torch.where(pad, 0, src)
    w = (coef * wnorm[:, None]).contiguous()
    grads = {}
    for where in ("cuda", "cpu"):
        xs = [x.detach().to(where).requires_grad_() for x in (h, basis, coef)]
        out = rgcn_fused_agg_flat(xs[0], xs[1], src.to(where), dst.to(where),
                                  xs[2], wnorm.to(where), P)
        ws = [x.detach().to(where).requires_grad_() for x in (h, basis, w)]
        out2 = rgcn_message_agg_flat(ws[0], ws[1], src0.to(where),
                                     dst.to(where), ws[2], P)
        grads[where] = (torch.autograd.grad(out, xs, g.to(where))
                        + torch.autograd.grad(out2, ws, g.to(where)))
    for a, b in zip(grads["cuda"], grads["cpu"]):
        _close(a, b)
    assert grads["cuda"][5][pad].abs().sum() > 0   # dw of zero-weight edges


@pytest.mark.cuda
def test_training_step_on_card_matches_cpu():
    """One optimizer step of the full-width encoder on the card against the
    same step on the CPU, with draws made on the CPU and copied over: the
    loss (1e-5), the gradient (1e-3) and the parameters after the step
    (1e-4), each as one vector relative to its norm.  The encoder's
    gradient jumps where a pre-activation crosses zero (ReLU); the card's
    forward differs from the CPU's by ~1e-6, enough to move one element
    across, which on the CPU moves one basis gradient by 2.5e-3 of its
    largest element and the whole gradient by ~2e-4 of its norm (see
    ``chip_smoke.py``)."""
    dev = _card()
    from repro_torch.core.batching import pack_graphs
    from repro_torch.core.graphs import build_kernel_graph
    from repro_torch.core.rgcn import RGCNConfig, init_rgcn
    from repro_torch.core.train import (
        GCLTrainConfig, draw_seed, draw_step, packed_loss, train_step,
    )
    from repro_torch.optim import adamw_init
    from repro_torch.tracing.templates import make_kernel

    templates = [("gemm", {"M": 128, "N": 128, "K": 128}),
                 ("stencil", {"nx": 512, "ny": 4, "pts": 5, "iters": 8}),
                 ("reduction", {"n": 65536}),
                 ("softmax", {"rows": 64, "cols": 1000})]
    graphs = [build_kernel_graph(make_kernel(f"k{i}", *templates[i % 4], i,
                                             seed=i).trace())
              for i in range(8)]
    packed, _ = pack_graphs(graphs)
    rc, tc = RGCNConfig(), GCLTrainConfig()
    batch = {k: torch.from_numpy(v) for k, v in packed.items()}
    draws = draw_step(torch.Generator().manual_seed(draw_seed(0, 0)), batch,
                      rc)
    out = {}
    for where in ("cpu", dev):
        enc = init_rgcn(0, rc).to(where)
        params = dict(enc.named_parameters())
        b = {k: v.to(where) for k, v in batch.items()}
        d = tuple(x.to(where) for x in draws)
        loss, _ = packed_loss(enc, rc, tc.tau, b, d)
        grads = torch.autograd.grad(loss, list(params.values()))
        _, m = train_step(enc, rc, tc.tau, tc.opt, b, d,
                          adamw_init(params, tc.opt))
        out[str(where)] = (m.cpu(), dict(zip(params, grads)),
                           {k: p.detach().cpu() for k, p in params.items()})
    (m_cpu, g_cpu, p_cpu), (m_card, g_card, p_card) = out["cpu"], out[str(dev)]
    assert abs(float(m_card[0] - m_cpu[0])) <= 1e-5 * abs(float(m_cpu[0]))

    def gap(a, b):
        num = sum(float(((a[k].cpu() - b[k]) ** 2).sum()) for k in b)
        return (num / sum(float((v ** 2).sum()) for v in b.values())) ** 0.5

    assert gap(g_card, g_cpu) <= 1e-3
    assert gap(p_card, p_cpu) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k", [(2425, 256, 2), (2425, 256, 48),
                                   (1001, 12, 48), (37, 12, 2),
                                   (70, 300, 130)])
@pytest.mark.parametrize("dup", [False, True])
def test_kmeans_assign_seq_kernel_matches_plain(n, d, k, dup):
    """K4 against its plain version: labels equal wherever the plain
    version's two smallest distances differ by more than 1e-6 of the
    distance scale, min distance within TOL of that scale, and among
    identical centroids (``dup``: the points are copies of 5 rows and the
    centroids are points) the lowest index wins."""
    dev = _card()
    rng = np.random.default_rng(n + d + k)
    if dup:
        rows = rng.standard_normal((5, d)).astype(np.float32)
        x_np = rows[rng.integers(0, 5, n)]
    else:
        x_np = rng.standard_normal((n, d)).astype(np.float32)
    x = torch.from_numpy(x_np).to(dev)
    cent = x[torch.from_numpy(rng.integers(0, n, k)).to(dev)].contiguous()
    before = kmeans_assign.launches
    lab, mind = kmeans_assign(x, cent)
    torch.cuda.synchronize()
    assert kmeans_assign.launches == before + 1
    plab, pmind = kmeans_assign_plain(x, cent)
    x2 = (x * x).sum(1, keepdim=True)
    d2 = torch.clamp_min(x2 - 2 * x @ cent.T + (cent * cent).sum(1)[None], 0)
    scale = float(x2.max() + (cent * cent).sum(1).max())
    if k > 1:
        top2 = torch.topk(d2, 2, dim=1, largest=False).values
        clear = top2[:, 1] - top2[:, 0] > 1e-6 * scale
        assert torch.equal(lab[clear], plab[clear])
    assert float((mind - pmind).abs().max()) <= TOL * scale
    if dup:
        c = cent.cpu().numpy()
        first = {}
        for i, row in enumerate(map(bytes, c)):
            first.setdefault(row, i)
        assert all(first[bytes(c[i])] == i for i in lab.cpu().numpy())
    assert torch.equal(lab, kmeans_assign(x, cent)[0])   # deterministic


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 48, 300])
@pytest.mark.parametrize("d", [1, 12, 256, 1000])
def test_kmeans_assign_seq_kernel_shapes(k, d):
    """K4 at n = 2427 (not a multiple of its 16-point tile), past one
    64-centroid tile (k = 300) and past one shared-memory stage of the
    feature axis (d = 1000; k = 300 at d = 256 is 307 KB of centroids):
    labels equal to the plain version's wherever the two nearest
    centroids are clear of a near-tie, min distance within TOL of the
    scale, identical centroids resolved to the lowest index."""
    dev = _card()
    n = 2427
    rng = np.random.default_rng(k + d)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)
                         ).to(dev)
    idx = rng.integers(0, n, k)
    if k > 2:
        idx[k // 2] = idx[0]                      # a duplicated centroid
    cent = x[torch.from_numpy(idx).to(dev)].contiguous()
    lab, mind = kmeans_assign(x, cent)
    torch.cuda.synchronize()
    plab, pmind = kmeans_assign_plain(x, cent)
    x2 = (x * x).sum(1)
    scale = float(x2.max() + (cent * cent).sum(1).max())
    if k > 1:
        d2 = torch.clamp_min(x2[:, None] - 2 * x @ cent.T
                             + (cent * cent).sum(1)[None], 0)
        top2 = torch.topk(d2, 2, dim=1, largest=False).values
        clear = top2[:, 1] - top2[:, 0] > 1e-6 * scale
        assert torch.equal(lab[clear], plab[clear])
    else:
        assert torch.equal(lab, torch.zeros_like(lab))
    assert float((mind - pmind).abs().max()) <= TOL * scale
    if k > 2:
        assert int(lab[int(idx[0])]) == 0 and float(mind[int(idx[0])]) == 0


@pytest.mark.cuda
def test_kmeans_assign_seq_wrapper_rejects_bad_inputs():
    dev = _card()
    x = torch.randn(40, 12, device=dev)
    with pytest.raises(TypeError):
        kmeans_assign(x.double(), x[:3].double())
    with pytest.raises(ValueError):
        kmeans_assign(x, x[:3].cpu())
    with pytest.raises(ValueError):
        kmeans_assign(x, x[:3, :5].contiguous())
    with pytest.raises(ValueError):
        kmeans_assign(x, x[:0])


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(2425, 48), (301, 2)])
def test_k2_k3_at_pka_width_match_plain(n, k):
    """K2 and K3 at PKA's feature width d = 12."""
    dev = _card()
    x, cent, lab = _blobs(dev, n, 12, k)
    cmask = torch.ones(k, device=dev)
    pmask = (torch.arange(n, device=dev) < n - 3).float()
    got = kmeans_assign_fused(x, cent, cmask, pmask)
    torch.cuda.synchronize()
    want = kmeans_assign_fused_plain(x, cent, cmask, pmask)
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        _close(g, w)
    onehot = torch.nn.functional.one_hot(torch.from_numpy(lab), k).float()
    onehot = onehot.to(dev).contiguous()
    _close(silhouette_sums(x, onehot), silhouette_sums_plain(x, onehot))


@pytest.mark.cuda
def test_sequential_reference_on_card_matches_cpu():
    """``select_k_and_cluster`` on the card (K4 + K3) and on the CPU:
    same K and labels on separated blobs, scores within 1e-5, and K4 was
    launched."""
    _card()
    from repro_torch.core.clustering import select_k_and_cluster

    rng = np.random.default_rng(0)
    centers = rng.standard_normal((5, 16)) * 8
    x = (centers[rng.integers(0, 5, 300)]
         + rng.standard_normal((300, 16))).astype(np.float32)
    before = kmeans_assign.launches
    lab, info = select_k_and_cluster(x, k_max=10)
    assert kmeans_assign.launches > before
    clab, cinfo = select_k_and_cluster(x, k_max=10, device="cpu")
    assert info["k"] == cinfo["k"] and np.array_equal(lab, clab)
    for k, v in cinfo["scores"].items():
        assert abs(info["scores"][k] - v) <= 1e-5


# ---------------------------------------------------------------------------
# the LM serving path: K7 (flash attention) and K8 (SSD intra-chunk)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1536, 2, 3, 128), (2, 100, 2, 2, 32),
                                   (1, 512, 1, 8, 256), (2, 64, 4, 1, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_matches_plain(shape, dtype):
    """K7 at llama's head shape on a 1536-token prefill, an S that is not
    a multiple of its 64-row tile, the widest head and MHA at hd=16."""
    dev = _card()
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain,
    )

    B, S, K, G, hd = shape
    gen = torch.Generator(device=dev).manual_seed(S + hd)
    q, k, v = (torch.randn(s, generator=gen, device=dev).to(
        getattr(torch, dtype)) for s in ((B, S, K, G, hd), (B, S, K, hd),
                                         (B, S, K, hd)))
    before = flash_attention.launches
    got = flash_attention(q, k, v, hd ** -0.5)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, flash_attention_plain(q, k, v, hd ** -0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [64, 100, 512, 1536])
@pytest.mark.parametrize("hd,dtype", [
    (64, "bfloat16"), (128, "bfloat16"), (256, "bfloat16"),  # wgmma + TMA
    (16, "bfloat16"), (96, "bfloat16"),                      # mma.sync
    (64, "float32"), (128, "float32"), (256, "float32")])    # float32 FMAs
def test_flash_attention_dispatch_matches_plain(S, hd, dtype):
    """Every kernel K7's head-width dispatch picks, at sequence lengths
    inside one 128-row query tile, not a multiple of it, and over several
    (the causal diagonal crosses tile boundaries), G = 3 heads per KV
    head."""
    dev = _card()
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(S * hd)
    q, k, v = (torch.randn(s, generator=gen, device=dev).to(
        getattr(torch, dtype)) for s in ((1, S, 2, 3, hd), (1, S, 2, hd),
                                         (1, S, 2, hd)))
    got = flash_attention(q, k, v, hd ** -0.5)
    torch.cuda.synchronize()
    _close(got, flash_attention_plain(q, k, v, hd ** -0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 4, 256, 8, 64, 128),
                                   (4, 8, 256, 48, 64, 128),
                                   (2, 32, 32, 8, 16, 16),
                                   (1, 3, 48, 3, 24, 40),
                                   (1, 2, 100, 3, 10, 13),
                                   (1, 2, 100, 3, 9, 13)])
def test_ssd_intra_chunk_kernel_matches_plain(shape):
    """K8 at mamba's chunk, head and state widths (the prefill shape
    among them), the smoke shape, sizes that are multiples of none of its
    tiles, and head and state widths that are no multiple of 4 (4-byte
    staging copies, odd-width stores); a second call gives the same bits
    (fixed-order sums, no atomics)."""
    dev = _card()
    from repro_torch.kernels.ssd_scan.ops import (
        ssd_intra_chunk, ssd_intra_chunk_plain,
    )

    B, nc, Q, nh, hp, ds = shape
    gen = torch.Generator(device=dev).manual_seed(Q)

    def randn(*s):
        return torch.randn(s, generator=gen, device=dev)

    x = randn(B, nc, Q, nh, hp)
    dt = torch.nn.functional.softplus(randn(B, nc, nh, Q) - 1.0)
    A = -torch.linspace(1.0, 16.0, nh, device=dev)
    cum = torch.cumsum(dt * A[None, None, :, None], dim=-1).contiguous()
    Bc, Cc = randn(B, nc, Q, ds), randn(B, nc, Q, ds)
    before = ssd_intra_chunk.launches
    got = ssd_intra_chunk(x, cum, dt.contiguous(), Bc, Cc)
    torch.cuda.synchronize()
    assert ssd_intra_chunk.launches == before + 1
    for g, w in zip(got, ssd_intra_chunk_plain(x, cum, dt, Bc, Cc)):
        _close(g, w)
    again = ssd_intra_chunk(x, cum, dt.contiguous(), Bc, Cc)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 256, 8, 3, 128), (1, 100, 2, 2, 32),
                                   (1, 512, 1, 8, 256), (2, 64, 4, 1, 16),
                                   (1, 1024, 2, 3, 64), (1, 200, 2, 3, 96),
                                   (2, 130, 1, 4, 48), (2, 100, 2, 6, 128),
                                   (1, 330, 2, 1, 64), (2, 256, 2, 6, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_kernel_matches_plain(shape, dtype):
    """K7b at llama's head shape, Ss that are no multiple of its 32- and
    64-row tiles, head widths that fill part of the tensor-core kernels'
    column tiles (96, 48), the widest head (bf16 on the FMA kernels), MHA
    at hd=16, a 1024-token prompt, and the wgmma route (bf16, hd 64 / 128)
    at G 1 / 3 / 6 with ragged S: dq, dk, dv from the output and
    log-sum-exp of the forward that writes the log-sum-exp (its output held
    to the plain one as K7's is, its log-sum-exp within 1e-5) against the
    plain float32 recompute; a second launch gives the same bits
    (fixed-order sums, no atomics); autograd through ``flash_attention`` on
    the card launches K7 then K7b once each."""
    dev = _card()
    from repro_torch.kernels.flash_attention.ops import (
        bwd_route, flash_attention, flash_attention_bwd,
        flash_attention_bwd_plain, flash_attention_lse,
        flash_attention_plain,
    )

    B, S, K, G, hd = shape
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(S + hd)
    q, k, v, do = (torch.randn(s, generator=gen, device=dev).to(dt)
                   for s in ((B, S, K, G, hd), (B, S, K, hd), (B, S, K, hd),
                             (B, S, K, G, hd)))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = (flash_attention.launches, flash_attention_bwd.launches)
    out = flash_attention(*leaves, hd ** -0.5)
    auto = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    out, lse = flash_attention_lse(q, k, v, hd ** -0.5)
    want_out, want_lse = flash_attention_plain(q, k, v, hd ** -0.5,
                                               return_lse=True)
    assert out.dtype == dt and out.shape == q.shape
    _close(out, want_out)
    assert float((lse - want_lse).abs().max()) <= \
        1e-5 * float(want_lse.abs().max())
    got = flash_attention_bwd(q, k, v, out, do, hd ** -0.5, lse)
    torch.cuda.synchronize()
    want = flash_attention_bwd_plain(q, k, v, out, do, hd ** -0.5)
    for g, a, w in zip(got, auto, want):
        assert g.dtype == dt and torch.equal(g, a)
        _close(g, w)
    again = flash_attention_bwd(q, k, v, out, do, hd ** -0.5, lse)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    if bwd_route(dt, hd) == "wgmma":
        with pytest.raises(ValueError, match="log-sum-exp"):
            flash_attention_bwd(q, k, v, out, do, hd ** -0.5)


#: K8b against its plain version: 1e-4 of the largest element, since dcum
#: is a difference of row and column sums over the (Q, Q) triangle whose
#: terms cancel, summed in other orders by the kernel and the plain version
K8B_TOL = 1e-4


def _k8b_inputs(dev, shape, seed):
    """K8's inputs as the mamba mixer makes them, a random dy and a nonzero
    dstates."""
    B, nc, Q, nh, hp, ds = shape
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*s):
        return torch.randn(s, generator=gen, device=dev)

    x = randn(B, nc, Q, nh, hp)
    dt = torch.nn.functional.softplus(randn(B, nc, nh, Q) - 1.0)
    A = -torch.linspace(1.0, 16.0, nh, device=dev)
    cum = torch.cumsum(dt * A[None, None, :, None], dim=-1).contiguous()
    args = (x, cum, dt.contiguous(), randn(B, nc, Q, ds), randn(B, nc, Q, ds))
    return args, randn(B, nc, Q, nh, hp), randn(B, nc, nh, hp, ds)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 1, 256, 48, 64, 128),
                                   (4, 8, 256, 48, 64, 128),
                                   (8, 8, 32, 8, 16, 16),
                                   (2, 1, 200, 5, 64, 128),
                                   (1, 3, 48, 3, 24, 40),
                                   (1, 2, 100, 3, 10, 13),
                                   (1, 2, 100, 3, 9, 13)])
def test_ssd_intra_chunk_bwd_kernel_matches_plain(shape):
    """K8b at mamba2-780m's training shape (8 x 256 tokens, one chunk), its
    prefill shape, the smoke shape the step parity trains (8 x 256 tokens
    in chunks of 32), a ragged chunk of 200 rows over 4 tiles, sizes that
    are multiples of none of its tiles and head and state widths that are
    no multiple of 4: dx, dcum, ddt, dBc, dCc against the plain backward,
    with a random dy and a nonzero dstates; a second launch gives the same
    bits (fixed-order sums, no atomics); autograd through
    ``ssd_intra_chunk`` launches K8 then K8b once each, with the same
    bits."""
    dev = _card()
    from repro_torch.kernels.ssd_scan.ops import (
        ssd_intra_chunk, ssd_intra_chunk_bwd, ssd_intra_chunk_bwd_plain,
    )

    args, dy, dst = _k8b_inputs(dev, shape, sum(shape))
    before = ssd_intra_chunk_bwd.launches
    got = ssd_intra_chunk_bwd(*args, dy, dst)
    torch.cuda.synchronize()
    assert ssd_intra_chunk_bwd.launches == before + 1
    want = ssd_intra_chunk_bwd_plain(*args, dy, dst)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= K8B_TOL * max(scale, 1e-30)
    del want
    again = ssd_intra_chunk_bwd(*args, dy, dst)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    leaves = [t.clone().requires_grad_(True) for t in args]
    before = (ssd_intra_chunk.launches, ssd_intra_chunk_bwd.launches)
    auto = torch.autograd.grad(ssd_intra_chunk(*leaves), leaves, (dy, dst))
    torch.cuda.synchronize()
    assert (ssd_intra_chunk.launches, ssd_intra_chunk_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert all(torch.equal(g, a) for g, a in zip(got, auto))


@pytest.mark.cuda
def test_ssd_intra_chunk_bwd_rejects_what_the_kernel_does_not_take():
    dev = _card()
    from repro_torch.kernels.ssd_scan.ops import ssd_intra_chunk_bwd

    args, dy, dst = _k8b_inputs(dev, (1, 1, 32, 2, 16, 8), 0)
    x, cum, dt, Bc, Cc = args
    with pytest.raises(ValueError):               # dy: wrong shape
        ssd_intra_chunk_bwd(*args, dy[:, :, :16], dst)
    with pytest.raises(ValueError):               # dstates: wrong dtype
        ssd_intra_chunk_bwd(*args, dy, dst.double())
    with pytest.raises(ValueError):               # dy not contiguous
        ssd_intra_chunk_bwd(*args, dy.transpose(3, 4).contiguous()
                            .transpose(3, 4), dst)
    with pytest.raises(ValueError):               # dstates on the CPU
        ssd_intra_chunk_bwd(*args, dy, dst.cpu())
    with pytest.raises(ValueError):               # cum not contiguous
        ssd_intra_chunk_bwd(x, cum.transpose(2, 3).contiguous()
                            .transpose(2, 3), dt, Bc, Cc, dy, dst)
    with pytest.raises(TypeError):                # x float64
        ssd_intra_chunk_bwd(x.double(), cum, dt, Bc, Cc, dy, dst)
    with pytest.raises(ValueError):               # ds > 128
        big = torch.zeros(1, 1, 32, 256, device=dev)
        ssd_intra_chunk_bwd(x, cum, dt, big, big, dy,
                            torch.zeros(1, 1, 2, 16, 256, device=dev))
    with pytest.raises(ValueError):               # Q > 256
        z = torch.zeros(1, 1, 320, 2, 16, device=dev)
        c = torch.zeros(1, 1, 2, 320, device=dev)
        b = torch.zeros(1, 1, 320, 8, device=dev)
        ssd_intra_chunk_bwd(z, c, c, b, b, z, dst)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,dtype", [
    ("flash_attention_bwd", "bfloat16"),      # wgmma route: D only
    ("flash_attention_bwd", "float32"),       # FMA route: lse and D
    ("ssd_intra_chunk_bwd", "float32")])
def test_backward_launchers_refuse_a_short_workspace(kernel, dtype):
    """K7b's and K8b's C entries take their workspace's length and refuse
    one float shorter than their own layout (cudaErrorInvalidValue, no
    launch), so the wrappers' size formulas cannot fall behind the .cu
    files unseen; the exact length launches."""
    dev = _card()
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd_scratch, flash_attention_lse,
    )
    from repro_torch.kernels.ssd_scan.ops import ssd_intra_chunk_bwd_scratch

    dt = getattr(torch, dtype)
    if kernel == "flash_attention_bwd":
        B, S, K, G, hd = 1, 100, 2, 3, 128
        gen = torch.Generator(device=dev).manual_seed(5)
        q, k, v, do = (torch.randn(s, generator=gen, device=dev).to(dt)
                       for s in ((B, S, K, G, hd), (B, S, K, hd),
                                 (B, S, K, hd), (B, S, K, G, hd)))
        out, lse = flash_attention_lse(q, k, v, hd ** -0.5)
        n = flash_attention_bwd_scratch(B, S, K, G, hd, dt)
        outs = [torch.empty_like(t) for t in (q, k, v)]
        ins = (q, k, v, out, do, lse)
        tail = (int(dt == torch.bfloat16), B, S, K, G, hd, hd ** -0.5)
    else:
        shape = (1, 2, 100, 3, 10, 13)
        args, dy, dst = _k8b_inputs(dev, shape, 5)
        n = ssd_intra_chunk_bwd_scratch(*shape)
        outs = [torch.empty_like(t) for t in args]
        ins = (*args, dy, dst)
        tail = shape
    scratch = torch.empty(n, dtype=torch.float32, device=dev)

    def call(n_scratch):
        head = [t.data_ptr() for t in ins]
        ptrs = [t.data_ptr() for t in outs]
        if kernel == "flash_attention_bwd":
            return kernels.launch(kernel, *head, *ptrs, scratch.data_ptr(),
                                  n_scratch, *tail)
        return kernels.launch(kernel, *head, scratch.data_ptr(), n_scratch,
                              *ptrs, *tail)

    with pytest.raises(RuntimeError, match="cudaError 1$"):
        call(n - 1)
    call(n)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_lm_training_gradients_never_bypass_a_kernel():
    """On the card a gradient through an SSM layer launches K8 then K8b
    (never the plain backward): K8b once per mamba layer of a training
    loss, K8 once and again in the recompute of JAX's default remat;
    attention layers train through K7 / K7b alike; jamba's block (one
    attention layer, seven mamba layers, four MoE FFNs) and dbrx's MoE
    layers launch the same kernels per mixer."""
    dev = _card()
    from repro_torch.configs import smoke_arch
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_bwd,
    )
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.data import TokenStream
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import tree_leaves

    plain = ssd_ops.ssd_intra_chunk_bwd_plain
    called = []
    ssd_ops.ssd_intra_chunk_bwd_plain = lambda *a: called.append(a) or \
        plain(*a)
    try:
        for arch, layers, want in (
                ("mamba2-780m", 3, [3, 3, 0, 0]),
                ("llama3.2-3b", 3, [0, 0, 3, 3]),
                ("jamba-v0.1-52b", 8, [7, 7, 1, 1]),
                ("dbrx-132b", 3, [0, 0, 3, 3])):
            cfg = smoke_arch(arch).replace(num_layers=layers)
            fwd = 2 if cfg.remat else 1     # the forward and its recompute
            want = [n * (fwd if i % 2 == 0 else 1)
                    for i, n in enumerate(want)]
            params = tf.init_params(cfg, torch.Generator(device=dev)
                                    .manual_seed(0), device=dev)
            leaves = tree_leaves(params)
            for p in leaves:
                p.requires_grad_(True)
            batch = {k: torch.from_numpy(v).to(dev) for k, v in TokenStream(
                cfg.vocab_size, 64, 2, seed=0).next().items()}
            wrappers = (ssd_ops.ssd_intra_chunk, ssd_ops.ssd_intra_chunk_bwd,
                        flash_attention, flash_attention_bwd)
            before = [w.launches for w in wrappers]
            grads = torch.autograd.grad(tf.lm_loss(cfg, params, batch)[0],
                                        leaves)
            torch.cuda.synchronize()
            got = [w.launches - b for w, b in zip(wrappers, before)]
            assert got == want, (arch, got)
            assert all(bool(torch.isfinite(g).all()) for g in grads)
    finally:
        ssd_ops.ssd_intra_chunk_bwd_plain = plain
    assert called == []


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["dbrx-132b", "jamba-v0.1-52b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_backward_on_card_is_bit_equal(arch, dtype):
    """One MoE layer at D 256, 16 experts, routed in 2 chunks with dropped
    slots: two backward passes on the card give the same bits (no sum
    depends on atomics' order), and the output and gradients agree with
    the CPU's (float32: 1e-5 of the largest output element, 1e-4 of each
    gradient's norm; bfloat16: 2^-6 of the output, 2^-5 of each norm)."""
    dev = _card()
    from repro_torch.configs import smoke_arch
    from repro_torch.models import moe

    cfg = smoke_arch(arch).replace(
        d_model=256, d_ff=384, num_experts=16, top_k=min(
            smoke_arch(arch).top_k * 2, 4), moe_seq_chunk=128,
        capacity_factor=1.0, compute_dtype=dtype)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(1)
    h = torch.from_numpy(rng.standard_normal((3, 256, 256)).astype(
        np.float32)).to(getattr(torch, dtype))
    ct = torch.from_numpy(rng.standard_normal((3, 256, 256)).astype(
        np.float32))

    def grads(d):
        pd = {k: v.to(d).requires_grad_(True) for k, v in p.items()}
        hd = h.to(d).requires_grad_(True)
        out, aux = moe.moe_forward(cfg, pd, hd)
        loss = (out.float() * ct.to(d)).sum() + aux
        names = sorted(pd)
        return out, torch.autograd.grad(loss, [hd] + [pd[n] for n in names])

    out1, g1 = grads(dev)
    out2, g2 = grads(dev)
    torch.cuda.synchronize()
    assert torch.equal(out1, out2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    out_cpu, g_cpu = grads("cpu")
    otol, gtol = (1e-5, 1e-4) if dtype == "float32" else (2 ** -6, 2 ** -5)
    scale = float(out_cpu.detach().float().abs().max())
    assert float((out1.float().cpu() - out_cpu.float()).abs().max()) <= \
        otol * scale
    for a, b in zip(g1, g_cpu):
        a, b = a.float().cpu(), b.float()
        assert float((a - b).norm()) <= gtol * float(b.norm())


@pytest.mark.cuda
def test_lm_wrappers_reject_what_the_kernels_do_not_take():
    dev = _card()
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.ssd_scan.ops import ssd_intra_chunk

    q = torch.zeros(1, 64, 2, 2, 16, device=dev)
    k = torch.zeros(1, 64, 2, 16, device=dev)
    with pytest.raises(ValueError):               # not contiguous
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, k,
                        0.25)
    with pytest.raises(ValueError):               # k on the CPU
        flash_attention(q, k.cpu(), k, 0.25)
    with pytest.raises(TypeError):                # mixed dtypes
        flash_attention(q, k.bfloat16(), k, 0.25)
    with pytest.raises(ValueError):               # S neither <= 512 nor 512k
        z = torch.zeros(1, 600, 1, 1, 16, device=dev)
        flash_attention(z, z[:, :, :, 0], z[:, :, :, 0], 0.25)
    flat = torch.zeros(1 + 64 * 2 * 16, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):               # bf16 q off a 16-byte line
        flash_attention(flat[1:].view(1, 64, 2, 1, 16), k.bfloat16(),
                        k.bfloat16(), 0.25)
    x = torch.zeros(1, 1, 32, 2, 16, device=dev)
    cum = torch.zeros(1, 1, 2, 32, device=dev)
    Bc = torch.zeros(1, 1, 32, 8, device=dev)
    with pytest.raises(ValueError):               # not contiguous
        ssd_intra_chunk(x, cum.transpose(2, 3).contiguous().transpose(2, 3),
                        cum, Bc, Bc)
    with pytest.raises(TypeError):
        ssd_intra_chunk(x.double(), cum, cum, Bc, Bc)
    with pytest.raises(ValueError):               # ds > 128
        big = torch.zeros(1, 1, 32, 256, device=dev)
        ssd_intra_chunk(x, cum, cum, big, big)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-780m",
                                  "jamba-v0.1-52b", "dbrx-132b",
                                  "granite-3-2b", "qwen2-72b", "yi-34b",
                                  "paligemma-3b", "musicgen-medium"])
def test_lm_prefill_and_decode_on_card_match_cpu(arch):
    """A smoke-width model (two blocks, float32) on the card through K7 /
    K8 (and the MoE FFN, qwen2's QKV bias, paligemma's MQA and vision
    prefix, musicgen's audio conditioning) against the same weights on the
    CPU: prefill logits of 256 positions, then 4 teacher-forced decode
    steps, within 1e-4 of their scale."""
    dev = _card()
    from repro_torch.configs import smoke_arch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.ssd_scan.ops import ssd_intra_chunk
    from repro_torch.launch.serve import _splice_prefill
    from repro_torch.models import transformer as tf

    base = smoke_arch(arch)
    cfg = base.replace(num_layers=2 * base.block_size)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    rng = np.random.default_rng(0)
    P = 256 - (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, P + 4)).astype(np.int32))
    fe = None
    if cfg.frontend == "vision":
        fe = rng.standard_normal((2, cfg.frontend_tokens, cfg.d_model))
    elif cfg.frontend == "audio":
        fe = rng.standard_normal((2, P, cfg.d_model))
    if fe is not None:
        fe = torch.from_numpy(fe.astype(np.float32))
    runs = {}
    for d in ("cpu", dev):
        p = tf._tree_map(lambda t: t.to(d), params)
        before = (flash_attention.launches, ssd_intra_chunk.launches)
        logits, caches, idx = tf.prefill(cfg, p, toks[:, :P].to(d),
                                         None if fe is None else fe.to(d))
        launched = (flash_attention.launches - before[0],
                    ssd_intra_chunk.launches - before[1])
        assert idx == 256
        state = _splice_prefill(cfg, tf.init_decode_state(
            cfg, 2, 260, idx, device=d), caches, idx)
        out = [logits]
        for t in range(P, P + 4):
            logits, state = tf.decode_step(cfg, p, state,
                                           toks[:, t:t + 1].to(d))
            out.append(logits)
        runs[str(d)] = (out, launched)
    (cpu, _), (card, launched) = runs["cpu"], runs[str(dev)]
    specs = cfg.layer_specs()
    attn = sum(s.mixer == "attention" for s in specs) * cfg.num_blocks
    assert launched == (attn, cfg.num_layers - attn)
    for got, want in zip(card, cpu):
        scale = float(want.abs().max())
        assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale


def _k6_args(dev, B, N, E, D, dtype, live=0.5, seed=0, hub=0, offset=0):
    """A dense batch as pad_batch leaves it: each graph's live edges first,
    then padding (src = dst = 0, w = 0), ``live`` of the E slots real.
    ``hub``: graph 0's first ``hub`` edges are live and all land on node 1,
    and the last graph (B > 1) is all padding.  ``offset``: h starts that
    many elements into its storage (unaligned rows)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, (B, E)).astype(np.int32)
    dst = rng.integers(0, N, (B, E)).astype(np.int32)
    w = rng.standard_normal((B, E, 2)).astype(np.float32)
    n_live = rng.integers(0, int(live * E) + 1, B)
    if hub:
        n_live[0] = max(n_live[0], hub)
        dst[0, :hub] = 1
        if B > 1:
            n_live[-1] = 0
    for b in range(B):
        src[b, n_live[b]:] = dst[b, n_live[b]:] = 0
        w[b, n_live[b]:] = 0.0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    h = t(rng.standard_normal((B, N, D)).astype(np.float32)).to(dtype)
    return _offset(h, offset), t(src), t(dst), t(w), N


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 70, 300), (64, 426, 714), (3, 40, 0),
                                   (2, 9, 50)])
@pytest.mark.parametrize("D,offset", [(64, 0), (128, 0), (40, 0), (37, 0),
                                      (64, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rgcn_spmm_dense_kernel_matches_plain(shape, D, offset, dtype):
    """K6 against its plain version: ragged sizes, phi-2's dense batch,
    E = 0, and a batch whose edges are nearly all padding at node 0; where
    E >= 100, graph 0's node 1 has an in-degree of 100 (the walk takes
    several 32-slot steps) and the last graph's edges are all padding; D =
    37 and an h that starts one element into its storage take the scalar
    layout.  A repeat gives the same bits."""
    dev = _card()
    B, N, E = shape
    h, src, dst, w, N = _k6_args(dev, B, N, E, D, getattr(torch, dtype),
                                 live=0.05 if shape == (2, 9, 50) else 0.9,
                                 hub=100 if E >= 100 else 0, offset=offset)
    before = rgcn_spmm_dense.launches
    got = rgcn_spmm_dense(h, src, dst, w, N)
    torch.cuda.synchronize()
    assert rgcn_spmm_dense.launches == before + 1
    assert got.shape == (B, N, 2 * D) and got.dtype == torch.float32
    want = rgcn_spmm_dense_plain(h, src, dst, w, N)
    if E == 0:
        assert not got.any()
    else:
        _close(got, want)
    if E >= 100:
        assert int((dst[0, :100] == 1).sum()) == 100
        assert not got[-1].any() and got[0, 1].abs().sum() > 0
    assert torch.equal(got, rgcn_spmm_dense(h, src, dst, w, N))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rgcn_message_agg_dense_on_card_matches_cpu(dtype):
    """The dense aggregation's forward (K6 + matmul) and backward (K1b over
    the flattened batch with unit norms + matmuls) on the card against the
    CPU's plain path: the output and the gradients in h, basis and w; for
    a ragged batch, one whose padded edges (src = dst = 0, w = 0, as
    pad_batch leaves them) pile up over a thousand on each graph's node
    0, whose dw are nonzero, and phi-2's first dense batch at D = 128."""
    dev = _card()
    tdt = getattr(torch, dtype)
    cases = [_k6_args(dev, 6, 90, E, 64, tdt, live=live)
             for E, live in ((200, 0.5), (1200, 0.05))]
    batch = _phi2_batches()[1]
    rng = np.random.default_rng(1)
    B, N = batch["node_mask"].shape
    w = (rng.standard_normal((*batch["edge_mask"].shape, 2))
         * batch["edge_mask"][..., None]).astype(np.float32)
    cases.append((torch.from_numpy(rng.standard_normal((B, N, 128))
                                   .astype(np.float32)).to(dev, tdt),
                  *(torch.from_numpy(a).to(dev) for a in (
                      batch["edge_src"], batch["edge_dst"], w)), N))
    for h, src, dst, w, N in cases:
        B, D = h.shape[0], h.shape[2]
        basis = torch.randn(2, D, 48, device=dev) / np.sqrt(D)
        g = torch.randn(B, N, 48, device=dev)
        res = {}
        for where in ("cuda", "cpu"):
            xs = [x.detach().to(where).requires_grad_()
                  for x in (h, basis, w)]
            out = rgcn_message_agg(xs[0], xs[1], src.to(where),
                                   dst.to(where), xs[2], N)
            res[where] = (out.detach(),
                          *torch.autograd.grad(out, xs, g.to(where)))
        for a, b in zip(res["cuda"], res["cpu"]):
            _close(a, b)
        assert res["cuda"][3][(w == 0).all(-1)].abs().sum() > 0


@pytest.mark.cuda
def test_dense_wrapper_rejects_what_the_kernel_does_not_take():
    dev = _card()
    h, src, dst, w, N = _k6_args(dev, 3, 20, 30, 32, torch.float32)
    with pytest.raises(TypeError):
        rgcn_spmm_dense(h, src.long(), dst, w, N)
    with pytest.raises(ValueError):
        rgcn_spmm_dense(h, src, dst, w.cpu(), N)
    with pytest.raises(ValueError):
        rgcn_spmm_dense(h[:, :, :16], src, dst, w, N)       # not contiguous
    with pytest.raises(ValueError):
        rgcn_spmm_dense(h, src, dst, w, N + 1)              # N disagrees
    with pytest.raises(ValueError):
        rgcn_spmm_dense(h.reshape(60, 32), src, dst, w, N)  # not (B, N, D)
    with pytest.raises(ValueError):                         # nb > 4
        rgcn_spmm_dense(h, src, dst, w.repeat(1, 1, 3).contiguous(), N)
    with pytest.raises(ValueError):                         # D > 256
        rgcn_spmm_dense(h.repeat(1, 1, 9).contiguous(), src, dst, w, N)
    with pytest.raises(IndexError):                         # dst outside [0, N)
        rgcn_spmm_dense(h, src, dst + N, w, N)
    with pytest.raises(ValueError):
        rgcn_spmm_dense(h.to("meta"), src, dst, w, N)       # no third path


@pytest.mark.cuda
def test_dense_path_on_card_matches_cpu():
    """``embed_dense`` (dense ``encode``, K6 per layer), the ablation
    encodes, and the dense loss with its gradient, full width, on the card
    against the CPU with the same draws: embeddings 1e-5, the loss 1e-5 and
    the gradient 1e-3 of its norm (a ReLU kink: see the training test)."""
    dev = _card()
    import dataclasses

    from repro_torch.core.graphs import build_kernel_graph, pad_batch
    from repro_torch.core.rgcn import RGCNConfig, encode, init_rgcn
    from repro_torch.core.train import (
        ContrastiveTrainer, dense_loss, draw_seed, draw_step,
    )
    from repro_torch.tracing.templates import make_kernel

    templates = [("gemm", {"M": 128, "N": 128, "K": 128}),
                 ("stencil", {"nx": 512, "ny": 4, "pts": 5, "iters": 8}),
                 ("reduction", {"n": 65536}),
                 ("softmax", {"rows": 64, "cols": 1000})]
    graphs = [build_kernel_graph(make_kernel(f"k{i}", *templates[i % 4], i,
                                             seed=i).trace())
              for i in range(10)]
    rc = RGCNConfig()
    enc = init_rgcn(0, rc)
    z = {where: ContrastiveTrainer(rc, device=where).embed_dense(
             enc, graphs, batch_size=4) for where in ("cpu", "cuda")}
    _close(torch.from_numpy(z["cuda"]), torch.from_numpy(z["cpu"]))
    batch, mw = pad_batch(graphs)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    abl = dataclasses.replace(rc, use_vstats=False, relations_used=(0,))
    with torch.inference_mode():
        za = [encode(enc.to(where), abl, {k: v.to(where) for k, v in
                                          tb.items()}, mw).cpu()
              for where in ("cuda", "cpu")]
    _close(*za)
    draws = draw_step(torch.Generator().manual_seed(draw_seed(0, 0)), tb, rc)
    out = {}
    for where in ("cpu", "cuda"):
        e = init_rgcn(0, rc).to(where)
        loss, _ = dense_loss(e, rc, 0.05, {k: v.to(where)
                                           for k, v in tb.items()},
                             mw, tuple(d.to(where) for d in draws))
        params = dict(e.named_parameters())
        grads = torch.autograd.grad(loss, list(params.values()))
        out[where] = (float(loss), [g.cpu() for g in grads])
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5 * abs(out["cpu"][0])
    num = sum(float(((a - b) ** 2).sum())
              for a, b in zip(out["cuda"][1], out["cpu"][1]))
    den = sum(float((b ** 2).sum()) for b in out["cpu"][1])
    assert (num / den) ** 0.5 <= 1e-3


# ---------------------------------------------------------------------------
# data parallelism: the placed sweep, a one-rank NCCL group
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_placed_sweep_on_card_is_bit_equal_to_unplaced():
    """A dispatch placed over [cuda:0, cuda:0] (two slices, each swept
    alone) gives the labels, K and scores of the unplaced dispatch."""
    from repro_torch.sampling.engine import PlanEngine

    dev = _card()
    rng = np.random.default_rng(3)
    embs = [rng.standard_normal((40 + 7 * i, 16)).astype(np.float32)
            for i in range(12)]
    kw = dict(k_max=8, iters=10, max_batch=4, data_devices=2, device=dev)
    placed = PlanEngine(devices=[dev, dev], **kw)
    got = placed.cluster_many(embs)
    want = PlanEngine(devices=[dev], **kw).cluster_many(embs)
    assert placed.engine_stats()["data_shards"] == 2
    for (la, ia), (lb, ib) in zip(got, want):
        np.testing.assert_array_equal(la, lb)
        assert ia["k"] == ib["k"] and ia.get("scores") == ib.get("scores")


@pytest.mark.cuda
def test_one_rank_nccl_fit_is_the_fit_without_a_group(tmp_path):
    """The fit over a one-rank NCCL group (gathers and the rank-order sum
    of one rank) has the bits of the fit with no group."""
    import torch.distributed as dist

    from repro_torch.core.graphs import build_kernel_graph
    from repro_torch.core.rgcn import RGCNConfig
    from repro_torch.core.train import ContrastiveTrainer, GCLTrainConfig
    from repro_torch.distributed.group import init_group
    from repro_torch.tracing.templates import make_kernel

    dev = _card()
    graphs = [build_kernel_graph(make_kernel(
        f"k{i}", "gemm", {"M": 128 * (i % 3 + 1), "N": 128, "K": 128}, i,
        seed=i).trace(cap_warps=2, cap_instr=48)) for i in range(8)]
    tc = GCLTrainConfig(steps=8, batch_size=4, scan_chunk=4, log_every=50)
    group = init_group("nccl", 0, 1, str(tmp_path / "store"))
    try:
        a, ia = ContrastiveTrainer(RGCNConfig(), tc, device=dev,
                                   group=group).fit(graphs)
    finally:
        dist.destroy_process_group()
    b, ib = ContrastiveTrainer(RGCNConfig(), tc, device=dev).fit(graphs)
    assert ia["data_shards"] == 1 and ia["collective_bytes"] > 0
    assert [h["loss"] for h in ia["history"]] == \
        [h["loss"] for h in ib["history"]]
    for (k, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), k


@pytest.mark.cuda
def test_staging_thread_uploads_through_pinned_memory_and_a_copy_stream():
    """``HostStager.put`` on a worker thread: pinned sources, copies on the
    device's copy stream behind an event; after ``take`` the compute
    stream reads the staged bits while the next batches are staged into
    memory the allocator does not hand back early: each of 16 batches'
    sums equals the sum of a plain upload of its host arrays."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.utils.device import HostStager, take

    from repro_torch.utils.device import resolve_device

    _card()
    dev = resolve_device("cuda")
    stager = HostStager(dev)
    rng = np.random.default_rng(0)
    host = [{"x": rng.standard_normal((1 << 16,)).astype(np.float32),
             "i": rng.integers(0, 1 << 20, (4096,), dtype=np.int32)}
            for _ in range(16)]
    sums = []
    with ThreadPoolExecutor(1, thread_name_prefix="stage-prefetch") as pool:
        futs = [pool.submit(stager.put, h) for h in host[:2]]
        for n in range(len(host)):
            staged = futs.pop(0).result()
            assert staged.event is not None
            with stager._lock:            # the worker appends meanwhile
                held = [src for _, src in stager._inflight]
            assert held and all(p.is_pinned() for src in held
                                for p in src.values())
            t = take(staged)
            if n + 2 < len(host):
                futs.append(pool.submit(stager.put, host[n + 2]))
            sums.append(((t["x"] * 2.0).sum(), t["i"].long().sum()))
    for (sx, si), h in zip(sums, host):
        want = (torch.from_numpy(h["x"]).to(dev) * 2.0).sum()
        assert torch.equal(sx, want)       # the same reduction on the card
        assert int(si) == int(h["i"].astype(np.int64).sum())
