"""K1-K3, K5 and K1b of the PyTorch port against the JAX package's Pallas
kernels (K1b: against ``jax.vjp`` of the fused oracle, JAX's backward).

On the CPU each port wrapper runs its kernel's plain PyTorch version; the
JAX side runs the Pallas kernel in interpret mode (as the JAX package's own
parity suite does) and its ``ref.py`` oracle.  Inputs come from a numpy
seed and are handed to both frameworks as numpy arrays.  The cases mirror
``tests/test_kernel_parity.py``: odd and non-power-of-two sizes, no edges,
a single node, masked edges, an unsorted padded edge tail, dead centroid
slots and padded points, for float32 and bfloat16 messages.

Tolerance: float32 results agree to 1e-5 relative to the largest magnitude
of the reference (``_close``); the two sides sum in different orders, so
bit equality is not expected.  Silhouette sums add one absolute term: the
distance of a point to itself (and to any coincident point) comes out of
sqrt(|x|^2 - 2 x.y + |y|^2), whose float32 cancellation leaves up to
sqrt(3 d eps max|x|^2) of noise in each implementation (the worst-case
error of a length-d float32 dot product is d eps |x|^2).  Labels are
compared exactly, on separated data (``_blobs``) so that no point sits on a
near-tie between centroids.

``tests/test_torch_cuda.py`` holds each CUDA kernel against its plain
version on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.kmeans_assign.ops import (
    kmeans_assign_fused as jax_kmeans_fused,
    silhouette_sums as jax_sil_sums,
)
from repro.kernels.kmeans_assign.ref import (
    kmeans_assign_fused_ref, silhouette_sums_ref,
)
from repro.kernels.rgcn_fused.ops import rgcn_fused_agg_flat as jax_fused
from repro.kernels.rgcn_fused.ref import rgcn_fused_agg_flat_ref
from repro.kernels.rgcn_spmm.kernel import rgcn_spmm_flat_fwd
from repro.kernels.rgcn_spmm.ops import (
    rgcn_message_agg_flat as jax_message_agg_flat,
)
from repro.kernels.rgcn_spmm.ref import rgcn_message_agg_flat_ref
from repro_torch.kernels import route
from repro_torch.kernels.kmeans_assign.ops import (
    kmeans_assign_fused, silhouette_sums,
)
from repro_torch.kernels.rgcn_fused.ops import (
    rgcn_fused_agg_flat, rgcn_fused_bwd,
)
from repro_torch.kernels.rgcn_spmm.ops import (
    rgcn_message_agg_flat, rgcn_spmm_flat,
)

RTOL = 1e-5


def _close(got, want, rtol=RTOL, atol=0.0):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale + atol)


def _cancellation_floor(x):
    """Noise of one sqrt(|x|^2 - 2 x.y + |y|^2) at (near-)zero distance."""
    d = x.shape[1]
    eps = float(np.finfo(np.float32).eps)
    return float(np.sqrt(3 * d * eps * float((x * x).sum(1).max())))


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(dtype) if dtype is not None else t


# ---------------------------------------------------------------------------
# K1 rgcn_fused
# ---------------------------------------------------------------------------

# (case id, P, D, Q, nb, O, extra): extra in {"", "masked", "unsorted_tail"}
K1_CASES = [
    ("odd", 33, 8, 7, 2, 8, ""),
    ("non_pow2", 100, 16, 257, 3, 24, ""),
    ("single_node", 1, 4, 3, 2, 6, ""),
    ("one_block", 65, 8, 256, 2, 8, ""),
    ("no_edges", 8, 4, 0, 2, 6, ""),
    ("masked_edges", 16, 8, 20, 2, 8, "masked"),
    ("unsorted_padded_tail", 40, 16, 50, 2, 12, "unsorted_tail"),
]


def _k1_inputs(seed, P, D, Q, nb, O, extra):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((P, D)).astype(np.float32)
    basis = (rng.standard_normal((nb, D, O)) / np.sqrt(D)).astype(np.float32)
    src = rng.integers(0, P, Q).astype(np.int32)
    dst = rng.integers(0, P, Q).astype(np.int32)
    coef = rng.standard_normal((Q, nb)).astype(np.float32)
    wnorm = rng.random(Q).astype(np.float32)
    wnorm[wnorm < 0.25] = 0.0
    if extra == "unsorted_tail":
        # pack_graphs' layout: a dst-sorted used prefix, then a padded tail
        # with dst=0, wnorm=0 — here shuffled so no order may be assumed
        order = np.argsort(dst[:30], kind="stable")
        src[:30], dst[:30] = src[:30][order], dst[:30][order]
        dst[30:], wnorm[30:] = 0, 0.0
        perm = rng.permutation(Q)
        src, dst, coef, wnorm = src[perm], dst[perm], coef[perm], wnorm[perm]
    if extra == "masked":
        pad = 13
        src = np.concatenate([src, np.zeros(pad, np.int32)])
        dst = np.concatenate([dst, np.zeros(pad, np.int32)])
        coef = np.concatenate([coef, np.ones((pad, nb), np.float32)])
        wnorm = np.concatenate([wnorm, np.zeros(pad, np.float32)])
    return h, basis, src, dst, coef, wnorm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", K1_CASES, ids=[c[0] for c in K1_CASES])
def test_rgcn_fused_plain_matches_jax(case, dtype):
    """Port K1 (plain, CPU) vs the JAX Pallas kernel (interpret) and its
    oracle; bf16 h is the same bf16 values on both sides, every product
    after the gather is f32, so the f32 tolerance holds for both dtypes."""
    _, P, D, Q, nb, O, extra = case
    h, basis, src, dst, coef, wnorm = _k1_inputs(P * 7 + Q, P, D, Q, nb, O,
                                                 extra)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    got = rgcn_fused_agg_flat(_t(h, tdt), _t(basis), _t(src), _t(dst),
                              _t(coef), _t(wnorm), P)
    assert got.shape == (P, O) and got.dtype == torch.float32
    args = (jnp.asarray(h, jdt), jnp.asarray(basis), jnp.asarray(src),
            jnp.asarray(dst), jnp.asarray(coef), jnp.asarray(wnorm))
    want_ref = rgcn_fused_agg_flat_ref(*args, P)
    _close(got.numpy(), want_ref)
    if Q:
        _close(got.numpy(), jax_fused(*args, P, True))
    else:
        assert not got.numpy().any()
    if extra == "masked":
        # the wnorm = 0 padding rows are no-ops
        base = rgcn_fused_agg_flat(_t(h, tdt), _t(basis), _t(src[:-13]),
                                   _t(dst[:-13]), _t(coef[:-13]),
                                   _t(wnorm[:-13]), P)
        _close(got.numpy(), base.numpy())


# ---------------------------------------------------------------------------
# K5 rgcn_spmm (flat) and K1b, the backward of K1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", K1_CASES, ids=[c[0] for c in K1_CASES])
def test_rgcn_spmm_flat_plain_matches_jax(case, dtype):
    """Port K5 (plain, CPU) vs the JAX Pallas kernel (interpret) and the
    flat oracle's pre-basis sum, within 1e-6 of the largest |s|; the
    unfused layer (K5 + matmul) vs ``rgcn_message_agg_flat_ref``."""
    _, P, D, Q, nb, O, extra = case
    h, basis, src, dst, coef, wnorm = _k1_inputs(P * 5 + Q, P, D, Q, nb, O,
                                                 extra)
    w = (coef * wnorm[:, None]).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    got = rgcn_spmm_flat(_t(h, tdt), _t(src), _t(dst), _t(w), P)
    assert got.shape == (P, nb * D) and got.dtype == torch.float32
    jh = jnp.asarray(h, jdt)
    j_src, j_dst, j_w = jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)
    want = jax.ops.segment_sum(
        jnp.take(jh, j_src, axis=0)[:, None, :] * j_w[..., None], j_dst,
        num_segments=P).reshape(P, nb * D)
    _close(got.numpy(), want, rtol=1e-6)
    _close(got.numpy(), rgcn_spmm_flat_fwd(jh, j_src, j_dst, j_w,
                                           num_nodes=P, interpret=True),
           rtol=1e-6)
    agg = rgcn_message_agg_flat(_t(h, tdt), _t(basis), _t(src), _t(dst),
                                _t(w), P)
    _close(agg.detach().numpy(),
           rgcn_message_agg_flat_ref(jh, jnp.asarray(basis), j_src, j_dst,
                                     j_w, P))


def _vjp_inputs(case, seed):
    _, P, D, Q, nb, O, extra = case
    h, basis, src, dst, coef, wnorm = _k1_inputs(seed, P, D, Q, nb, O, extra)
    g = np.random.default_rng(seed + 1).standard_normal((P, O)).astype(
        np.float32)
    return P, h, basis, src, dst, coef, wnorm, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", K1_CASES, ids=[c[0] for c in K1_CASES])
def test_rgcn_fused_backward_plain_matches_jax_vjp(case, dtype):
    """The port's K1 backward on the CPU (K5 plain + K1b plain + the two
    matmuls, through autograd) vs ``jax.vjp`` of the fused oracle, JAX's
    own backward: dh, dbasis and dcoef within 1e-5 (float32 h) or 3e-2
    (bfloat16 h: JAX scatters the per-edge cotangents of h in bfloat16,
    the port sums them in float32 and rounds once) of the largest value."""
    P, h, basis, src, dst, coef, wnorm, g = _vjp_inputs(case, 11 + case[1])
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    th = _t(h, tdt).requires_grad_()
    tb, tc = _t(basis).requires_grad_(), _t(coef).requires_grad_()
    out = rgcn_fused_agg_flat(th, tb, _t(src), _t(dst), tc, _t(wnorm), P)
    dh, dbasis, dcoef = torch.autograd.grad(out, (th, tb, tc), _t(g),
                                            allow_unused=True)
    j_src, j_dst, j_w = jnp.asarray(src), jnp.asarray(dst), jnp.asarray(wnorm)
    _, vjp = jax.vjp(
        lambda h_, b_, c_: rgcn_fused_agg_flat_ref(h_, b_, j_src, j_dst, c_,
                                                   j_w, P),
        jnp.asarray(h, jdt), jnp.asarray(basis), jnp.asarray(coef))
    want = vjp(jnp.asarray(g))
    assert dh.dtype == tdt
    rtol = 1e-5 if dtype == "float32" else 3e-2
    for got_, want_ in zip((dh, dbasis, dcoef), want):
        _close(got_.float().numpy(), np.asarray(want_, np.float32), rtol=rtol)
    if case[-1] == "masked":
        assert not dcoef[-13:].any()                    # wnorm = 0 rows


@pytest.mark.parametrize("case", K1_CASES[:4], ids=[c[0] for c in K1_CASES[:4]])
def test_message_agg_backward_plain_matches_jax(case):
    """The unfused layer's backward (K1b with the weights as coefficients
    and unit norms) vs the JAX package's ``rgcn_message_agg_flat`` vjp."""
    P, h, basis, src, dst, coef, wnorm, g = _vjp_inputs(case, 3 + case[1])
    w = (coef * wnorm[:, None]).astype(np.float32)
    th, tb, tw = (_t(a).requires_grad_() for a in (h, basis, w))
    out = rgcn_message_agg_flat(th, tb, _t(src), _t(dst), tw, P)
    got = torch.autograd.grad(out, (th, tb, tw), _t(g))
    _, vjp = jax.vjp(
        lambda h_, b_, w_: jax_message_agg_flat(
            h_, b_, jnp.asarray(src), jnp.asarray(dst), w_, P, True),
        jnp.asarray(h), jnp.asarray(basis), jnp.asarray(w))
    for got_, want_ in zip(got, vjp(jnp.asarray(g))):
        _close(got_.numpy(), want_)


def test_rgcn_fused_bwd_plain_direct():
    """K1b's plain version on its own: dh and dcoef from t, against the
    formulas written out edge by edge in numpy (float64)."""
    rng = np.random.default_rng(5)
    P, D, Q, nb = 9, 6, 20, 2
    h = rng.standard_normal((P, D)).astype(np.float32)
    t = rng.standard_normal((P, nb * D)).astype(np.float32)
    src = rng.integers(0, P, Q).astype(np.int32)
    dst = rng.integers(0, P, Q).astype(np.int32)
    coef = rng.standard_normal((Q, nb)).astype(np.float32)
    wnorm = rng.random(Q).astype(np.float32)
    dh, dcoef = rgcn_fused_bwd(_t(h), _t(t), _t(src), _t(dst), _t(coef),
                               _t(wnorm), P)
    t3 = t.reshape(P, nb, D).astype(np.float64)
    want_dh = np.zeros((P, D))
    want_dc = np.zeros((Q, nb))
    for e in range(Q):
        w = coef[e].astype(np.float64) * wnorm[e]
        want_dh[src[e]] += (w[:, None] * t3[dst[e]]).sum(0)
        want_dc[e] = wnorm[e] * (t3[dst[e]] @ h[src[e]].astype(np.float64))
    _close(dh.numpy(), want_dh)
    _close(dcoef.numpy(), want_dc)


# ---------------------------------------------------------------------------
# K2 kmeans_assign_fused, K3 silhouette_sums
# ---------------------------------------------------------------------------

def _blobs(seed, n, d, k, spread=6.0):
    """k well-separated clusters: centroids far apart, unit noise."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)).astype(np.float32) * spread
    lab = rng.integers(0, k, n)
    x = centers[lab] + rng.standard_normal((n, d)).astype(np.float32)
    cent = centers + 0.1 * rng.standard_normal((k, d)).astype(np.float32)
    return x.astype(np.float32), cent.astype(np.float32), lab


# (case id, n, d, k, block_n, dead slots, padded points)
K2_CASES = [
    ("plain", 100, 16, 4, 32, 0, 0),
    ("dead_and_padded", 257, 24, 6, 128, 2, 17),
    ("single_block", 64, 8, 3, 64, 1, 5),
    ("n_below_block", 7, 8, 5, 64, 0, 3),
    ("single_point", 1, 7, 3, 512, 0, 0),
    ("main_path_k", 300, 32, 48, 128, 20, 44),
]


@pytest.mark.parametrize("case", K2_CASES, ids=[c[0] for c in K2_CASES])
def test_kmeans_assign_fused_plain_matches_jax(case):
    """Port K2 (plain, CPU) vs the JAX Pallas kernel (interpret) and its
    oracle: labels exact, distances / sums / counts at 1e-5."""
    _, n, d, k, block_n, dead, pad = case
    x, cent, _ = _blobs(n + d, n, d, k)
    cmask = (np.arange(k) < k - dead).astype(np.float32)
    pmask = (np.arange(n) < n - pad).astype(np.float32)
    got = kmeans_assign_fused(_t(x), _t(cent), _t(cmask), _t(pmask))
    args = tuple(jnp.asarray(a) for a in (x, cent, cmask, pmask))
    for want in (jax_kmeans_fused(*args, block_n=block_n, interpret=True),
                 kmeans_assign_fused_ref(*args)):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        for g, w in zip(got[1:], want[1:]):
            _close(g.numpy(), w)
    assert got[0].dtype == torch.int32
    assert float(got[3].sum()) == pytest.approx(n - pad)
    if dead:
        assert int(got[0].max()) < k - dead


# (case id, n, k, d, block_n, masked rows)
K3_CASES = [
    ("blocks", 96, 4, 16, 32, 3),
    ("non_pow2", 200, 6, 8, 128, 3),
    ("odd", 33, 3, 12, 64, 3),
    ("main_path_k", 150, 48, 32, 64, 40),
]


@pytest.mark.parametrize("case", K3_CASES, ids=[c[0] for c in K3_CASES])
def test_silhouette_sums_plain_matches_jax(case):
    """Port K3 (plain, CPU) vs the JAX Pallas kernel (interpret) and the
    full-matrix oracle, with point-masked one-hot rows."""
    _, n, k, d, block_n, masked = case
    x, _, lab = _blobs(n * 3 + k, n, d, k)
    mask = (np.arange(n) < n - masked).astype(np.float32)
    onehot = (np.eye(k, dtype=np.float32)[lab] * mask[:, None])
    got = silhouette_sums(_t(x), _t(onehot))
    args = (jnp.asarray(x), jnp.asarray(onehot))
    floor = 2 * _cancellation_floor(x)      # one self term on each side
    _close(got.numpy(), silhouette_sums_ref(*args), atol=floor)
    _close(got.numpy(), jax_sil_sums(*args, block_n=block_n, interpret=True),
           atol=floor)


def test_wrappers_route_cpu_to_plain_and_refuse_other_devices():
    """A CPU tensor takes the plain version (no launch is counted); a tensor
    on any other non-CUDA device raises instead of being served."""
    x, cent, _ = _blobs(0, 20, 8, 3)
    before = (kmeans_assign_fused.launches, silhouette_sums.launches,
              rgcn_fused_agg_flat.launches, rgcn_spmm_flat.launches,
              rgcn_fused_bwd.launches)
    kmeans_assign_fused(_t(x), _t(cent), torch.ones(3), torch.ones(20))
    silhouette_sums(_t(x), torch.ones(20, 3))
    rgcn_spmm_flat(_t(x), torch.zeros(2, dtype=torch.int32),
                   torch.ones(2, dtype=torch.int32), torch.ones(2, 2), 20)
    assert (kmeans_assign_fused.launches, silhouette_sums.launches,
            rgcn_fused_agg_flat.launches, rgcn_spmm_flat.launches,
            rgcn_fused_bwd.launches) == before
    assert route(torch.empty(2)) == "cpu"
    with pytest.raises(ValueError):
        route(torch.empty(2, device="meta"))
