"""The port's CUDA kernels on the card (``cuda`` marker).

Each hand-written kernel against its plain PyTorch version on the same
CUDA tensors, at sizes that are not multiples of the kernels' tiles; the
wrappers' input checks; one program served end to end on the card against
the same program served on the CPU; and one training step on the card
against the same step on the CPU, with the same draws.  This file imports no JAX (the
machine with the card has none).  Without a card every test skips with a
reason, decided inside the test.

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance: 1e-5 of the largest magnitude (the kernel and the plain version
sum in different orders); labels exactly, on separated data.  A training
step: the loss 1e-5, every parameter 1e-4 (the backward sums in other
orders, and Adam divides by sqrt(v), which magnifies that noise where a
gradient is small).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.kmeans_assign.ops import (
    kmeans_assign_fused, kmeans_assign_fused_plain, silhouette_sums,
    silhouette_sums_plain,
)
from repro_torch.kernels.rgcn_fused.ops import (
    rgcn_fused_agg_flat, rgcn_fused_agg_flat_plain, rgcn_fused_bwd,
    rgcn_fused_bwd_plain,
)
from repro_torch.kernels.rgcn_spmm.ops import (
    rgcn_spmm_flat, rgcn_spmm_flat_plain,
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


def _k1_args(dev, P, D, Q, O, dtype, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, P, Q).astype(np.int32)
    dst = rng.integers(0, P, Q).astype(np.int32)
    wnorm = rng.random(Q).astype(np.float32)
    dst[Q // 2:], wnorm[Q // 2:] = 0, 0.0         # padded tail ...
    perm = rng.permutation(Q)                     # ... in no order
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    h = t(rng.standard_normal((P, D)).astype(np.float32)).to(dtype)
    basis = t((rng.standard_normal((2, D, O)) / np.sqrt(D)).astype(np.float32))
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


@pytest.mark.cuda
@pytest.mark.parametrize("D,O", [(64, 128), (128, 256), (40, 24)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rgcn_fused_kernel_matches_plain(D, O, dtype):
    dev = _card()
    args = _k1_args(dev, 700, D, 1500, O, getattr(torch, dtype))
    before = rgcn_fused_agg_flat.launches
    got = rgcn_fused_agg_flat(*args)
    torch.cuda.synchronize()
    assert rgcn_fused_agg_flat.launches == before + 1
    _close(got, rgcn_fused_agg_flat_plain(*args))
    again = rgcn_fused_agg_flat(*args)
    assert torch.equal(got, again)                # deterministic


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
            assert svc.stats()["errors"] == 0
    assert plans["cuda"].num_clusters == plans["cpu"].num_clusters
    assert plans["cuda"].rep_indices() == plans["cpu"].rep_indices()
    assert np.array_equal(plans["cuda"].labels, plans["cpu"].labels)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rgcn_spmm_kernel_matches_plain(D, dtype):
    dev = _card()
    h, _, src, dst, coef, wnorm, P = _k1_args(dev, 700, D, 1500, 8,
                                              getattr(torch, dtype))
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
@pytest.mark.parametrize("D", [64, 128, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rgcn_fused_bwd_kernel_matches_plain(D, dtype):
    """K1b against its plain version, and K1's whole backward on the card
    (K5 + K1b + the matmuls) against the same backward on the CPU."""
    dev = _card()
    tdt = getattr(torch, dtype)
    h, basis, src, dst, coef, wnorm, P = _k1_args(dev, 700, D, 1500, 96,
                                                  tdt)
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

    g = torch.randn(P, 96, device=dev)
    grads = {}
    for where in ("cuda", "cpu"):
        xs = [x.detach().to(where).requires_grad_() for x in (h, basis, coef)]
        out = rgcn_fused_agg_flat(xs[0], xs[1], src.to(where), dst.to(where),
                                  xs[2], wnorm.to(where), P)
        grads[where] = torch.autograd.grad(out, xs, g.to(where))
    for a, b in zip(grads["cuda"], grads["cpu"]):
        _close(a, b)


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
        mu, nu = adamw_init(params)
        m = train_step(enc, rc, tc.tau, tc.opt, b, d, mu, nu, 0)
        out[str(where)] = (m.cpu(), dict(zip(params, grads)),
                           {k: p.detach().cpu() for k, p in params.items()})
    (m_cpu, g_cpu, p_cpu), (m_card, g_card, p_card) = out["cpu"], out[str(dev)]
    assert abs(float(m_card[0] - m_cpu[0])) <= 1e-5 * abs(float(m_cpu[0]))

    def gap(a, b):
        num = sum(float(((a[k].cpu() - b[k]) ** 2).sum()) for k in b)
        return (num / sum(float((v ** 2).sum()) for v in b.values())) ** 0.5

    assert gap(g_card, g_cpu) <= 1e-3
    assert gap(p_card, p_cpu) <= 1e-4
