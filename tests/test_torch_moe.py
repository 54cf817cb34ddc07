"""The MoE FFN of the PyTorch port (``repro_torch.models.moe``) against the
JAX package's (``repro.models.moe``), on the CPU at smoke width: the
capacity, the forward (one routing group, and routed in chunks), an expert
that overflows its capacity, the gradients, and the dispatch / combine
backwards against autograd through ``index_select``.

Weights are JAX's ``init_moe`` draws carried across as numpy; inputs come
from numpy seeds.  Tolerances: the output 1e-5 of its largest magnitude
and the aux loss 1e-6 (float32; the packages sum in other orders), each
gradient 1e-3 of its norm.  The dispatch and combine backwards equal
autograd's to 1e-6 of the largest element (a token's k slots summed in
another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_arch as j_smoke_arch
from repro.models import moe as j_moe
from repro_torch.configs import smoke_arch
from repro_torch.models import moe as t_moe

MOE = ["dbrx-132b", "grok-1-314b", "jamba-v0.1-52b"]
TOL = 1e-5
AUX_TOL = 1e-6
GRAD_TOL = 1e-3


def _close(got, want, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale, err / scale)


def _norm_close(got, want, tol=GRAD_TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    gap = float(np.linalg.norm(got - want))
    assert gap <= tol * max(float(np.linalg.norm(want)), 1e-30), (
        gap, float(np.linalg.norm(want)))


def _np(t):
    return t.detach().float().cpu().numpy()


def _carried(arch, seed=0, **kw):
    """(jax cfg, port cfg, jax params, port params) of one MoE layer."""
    jcfg = j_smoke_arch(arch).replace(**kw)
    cfg = smoke_arch(arch).replace(**kw)
    jp, _ = j_moe.init_moe(jax.random.PRNGKey(seed), jcfg)
    flat = {k: np.array(v, np.float32) for k, v in jp.items()}
    return (jcfg, cfg, {k: jnp.asarray(v) for k, v in flat.items()},
            {k: torch.from_numpy(v.copy()) for k, v in flat.items()})


def _h(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def test_capacity_matches_jax():
    """``capacity`` equals JAX's for every arch, a sweep of group sizes
    (the decode step's 1 to the serving chunk's 1024) and capacity
    factors, the rounding to a multiple of 4 above 4 included."""
    from repro.configs import get_arch as j_get_arch
    from repro_torch.configs import get_arch

    for arch in MOE:
        for factor in (1.25, 1.0, 0.5, 2.0):
            jcfg = j_get_arch(arch).replace(capacity_factor=factor)
            cfg = get_arch(arch).replace(capacity_factor=factor)
            for n in (1, 2, 3, 5, 7, 8, 13, 64, 100, 256, 1000, 1024):
                assert t_moe.capacity(cfg, n) == j_moe.capacity(jcfg, n), (
                    arch, factor, n)
    assert t_moe.capacity(get_arch("dbrx-132b"), 1024) == 320
    assert t_moe.capacity(get_arch("jamba-v0.1-52b"), 1024) == 160


@pytest.mark.parametrize("chunk", [None, 16], ids=["one-group", "chunked"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_forward_matches_jax(arch, chunk):
    """Output within 1e-5 and aux within 1e-6 of JAX's: one routing group
    (S = 40), and S = 64 routed in 4 chunks of 16 (the chunk loop and aux
    divided by the chunk count)."""
    kw = {} if chunk is None else {"moe_seq_chunk": chunk}
    jcfg, cfg, jp, tp = _carried(arch, **kw)
    h = _h(cfg, 2, 40 if chunk is None else 64, seed=1)
    jout, jaux = j_moe.moe_forward(jcfg, jp, jnp.asarray(h))
    out, aux = t_moe.moe_forward(cfg, tp, torch.from_numpy(h))
    assert out.dtype == torch.float32 and aux.dtype == torch.float32
    _close(_np(out), jout)
    _close(float(aux), float(jaux), AUX_TOL)


def _one_hot_router(cfg, experts, h_scale=4.0):
    """h (1, S, D) and a router that sends token s to ``experts[s]`` (top-1
    by a wide margin)."""
    D, E = cfg.d_model, cfg.num_experts
    router = np.zeros((D, E), np.float32)
    for e in range(E):
        router[e, e] = 1.0
    h = np.zeros((1, len(experts), D), np.float32)
    for s, e in enumerate(experts):
        h[0, s, e] = h_scale
        h[0, s, E:] = np.random.default_rng(s).standard_normal(D - E)
    return h, router


def test_moe_overflow_loses_the_slot_at_c_minus_1():
    """An expert with more than C slots: the port gives JAX's CPU result,
    in which the token kept at position C-1 gathers the sentinel's zero row
    and adds nothing.  B=1, S=6, k=1, E=2, C=2, experts [0,0,0,0,1,0]:
    token 0 is served, token 1 (kept at C-1) is lost, tokens 2, 3, 5 are
    dropped, token 4 is served by expert 1."""
    kw = dict(num_experts=2, top_k=1, capacity_factor=0.5)
    jcfg, cfg, jp, tp = _carried("dbrx-132b", **kw)
    assert t_moe.capacity(cfg, 6) == 2
    h, router = _one_hot_router(cfg, [0, 0, 0, 0, 1, 0])
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    jout, jaux = j_moe.moe_forward(jcfg, jp, jnp.asarray(h))
    out, aux = t_moe.moe_forward(cfg, tp, torch.from_numpy(h))
    jout = np.asarray(jout)
    served = np.abs(jout[0]).max(-1) > 0
    assert served.tolist() == [True, False, False, False, True, False]
    _close(_np(out), jout)
    assert np.array_equal(_np(out) == 0, jout == 0)
    _close(float(aux), float(jaux), AUX_TOL)


@pytest.mark.parametrize("arch", MOE)
def test_moe_overflow_with_a_biased_router_matches_jax(arch):
    """A router biased toward expert 0 (through feature 0) at capacity
    factor 1.0: expert 0 takes more than C slots in both batch rows, and
    the output (the tokens lost at C-1 included) and aux equal JAX's."""
    jcfg, cfg, jp, tp = _carried(arch, capacity_factor=1.0)
    router = np.array(jp["router"])
    router[0, 0] += 1.0
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    h = _h(cfg, 2, 48, seed=3)
    h[..., 0] += 1.5
    gates = jax.nn.softmax(jnp.asarray(h) @ jnp.asarray(router), axis=-1)
    _, top_e = jax.lax.top_k(gates, cfg.top_k)
    C = t_moe.capacity(cfg, 48)
    counts = np.asarray((top_e == 0).sum(axis=(1, 2)))
    assert (counts > C).all(), (counts, C)
    jout, jaux = j_moe.moe_forward(jcfg, jp, jnp.asarray(h))
    out, aux = t_moe.moe_forward(cfg, tp, torch.from_numpy(h))
    _close(_np(out), jout)
    _close(float(aux), float(jaux), AUX_TOL)


@pytest.mark.parametrize("chunk", [None, 16], ids=["one-group", "chunked"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_gradients_match_jax(arch, chunk):
    """Gradients of sum(out * ct) + aux with respect to h, router, w1, w2
    and w3 against ``jax.grad``, each within 1e-3 of its norm; the router
    at capacity factor 1.0 so that some slots are dropped."""
    kw = {"capacity_factor": 1.0}
    if chunk is not None:
        kw["moe_seq_chunk"] = chunk
    jcfg, cfg, jp, tp = _carried(arch, seed=2, **kw)
    S = 40 if chunk is None else 64
    h = _h(cfg, 2, S, seed=4)
    ct = _h(cfg, 2, S, seed=5)

    def jloss(p, x):
        out, aux = j_moe.moe_forward(jcfg, p, x)
        return jnp.sum(out * jnp.asarray(ct)) + aux

    jg_p, jg_h = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(h))
    th = torch.from_numpy(h).requires_grad_(True)
    for v in tp.values():
        v.requires_grad_(True)
    out, aux = t_moe.moe_forward(cfg, tp, th)
    loss = torch.sum(out * torch.from_numpy(ct)) + aux
    names = sorted(tp)
    grads = torch.autograd.grad(loss, [th] + [tp[n] for n in names])
    _norm_close(_np(grads[0]), jg_h)
    for n, g in zip(names, grads[1:]):
        _norm_close(_np(g), jg_p[n])


def _routing(seed, T=24, k=3, rows=40):
    """A routing as ``_moe_group`` builds it: each token's k distinct
    expert rows (``cell``), the slot each row keeps or the sentinel T*k
    (``slot``; some slots dropped: their rows keep another slot or none),
    the token each row holds or the sentinel T (``src``; a few kept slots
    lost, as at C-1 of an overflowing expert)."""
    rng = np.random.default_rng(seed)
    cell = np.stack([rng.choice(rows, k, replace=False) for _ in range(T)])
    src = np.full(rows, T)
    slot = np.full(rows, T * k)
    for t in range(T):
        for j in range(k):
            r = cell[t, j]
            if slot[r] == T * k and rng.random() < 0.8:
                slot[r] = t * k + j
                src[r] = t if rng.random() < 0.9 else T
    return (torch.from_numpy(cell), torch.from_numpy(src),
            torch.from_numpy(slot))


@pytest.mark.parametrize("seed", [0, 1])
def test_dispatch_and_combine_backwards_equal_autograd(seed):
    """The gather backwards of ``_Dispatch`` and ``_Combine`` against
    autograd through ``index_select`` (whose backward scatter-adds)."""
    cell, src, slot = _routing(seed)
    T, k = cell.shape
    rows, D = src.numel(), 8
    rng = np.random.default_rng(seed + 10)
    h = torch.from_numpy(rng.standard_normal((T, D))).float()
    ye = torch.from_numpy(rng.standard_normal((rows, D))).float()
    w = torch.from_numpy(rng.random((T, k))).float()
    kept = (slot.index_select(0, cell.reshape(-1)).reshape(T, k)
            == torch.arange(T * k).reshape(T, k))
    w = torch.where(kept, w, 0.0)
    dxe = torch.from_numpy(rng.standard_normal((rows, D))).float()
    dout = torch.from_numpy(rng.standard_normal((T, D))).float()

    a = h.clone().requires_grad_(True)
    xe = t_moe._Dispatch.apply(a, src, cell)
    (got,) = torch.autograd.grad(xe, a, dxe)
    b = h.clone().requires_grad_(True)
    table = torch.cat([b, b.new_zeros(1, D)])
    want_xe = table.index_select(0, src)
    (want,) = torch.autograd.grad(want_xe, b, dxe)
    assert torch.equal(xe, want_xe)
    _close(got.numpy(), want.numpy(), 1e-6)

    y1, w1 = ye.clone().requires_grad_(True), w.clone().requires_grad_(True)
    out = t_moe._Combine.apply(y1, w1, cell, slot)
    g_ye, g_w = torch.autograd.grad(out, (y1, w1), dout)
    y2, w2 = ye.clone().requires_grad_(True), w.clone().requires_grad_(True)
    want_out = sum(y2.index_select(0, cell[:, j]) * w2[:, j, None]
                   for j in range(k))
    want_ye, want_w = torch.autograd.grad(want_out, (y2, w2), dout)
    _close(out.detach().numpy(), want_out.detach().numpy(), 1e-6)
    _close(g_ye.numpy(), want_ye.numpy(), 1e-6)
    _close(g_w.numpy(), want_w.numpy(), 1e-6)
