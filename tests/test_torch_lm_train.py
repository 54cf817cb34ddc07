"""LM training of the PyTorch port against the JAX package, on the CPU:
K7b's plain version and autograd through the port's ``flash_attention``
against ``jax.vjp(attention_ref)``; K8b's plain version and autograd
through the port's ``ssd_scan`` against ``jax.vjp(ssd_ref)``;
``chunked_cross_entropy``; ``lm_loss`` and its gradients; three steps of
``make_train_step`` under each of JAX's optimizer options (and mamba's);
the train CLI's lines and its checkpoint resume; and the rules that keep a
gradient on the card from bypassing a kernel.

The port runs on CPU tensors, so every kernel wrapper takes its plain
version.  Inputs come from numpy seeds; the model tests carry JAX
``init_params`` weights into the port through ``lm_params_from_jax`` (the
constant leaves perturbed so that a misplaced one shows).

Tolerances: float32 1e-5 of the largest magnitude (the packages sum in
other orders); bfloat16 attention gradients 3e-2 (JAX's oracle rounds the
scores, P, dP and dS to bfloat16, the port's float32 recompute rounds only
its outputs); a gradient leaf 1e-3 of its norm and a parameter leaf after
three steps 1e-4 of its norm (Adam divides by sqrt(v), which magnifies
summation-order noise where a gradient is small), a bfloat16 moment 2^-8
of its norm (one bfloat16 rounding).  The SSD scan's dA 1e-4 of its
largest element: dA sums dt times the reverse cumsum of dcum over the
batch and the sequence, whose terms cancel, so each package's float32 dA
strays from a float64 evaluation of the same gradient by more than 1e-5
of its largest element; the test holds both packages' dA to that float64
evaluation at the same 1e-4.
"""

import gc
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.configs import smoke_arch as j_smoke_arch
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.ssd_scan.ref import ssd_ref
from repro.launch import steps as j_steps
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import layers as j_layers
from repro.models import transformer as j_tf
from repro.optim import adamw_init as j_adamw_init
from repro.sampling.store import flatten_tree, unflatten_tree
from repro_torch.config import TrainConfig
from repro_torch.configs import smoke_arch
from repro_torch.data import TokenStream
from repro_torch.interop import lm_params_from_jax
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import train as train_mod
from repro_torch.launch import steps as t_steps
from repro_torch.launch.steps import make_train_step
from repro_torch.models import layers as t_layers
from repro_torch.models import transformer as t_tf
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import tree_leaves

TOL = 1e-5
BF16_TOL = 3e-2
DA_TOL = 1e-4
PERTURB = ("scale", "norm", "dt_bias", "D_skip", "bq", "bk", "bv")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one intra-op thread: several test processes on one host
    slow down by oversubscribing the cores with spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale, err / scale)


def _norm_close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    gap = float(np.linalg.norm(got - want))
    assert gap <= tol * max(float(np.linalg.norm(want)), 1e-30), (
        gap, float(np.linalg.norm(want)))


def _np(t):
    return t.detach().float().cpu().numpy()


def _carried(arch, seed=0, **kw):
    """(jax cfg, port cfg, jax params, port params): JAX init_params with
    the constant leaves perturbed, carried across as numpy."""
    jcfg = j_smoke_arch(arch).replace(**kw)
    cfg = smoke_arch(arch).replace(**kw)
    jparams, _ = j_tf.init_params(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)
    flat = {}
    for key, arr in flatten_tree(jparams).items():
        arr = np.asarray(arr, np.float32)
        if key.rsplit("/", 1)[-1] in PERTURB:
            arr = (arr + 0.1 * rng.standard_normal(arr.shape)).astype(
                np.float32)
        flat[key] = arr
    jparams = jax.tree_util.tree_map(jnp.asarray, unflatten_tree(flat))
    return jcfg, cfg, jparams, lm_params_from_jax(flat, cfg)


def _batches(cfg, n, B=2, S=64, seed=0):
    ds = TokenStream(cfg.vocab_size, S, B, seed=seed, frontend=cfg.frontend,
                     d_model=cfg.d_model, frontend_tokens=cfg.frontend_tokens)
    return [ds.next() for _ in range(n)]


# ---------------------------------------------------------------------------
# K7b: the flash-attention backward
# ---------------------------------------------------------------------------

ATTN_CASES = [(1, 64, 2, 1, 16), (2, 100, 2, 3, 32), (1, 512, 1, 4, 64),
              (2, 96, 2, 2, 128)]


def _attn_inputs(shape, dtype, seed):
    B, S, K, G, hd = shape
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((B, S, K, G, hd), (B, S, K, hd), (B, S, K, hd),
                             (B, S, K, G, hd)))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    jx = tuple(jnp.asarray(a).astype(jdt) for a in (q, k, v, do))
    tx = tuple(torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    return jx, tx, hd ** -0.5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ATTN_CASES)
def test_flash_attention_bwd_matches_jax_vjp(shape, dtype):
    """``flash_attention_bwd_plain`` (with JAX's forward output) and
    autograd through the port's ``flash_attention`` give the dq, dk, dv of
    ``jax.vjp(attention_ref)``: 1e-5 in float32, 3e-2 in bfloat16."""
    (jq, jk, jv, jdo), (q, k, v, do), scale = _attn_inputs(
        shape, dtype, sum(shape))
    jout, vjp = jax.vjp(lambda a, b, c: attention_ref(a, b, c, scale),
                        jq, jk, jv)
    want = vjp(jdo)
    tol = TOL if dtype == "float32" else BF16_TOL
    out = torch.from_numpy(np.array(jout.astype(jnp.float32))).to(q.dtype)
    plain = fa_ops.flash_attention_bwd_plain(q, k, v, out, do, scale)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    auto = torch.autograd.grad(fa_ops.flash_attention(*leaves, scale),
                               leaves, do)
    for got_p, got_a, w in zip(plain, auto, want):
        assert got_p.dtype == q.dtype and got_a.dtype == q.dtype
        w = np.asarray(w.astype(jnp.float32))
        _close(_np(got_p), w, tol)
        _close(_np(got_a), w, tol)


@pytest.mark.parametrize("requires_grad", [False, True])
def test_flash_attention_autograd_path_on_the_cpu(requires_grad):
    """A tensor that requires a gradient reaches the autograd function (its
    backward is ``flash_attention_bwd``, the plain version on the CPU from
    the forward's saved log-sum-exp, bit for bit); one that does not, or
    one under ``no_grad``, takes the plain forward with no graph.  Neither
    launches anything on the CPU."""
    (_, _, _, _), (q, k, v, do), scale = _attn_inputs((2, 64, 2, 3, 16),
                                                      "float32", 3)
    launches = (fa_ops.flash_attention.launches,
                fa_ops.flash_attention_bwd.launches)
    leaves = [t.requires_grad_(requires_grad) for t in (q, k, v)]
    out = fa_ops.flash_attention(*leaves, scale)
    assert torch.equal(out.detach(),
                       fa_ops.flash_attention_plain(q, k, v, scale))
    if requires_grad:
        assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
        got = torch.autograd.grad(out, leaves, do)
        _, lse = fa_ops.flash_attention_lse(q.detach(), k.detach(),
                                            v.detach(), scale)
        want = fa_ops.flash_attention_bwd_plain(q, k, v, out.detach(), do,
                                                scale, lse)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        with torch.no_grad():
            assert fa_ops.flash_attention(*leaves, scale).grad_fn is None
    else:
        assert out.grad_fn is None
    assert (fa_ops.flash_attention.launches,
            fa_ops.flash_attention_bwd.launches) == launches


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ATTN_CASES)
def test_saved_lse_and_the_backward_from_it_match(shape, dtype):
    """The log-sum-exp ``_FlashAttention`` saves for its backward is
    ``torch.logsumexp`` of the scaled causal scores (float64 of the same
    inputs, 1e-5 of the largest), and ``flash_attention_bwd`` from it gives
    the dq, dk, dv of ``jax.vjp(attention_ref)``: 1e-5 in float32, 3e-2 in
    bfloat16."""
    B, S, K, G, hd = shape
    (jq, jk, jv, jdo), (q, k, v, do), scale = _attn_inputs(
        shape, dtype, sum(shape) + 1)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa_ops.flash_attention(*leaves, scale)
    lse = out.grad_fn.saved_tensors[4]
    assert lse.dtype == torch.float32 and lse.shape == (B, K, G, S)
    sc = torch.einsum("bqkgh,bskh->bkgqs", q.double(), k.double()) * scale
    causal = torch.ones(S, S, dtype=torch.bool).tril()
    want_lse = torch.logsumexp(sc.masked_fill(~causal, -torch.inf), dim=-1)
    _close(lse.numpy(), want_lse.numpy())
    _, vjp = jax.vjp(lambda a, b, c: attention_ref(a, b, c, scale),
                     jq, jk, jv)
    got = fa_ops.flash_attention_bwd(q, k, v, out.detach(), do, scale, lse)
    tol = TOL if dtype == "float32" else BF16_TOL
    for g, w in zip(got, vjp(jdo)):
        assert g.dtype == q.dtype
        _close(_np(g), np.asarray(w.astype(jnp.float32)), tol)


def _float32_allocations(monkeypatch, fn):
    """The shapes of the float32 tensors ``torch.empty`` makes during
    ``fn()``."""
    made, real = [], torch.empty

    def empty(*a, **kw):
        t = real(*a, **kw)
        if t.dtype == torch.float32:
            made.append(tuple(t.shape))
        return t

    monkeypatch.setattr(torch, "empty", empty)
    try:
        fn()
    finally:
        monkeypatch.setattr(torch, "empty", real)
    return made


def _as_if_on_the_card(monkeypatch, mod):
    """Send ``mod``'s CPU tensors down the CUDA branch (its checks, its
    allocations), recording the launches instead of making them."""
    launched = []
    monkeypatch.setattr(mod, "route", lambda t: "cuda")
    monkeypatch.setattr(mod, "launch",
                        lambda name, *args: launched.append(name))
    return launched


@pytest.mark.parametrize("dtype,hd", [("bfloat16", 64), ("bfloat16", 128),
                                      ("bfloat16", 32), ("bfloat16", 256),
                                      ("float32", 64)])
def test_flash_attention_meta_branches_allocate_what_the_card_does(
        monkeypatch, dtype, hd):
    """K7's forward with the log-sum-exp and K7b's backward allocate, on
    ``meta`` tensors (the dry run), the float32 tensors their CUDA branches
    allocate: the saved (B,K,G,S) log-sum-exp; D per row on the wgmma route,
    each row's log-sum-exp and D on the others
    (``flash_attention_bwd_scratch``)."""
    B, S, K, G = 2, 100, 2, 3
    dt = getattr(torch, dtype)
    q = torch.zeros(B, S, K, G, hd, dtype=dt)
    k = torch.zeros(B, S, K, hd, dtype=dt)
    lse = torch.zeros(B, K, G, S)
    mq, mk, ml = (t.to("meta") for t in (q, k, lse))

    def fwd(q, k):
        return lambda: fa_ops.flash_attention_lse(q, k, k, 0.5)

    def bwd(q, k, lse):
        return lambda: fa_ops.flash_attention_bwd(q, k, k, q, q, 0.5, lse)

    want_f = _float32_allocations(monkeypatch, fwd(mq, mk))
    want_b = _float32_allocations(monkeypatch, bwd(mq, mk, ml))
    launched = _as_if_on_the_card(monkeypatch, fa_ops)
    got_f = _float32_allocations(monkeypatch, fwd(q, k))
    got_b = _float32_allocations(monkeypatch, bwd(q, k, lse))
    assert launched == ["flash_attention", "flash_attention_bwd"]
    rows = B * K * G * S
    assert got_f == want_f == [(B, K, G, S)]
    assert got_b == want_b == [
        (fa_ops.flash_attention_bwd_scratch(B, S, K, G, hd, dt),)]
    assert want_b[0][0] == (rows if fa_ops.bwd_route(dt, hd) == "wgmma"
                            else 2 * rows)


@pytest.mark.parametrize("shape", [(1, 1, 256, 3, 16, 128),
                                   (1, 1, 256, 8, 16, 128),
                                   (2, 2, 100, 5, 9, 13),
                                   (2, 3, 48, 8, 24, 40)])
def test_ssd_bwd_meta_branch_allocates_what_the_card_does(monkeypatch,
                                                          shape):
    """K8b's workspace on ``meta`` tensors (the dry run) is the one its CUDA
    branch allocates (``ssd_intra_chunk_bwd_scratch``: CB, the head groups'
    dCB partials, the per-tile dcum / ddt partials, sd, the groups' dB
    state partials); (1, 1, 256, 3, 16, 128) and (1, 1, 256, 8, 16, 128)
    counted out by hand."""
    B, nc, Q, nh, hp, ds = shape
    args = (torch.zeros(B, nc, Q, nh, hp), torch.zeros(B, nc, nh, Q),
            torch.zeros(B, nc, nh, Q), torch.zeros(B, nc, Q, ds),
            torch.zeros(B, nc, Q, ds), torch.zeros(B, nc, Q, nh, hp),
            torch.zeros(B, nc, nh, hp, ds))
    meta = [t.to("meta") for t in args]
    want = _float32_allocations(
        monkeypatch, lambda: ssd_ops.ssd_intra_chunk_bwd(*meta))
    launched = _as_if_on_the_card(monkeypatch, ssd_ops)
    got = _float32_allocations(
        monkeypatch, lambda: ssd_ops.ssd_intra_chunk_bwd(*args))
    assert launched == ["ssd_intra_chunk_bwd"]
    n = ssd_ops.ssd_intra_chunk_bwd_scratch(*shape)
    assert got[0] == want[0] == (n,)
    if shape == (1, 1, 256, 3, 16, 128):
        # QP 256, T 4, 3 heads: CB + 3 dCB partials, 3 x 4 tiles + sd of 3
        # heads, 3 state partials of 256 x 128
        assert n == 4 * 256 * 256 + 13 * 3 * 256 + 3 * 256 * 128
    if shape == (1, 1, 256, 8, 16, 128):
        # 8 heads: 3 dCB groups, 6 state groups
        assert n == 4 * 256 * 256 + 13 * 8 * 256 + 6 * 256 * 128


def test_flash_attention_bwd_refuses_bad_shapes():
    (_, _, _, _), (q, k, v, do), scale = _attn_inputs((1, 64, 2, 1, 16),
                                                      "float32", 0)
    with pytest.raises(ValueError, match="dout"):
        fa_ops.flash_attention_bwd(q, k, v, q, do[:, :32], scale)
    with pytest.raises(ValueError, match="out"):
        fa_ops.flash_attention_bwd(q, k, v, q.bfloat16(), do, scale)


# ---------------------------------------------------------------------------
# K8b: the SSD intra-chunk backward
# ---------------------------------------------------------------------------

#: (B, S, nh, hp, ds, chunk): four chunks; one chunk (Q = S); two ragged
#: chunks of 100 rows, no multiple of 64
SSD_CASES = [(2, 64, 3, 8, 5, 16), (1, 40, 2, 4, 3, 64),
             (2, 200, 3, 6, 7, 100)]


def _ssd_inputs(shape, seed):
    """(x, dt, A, Bc, Cc) as the mixer makes them, dy and a nonzero
    d(final_state), float32 numpy."""
    B, S, nh, hp, ds, _ = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, nh, hp)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, nh)) - 1.0)).astype(
        np.float32)
    A = -np.linspace(1.0, 4.0, nh).astype(np.float32)
    Bc, Cc = (rng.standard_normal((B, S, ds)).astype(np.float32)
              for _ in range(2))
    dy = rng.standard_normal((B, S, nh, hp)).astype(np.float32)
    dfinal = rng.standard_normal((B, nh, hp, ds)).astype(np.float32)
    return (x, dt, A, Bc, Cc), dy, dfinal


def _ssd_bwd_by_hand(args, chunk, dy, dfinal):
    """(dx, ddt, dA, dBc, dCc) of the port's ``ssd_scan`` with the intra-
    chunk part's gradients from ``ssd_intra_chunk_bwd_plain`` called
    directly; autograd takes only the torch ops around it (the inter-chunk
    recurrence, the chunked cumsum, the casts)."""
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    xr, cum_h, dt_h, Br, Cr = ssd_ops._chunked_inputs(*leaves, chunk)
    intra = [t.detach() for t in (xr, cum_h, dt_h, Br, Cr)]
    with torch.no_grad():
        y_intra, states = ssd_ops.ssd_intra_chunk_plain(*intra)
    y_intra.requires_grad_(True)
    states.requires_grad_(True)
    B, _, _, nh, hp = xr.shape
    init = torch.zeros(B, nh, hp, Br.shape[-1])
    y, final = ssd_ops._inter_chunk(y_intra, states, cum_h, Cr, init,
                                    xr.dtype)
    d_y_intra, d_states, d_cum, d_C = torch.autograd.grad(
        (y, final), (y_intra, states, cum_h, Cr),
        (torch.from_numpy(dy), torch.from_numpy(dfinal)), retain_graph=True)
    dx, dcum, ddt, dB, dC = ssd_ops.ssd_intra_chunk_bwd_plain(
        *intra, d_y_intra, d_states)
    return torch.autograd.grad(
        (xr, cum_h, dt_h, Br, Cr), leaves,
        (dx, dcum + d_cum, ddt, dB, dC + d_C))


def _ssd_grads_f64(args, chunk, dy, dfinal):
    """The five gradients of the SSD scan in float64, through the port's
    plain pieces without their float32 casts (dA's reference)."""
    leaves = [torch.from_numpy(a).double().requires_grad_(True)
              for a in args]
    x, dt, A, Bc, Cc = leaves
    B, S, nh, hp = x.shape
    ds, Q = Bc.shape[-1], min(chunk, S)
    nc = S // Q
    cum = torch.cumsum((dt * A).reshape(B, nc, Q, nh), 2).permute(0, 1, 3, 2)
    Br, Cr = Bc.reshape(B, nc, Q, ds), Cc.reshape(B, nc, Q, ds)
    y_intra, states = ssd_ops.ssd_intra_chunk_plain(
        x.reshape(B, nc, Q, nh, hp), cum,
        dt.reshape(B, nc, Q, nh).permute(0, 1, 3, 2), Br, Cr)
    y, final = ssd_ops._inter_chunk(
        y_intra, states, cum, Cr,
        torch.zeros(B, nh, hp, ds, dtype=torch.float64), torch.float64)
    return torch.autograd.grad(
        (y, final), leaves, (torch.from_numpy(dy).double(),
                             torch.from_numpy(dfinal).double()))


@pytest.mark.parametrize("shape", SSD_CASES)
def test_ssd_intra_chunk_bwd_matches_jax_vjp(shape):
    """K8b's plain version, called directly and chained through the torch
    ops around it, and autograd through the port's ``ssd_scan`` (whose
    backward is that plain version on the CPU) against ``jax.vjp`` of
    JAX's ``ssd_ref`` (what JAX's ``_bwd`` runs), with random dy and a
    nonzero d(final_state): dx, ddt, dBc, dCc 1e-5 and dA 1e-4 of each
    gradient's largest element, and both packages' dA within 1e-4 of a
    float64 evaluation.  The plain backward also equals autograd through
    ``ssd_intra_chunk_plain`` within 1e-5."""
    chunk = shape[-1]
    args, dy, dfinal = _ssd_inputs(shape, sum(shape))
    _, vjp = jax.vjp(lambda *a: ssd_ref(*a, chunk),
                     *(jnp.asarray(a) for a in args))
    want = vjp((jnp.asarray(dy), jnp.asarray(dfinal)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, final = ssd_ops.ssd_scan(*leaves, chunk)
    auto = torch.autograd.grad((y, final), leaves,
                               (torch.from_numpy(dy),
                                torch.from_numpy(dfinal)))
    by_hand = _ssd_bwd_by_hand(args, chunk, dy, dfinal)
    for name, a, h, w in zip(("dx", "ddt", "dA", "dBc", "dCc"), auto,
                             by_hand, want):
        w = np.asarray(w)
        tol = DA_TOL if name == "dA" else TOL
        _close(_np(a), w, tol)
        _close(_np(h), w, tol)
    exact = _ssd_grads_f64(args, chunk, dy, dfinal)[2].numpy()
    _close(_np(auto[2]), exact, DA_TOL)
    _close(np.asarray(want[2]), exact, DA_TOL)
    # the written-out formulas against torch's own derivative of K8's
    # plain forward, on the intra-chunk inputs
    xr, cum_h, dt_h, Br, Cr = (t.detach() for t in ssd_ops._chunked_inputs(
        *(torch.from_numpy(a) for a in args), chunk))
    rng = np.random.default_rng(7)
    gy = torch.from_numpy(rng.standard_normal(xr.shape).astype(np.float32))
    gs = torch.from_numpy(rng.standard_normal(
        (*xr.shape[:2], xr.shape[3], xr.shape[4], Br.shape[-1])).astype(
            np.float32))
    inner = [t.clone().requires_grad_(True) for t in (xr, cum_h, dt_h, Br,
                                                      Cr)]
    ref = torch.autograd.grad(ssd_ops.ssd_intra_chunk_plain(*inner), inner,
                              (gy, gs))
    got = ssd_ops.ssd_intra_chunk_bwd_plain(xr, cum_h, dt_h, Br, Cr, gy, gs)
    for g, r in zip(got, ref):
        _close(_np(g), _np(r))


@pytest.mark.parametrize("requires_grad", [False, True])
def test_ssd_intra_chunk_autograd_path_on_the_cpu(requires_grad):
    """A tensor that requires a gradient reaches the autograd function (its
    backward is ``ssd_intra_chunk_bwd``, the plain version on the CPU, bit
    for bit); one that does not, or one under ``no_grad``, takes the plain
    forward with no graph.  Neither launches anything on the CPU."""
    (x, dt, A, Bc, Cc), _, _ = _ssd_inputs((2, 64, 3, 8, 5, 32), 5)
    args = [t.detach() for t in ssd_ops._chunked_inputs(
        *(torch.from_numpy(a) for a in (x, dt, A, Bc, Cc)), 32)]
    rng = np.random.default_rng(6)
    gy, gs = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for s in (args[0].shape, (2, 2, 3, 8, 5)))
    launches = (ssd_ops.ssd_intra_chunk.launches,
                ssd_ops.ssd_intra_chunk_bwd.launches)
    leaves = [t.requires_grad_(requires_grad) for t in args]
    y, states = ssd_ops.ssd_intra_chunk(*leaves)
    want = ssd_ops.ssd_intra_chunk_plain(*args)
    assert torch.equal(y.detach(), want[0])
    assert torch.equal(states.detach(), want[1])
    if requires_grad:
        assert type(y.grad_fn).__name__ == "_SSDIntraChunkBackward"
        got = torch.autograd.grad((y, states), leaves, (gy, gs))
        ref = ssd_ops.ssd_intra_chunk_bwd_plain(*(t.detach() for t in args),
                                                gy, gs)
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
        with torch.no_grad():
            assert ssd_ops.ssd_intra_chunk(*leaves)[0].grad_fn is None
    else:
        assert y.grad_fn is None
    assert (ssd_ops.ssd_intra_chunk.launches,
            ssd_ops.ssd_intra_chunk_bwd.launches) == launches


def test_ssd_intra_chunk_bwd_refuses_bad_shapes():
    (x, dt, A, Bc, Cc), _, _ = _ssd_inputs((1, 32, 2, 4, 3, 32), 0)
    args = [t.detach() for t in ssd_ops._chunked_inputs(
        *(torch.from_numpy(a) for a in (x, dt, A, Bc, Cc)), 32)]
    dy = torch.zeros_like(args[0])
    dst = torch.zeros(1, 1, 2, 4, 3)
    with pytest.raises(ValueError, match="dy"):
        ssd_ops.ssd_intra_chunk_bwd(*args, dy[:, :, :16], dst)
    with pytest.raises(ValueError, match="dstates"):
        ssd_ops.ssd_intra_chunk_bwd(*args, dy, dst.double())
    with pytest.raises(ValueError, match="takes Q"):
        big = torch.zeros(1, 1, 32, 256)
        ssd_ops.ssd_intra_chunk_bwd(args[0], args[1], args[2], big, big, dy,
                                    torch.zeros(1, 1, 2, 4, 256))


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,chunk", [(50, 16), (48, 16), (20, 64)])
def test_chunked_cross_entropy_matches_jax(S, chunk):
    """CE with -1 labels (skipped) over full chunks and a remainder chunk,
    and its gradients with respect to h and the head, against JAX's."""
    cfg = smoke_arch("llama3.2-3b").replace(loss_chunk=chunk)
    jcfg = j_smoke_arch("llama3.2-3b").replace(loss_chunk=chunk)
    rng = np.random.default_rng(S)
    h = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    w = (0.1 * rng.standard_normal((cfg.d_model, cfg.vocab_size))
         ).astype(np.float32)
    y = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    y[0, :5] = -1
    y[1, -3:] = -1
    jl, (jgh, jgw) = jax.value_and_grad(
        lambda a, b: j_layers.chunked_cross_entropy(jcfg, a, b, jnp.asarray(y)),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th, tw = (torch.from_numpy(a).requires_grad_(True) for a in (h, w))
    tl = t_layers.chunked_cross_entropy(cfg, th, tw, torch.from_numpy(y))
    gh, gw = torch.autograd.grad(tl, (th, tw))
    _close(float(tl.detach()), float(jl), 1e-6)
    _close(_np(gh), np.asarray(jgh), TOL)
    _close(_np(gw), np.asarray(jgw), TOL)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-780m",
                                  "jamba-v0.1-52b", "dbrx-132b"])
def test_lm_loss_and_gradients_match_jax(arch):
    """``lm_loss`` (CE + 0.01 aux, {"ce", "aux"}) at smoke width on a
    token-stream batch: the loss and CE 1e-5, the MoE aux 1e-6 (0 without
    MoE layers), every gradient leaf 1e-3 of its norm (mamba through K8's
    plain version; jamba's one block: attention, SSM and MoE layers)."""
    jcfg, cfg, jp, tp = _carried(arch)
    batch = _batches(cfg, 1)[0]
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: j_tf.lm_loss(jcfg, p, {k: jnp.asarray(v)
                                         for k, v in batch.items()}),
        has_aux=True)(jp)
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tl, taux = t_tf.lm_loss(cfg, tp, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    grads = torch.autograd.grad(tl, leaves)
    _close(float(tl.detach()), float(jl))
    _close(float(taux["ce"]), float(jaux["ce"]))
    _close(float(taux["aux"]), float(jaux["aux"]), 1e-6)
    assert (float(jaux["aux"]) == 0.0) == (cfg.num_experts == 0)
    want = flatten_tree(jg)
    got = dict(zip(_flat_keys(tp), (_np(g) for g in grads)))
    assert set(got) == set(want)
    for key in want:
        _norm_close(got[key], np.asarray(want[key]), 1e-3)


def _flat_keys(tree, prefix=""):
    if isinstance(tree, dict):
        return [k for n, v in tree.items()
                for k in _flat_keys(v, f"{prefix}{n}/")]
    return [prefix.rstrip("/")]


# ---------------------------------------------------------------------------
# the train step under each optimizer option
# ---------------------------------------------------------------------------

OPTIONS = {"default": {}, "microbatch": {"microbatch": 2},
           "loss_scale": {"loss_scale": 128.0},
           "bf16_moments": {"opt_dtype": "bfloat16"},
           "grad_compress": {"grad_compress": True}}
#: the model config's twin: JAX's remat fields (the default is remat
#: on, policy "full"), given to both packages' configs
MODEL_OPTIONS = {"remat_off": {"remat": False},
                 "remat_full": {"remat": True, "remat_policy": "full"},
                 "remat_dots": {"remat": True, "remat_policy": "dots"}}


@pytest.mark.parametrize("option,arch", [
    *(pytest.param(o, "llama3.2-3b", id=o) for o in OPTIONS),
    *(pytest.param(o, "llama3.2-3b", id=o) for o in ("remat_off",
                                                      "remat_dots")),
    pytest.param("default", "mamba2-780m", id="mamba2-780m-default"),
    pytest.param("bf16_moments", "dbrx-132b", id="dbrx-132b-bf16_moments")])
def test_three_train_steps_match_jax(option, arch):
    """Three steps of ``make_train_step`` against JAX's on the same token
    batches from the same weights: loss and grad_norm of every step 1e-5 /
    1e-4, lr exactly, every parameter leaf (and moment, and compression
    residual) after step 3 within 1e-4 of its norm; with compression, the
    moments and the residual may differ in one element a leaf by an int8
    quantum.  llama3.2-3b under each option; mamba2-780m (its SSD layers'
    backward through K8b's plain version) under the default; dbrx-132b
    (its MoE FFN's gather backwards) with bf16 moments, as the card trains
    it; llama3.2-3b with remat off and under the "dots" policy, JAX built
    with the same fields."""
    kw = dict(learning_rate=3e-3, warmup_steps=1, total_steps=10,
              **OPTIONS.get(option, {}))
    jtc, tc = JTrainConfig(**kw), TrainConfig(**kw)
    jcfg, cfg, jp, tp = _carried(arch, seed=1,
                                 **MODEL_OPTIONS.get(option, {}))
    jstate = j_adamw_init(jp, jtc)
    state = adamw_init(tp, tc)
    jstep = jax.jit(j_make_train_step(jcfg, jtc))
    step = make_train_step(cfg, tc)
    for batch in _batches(cfg, 3, B=4, S=32, seed=2):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        assert set(m) == set(jm)
        _close(float(m["loss"]), float(jm["loss"]))
        _close(float(m["grad_norm"]), float(jm["grad_norm"]), 1e-4)
        assert m["lr"] == float(jm["lr"])
    assert state.step == int(jstate.step) == 3
    for name in ("params", "mu", "nu", "compress_err"):
        jt, tt = getattr(jstate, name), getattr(state, name)
        assert (jt is None) == (tt is None)
        if tt is None:
            continue
        want = flatten_tree(jt)
        got = dict(zip(_flat_keys(tt), tree_leaves(tt)))
        for key in want:
            assert got[key].dtype == getattr(torch, str(want[key].dtype))
            g, w = _np(got[key]), want[key].astype(np.float32)
            if name != "params" and tc.grad_compress:
                # an element whose (grad + residual) / scale lands on
                # either side of a rounding boundary in the two packages
                # takes another int8 code: its residual and moments move
                # by a quantum; at most one such element a leaf.  The
                # residual is at most half a quantum, 1/254 of the
                # gradient's scale: 2e-3 of its largest element is 8e-6 of
                # the gradient's
                tol = 2e-3 if name == "compress_err" else 1e-4
                off = np.abs(g - w) > tol * np.abs(w).max()
                assert int(off.sum()) <= 1, (name, key, int(off.sum()))
                continue
            # a bf16 moment may sit one bf16 rounding (2^-8) from JAX's
            # where the float32 values on either side of it differ by an ulp
            tol = 2 ** -8 if got[key].dtype == torch.bfloat16 else 1e-4
            _norm_close(g, w, tol)


@pytest.mark.parametrize("option", ["default", "microbatch",
                                    "grad_compress", "remat_full",
                                    "remat_dots"])
def test_train_step_leaves_no_tensor_garbage(option):
    """Train steps leave no reference cycle holding tensors: a cycle that
    held a step's gradients would keep them allocated until the garbage
    collector runs, which card memory does not trigger (at dbrx-132b's
    width that is 17 GiB a step).  With the collector off, nothing two
    steps made is garbage; nor under either remat policy (the
    checkpoint's saved-tensor hooks and the policy's cache)."""
    cfg = smoke_arch("dbrx-132b").replace(num_layers=2,
                                          **MODEL_OPTIONS.get(option, {}))
    tc = TrainConfig(learning_rate=3e-3, warmup_steps=1, total_steps=10,
                     **OPTIONS.get(option, {}))
    state = adamw_init(t_tf.init_params(cfg, torch.Generator().manual_seed(
        0), device="cpu"), tc)
    step = make_train_step(cfg, tc)
    batch = {k: torch.from_numpy(v)
             for k, v in _batches(cfg, 1, B=4, S=32)[0].items()}
    gc.collect()
    gc.disable()
    try:
        for _ in range(2):
            state, metrics = step(state, batch)
        del metrics
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        garbage = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert not garbage, [tuple(t.shape) for t in garbage]


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-780m"])
def test_prefill_and_decode_steps_match_jax(arch):
    """``make_prefill_step`` (logits, caches and next index) and
    ``make_decode_step`` (one token from a fresh decode state) against
    JAX's, 1e-5."""
    jcfg, cfg, jp, tp = _carried(arch)
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32)
    jl, jstate = j_steps.make_prefill_step(jcfg)(jp, {"tokens":
                                                      jnp.asarray(toks)})
    tl, tstate = t_steps.make_prefill_step(cfg)(tp, {"tokens":
                                                     torch.from_numpy(toks)})
    _close(_np(tl), np.asarray(jl))
    assert tstate["index"] == int(jstate["index"]) == 64
    want = flatten_tree(jstate["caches"])
    got = dict(zip(_flat_keys(tstate["caches"]),
                   tree_leaves(tstate["caches"])))
    assert set(got) == set(want)
    for key in want:
        _close(_np(got[key]), np.asarray(want[key], np.float32))
    tok = toks[:, :1]
    jl, _ = j_steps.make_decode_step(jcfg)(
        jp, j_tf.init_decode_state(jcfg, 2, 8), {"tokens": jnp.asarray(tok)})
    tl, ts = t_steps.make_decode_step(cfg)(
        tp, t_tf.init_decode_state(cfg, 2, 8), {"tokens": torch.from_numpy(tok)})
    _close(_np(tl), np.asarray(jl))
    assert ts["index"] == 1


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

LINE = re.compile(r"^\[train\] step +(\d+) loss=\d+\.\d{4} gnorm=\d+\.\d{2} "
                  r"lr=\d\.\d{2}e[-+]\d{2} \d+ms$")


def _cli(argv, capsys):
    out = {}
    assert train_mod.main(["--arch", "llama3.2-3b", "--smoke", "--device",
                           "cpu", "--batch", "2", "--seq-len", "32",
                           "--log-every", "2", *argv], out=out) == 0
    return out, capsys.readouterr().out.splitlines()


def test_train_cli_prints_jax_lines(capsys):
    """``--smoke --device cpu``: one ``[train] step`` line every
    ``--log-every`` steps and at the last, as JAX's launcher prints them,
    then the ``done`` line; the loss is finite."""
    out, lines = _cli(["--steps", "5"], capsys)
    steps = [int(LINE.match(ln).group(1)) for ln in lines
             if ln.startswith("[train] step")]
    assert steps == [0, 2, 4]
    assert all(LINE.match(ln) for ln in lines
               if ln.startswith("[train] step"))
    assert lines[-1].startswith("[train] done: 5 steps in ")
    assert [r["step"] for r in out["steps"]] == list(range(5))
    assert all(np.isfinite(float(r["loss"])) for r in out["steps"])
    assert out["state"].step == 5


def test_train_cli_resume_equals_the_uninterrupted_run(tmp_path, capsys):
    """Six steps against three steps, then ``--resume auto`` to six from
    the checkpoint (the token stream skipped to step 3): the losses of
    steps 3-5 and the final params, moments and step bit-equal."""
    whole, _ = _cli(["--steps", "6", "--checkpoint-dir",
                     str(tmp_path / "a")], capsys)
    _cli(["--steps", "3", "--checkpoint-dir", str(tmp_path / "b")], capsys)
    resumed, lines = _cli(["--steps", "6", "--checkpoint-dir",
                           str(tmp_path / "b"), "--resume", "auto"], capsys)
    assert "[train] resumed from step 3" in lines
    assert resumed["start_step"] == 3
    assert [float(r["loss"]) for r in resumed["steps"]] == \
        [float(r["loss"]) for r in whole["steps"][3:]]
    a, b = whole["state"], resumed["state"]
    assert a.step == b.step == 6
    for name in ("params", "mu", "nu"):
        for x, y in zip(tree_leaves(getattr(a, name)),
                        tree_leaves(getattr(b, name))):
            assert x.dtype == y.dtype and torch.equal(x.detach(), y.detach())


def test_train_cli_refuses_a_mesh():
    """``--mesh pod`` needs a torch.distributed group of 256 ranks; this
    process has none (``tests/test_torch_model_parallel.py`` trains a
    mesh)."""
    with pytest.raises(ValueError, match="256 ranks"):
        train_mod.main(["--arch", "llama3.2-3b", "--smoke", "--device", "cpu",
                        "--mesh", "pod"])


# ---------------------------------------------------------------------------
# no gradient on the card bypasses a kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [
    pytest.param("mamba2-780m", id="mamba2-780m-N2"),
    pytest.param("jamba-v0.1-52b", id="jamba-v0.1-52b-A14"),
    pytest.param("dbrx-132b", id="dbrx-132b-A14")])
def test_training_refuses_ssm_and_moe_archs_on_the_card(arch, monkeypatch):
    """The launcher refuses none of the SSM, hybrid and MoE archs (the
    name is from when it refused them): on the card as on the CPU it
    reaches the token stream for each, with the arch's vocabulary and
    width.  The card's gradients run K8b / K7b and the MoE FFN's gather
    backwards."""
    class Stop(Exception):
        pass

    seen = []

    def stream(vocab, seq, batch, **kw):     # reached: the launcher took it
        seen.append((vocab, kw.get("d_model"), kw.get("seed")))
        raise Stop

    monkeypatch.setattr(train_mod, "TokenStream", stream)
    for device in ("cuda", "cpu"):
        monkeypatch.setattr(train_mod, "resolve_device",
                            lambda d, device=device: torch.device(device))
        with pytest.raises(Stop):
            train_mod.main(["--arch", arch, "--smoke", "--steps", "1"])
    cfg = smoke_arch(arch)
    assert seen == [(cfg.vocab_size, cfg.d_model, 0)] * 2
