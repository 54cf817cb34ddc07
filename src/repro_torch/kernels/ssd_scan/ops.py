"""K8 / K8b wrappers, their plain PyTorch versions, and the SSD chunked
scan around them (counterpart of ``repro/kernels/ssd_scan/{kernel,ops,
ref}.py`` and of ``ssd_chunked`` in ``repro/models/ssm.py``).

``ssd_intra_chunk``        the intra-chunk outputs and chunk states: CUDA
                           tensors launch ``csrc/ssd_intra_chunk.cu`` (its
                           three products as 3xTF32 tensor-core MMAs), CPU
                           tensors take ``ssd_intra_chunk_plain``.  When a
                           gradient is wanted it runs as a
                           ``torch.autograd.Function`` (JAX's ``custom_vjp``)
                           whose backward is ``ssd_intra_chunk_bwd``; it
                           saves its five inputs.
``ssd_intra_chunk_bwd``    dx, dcum, ddt, dBc, dCc (JAX's backward is
                           ``jax.vjp`` of the oracle): CUDA tensors launch
                           K8b, ``csrc/ssd_intra_chunk_bwd.cu`` (its
                           products as 3xTF32 tensor-core MMAs, dCB and dB's
                           state term over groups of heads), CPU tensors
                           take ``ssd_intra_chunk_bwd_plain``, the gradient
                           formulas written out in torch ops.
``ssd_scan``               the whole scan as the JAX wrapper runs it: the
                           chunked cumulative log-decay, K8, then the
                           inter-chunk recurrence (a loop over the chunks,
                           as JAX's ``lax.scan``) and the inter-chunk output.
                           Autograd differentiates the torch ops around K8
                           (the cumsum, the recurrence, the casts).
``ssd_chunked``            the plain oracle (``models/ssm.py:ssd_chunked``),
                           with an optional initial state.
``ssd_sequential_ref``     the O(S) recurrence, the ground-truth semantics.

Shapes: x (B,S,nh,hp); dt (B,S,nh), already softplus'ed; A (nh,), negative;
Bc / Cc (B,S,ds), shared over heads.  S must be a multiple of the chunk
min(chunk, S), as JAX asserts.  The kernels take chunks of up to 256 rows,
hp <= 64 and ds <= 128 (every SSM config of the zoo); anything else raises,
on either device.

On ``meta`` tensors (the dry run, ``launch/dryrun.py``) K8's and K8b's
wrappers return ``meta`` outputs of the kernels' shapes, allocate their
workspace on ``meta`` and ``tally`` the call's operations and bytes
(``ssd_intra_chunk_cost``, ``ssd_intra_chunk_bwd_cost``, which chip_smoke's
kernel table uses too); they neither launch a kernel nor run a plain
version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import check, launch, route, tally

MAX_Q, MAX_HP, MAX_DS = 256, 64, 128
NEG_INF = -1e30


def _check_intra(x, cum, dt, Bc, Cc) -> None:
    if x.dim() != 5:
        raise ValueError(f"ssd_intra_chunk: x (B,nc,Q,nh,hp) expected, got "
                         f"{tuple(x.shape)}")
    B, nc, Q, nh, hp = x.shape
    ds = Bc.shape[-1] if Bc.dim() == 4 else -1
    want = {"cum": (cum, (B, nc, nh, Q)), "dt": (dt, (B, nc, nh, Q)),
            "Bc": (Bc, (B, nc, Q, ds)), "Cc": (Cc, (B, nc, Q, ds))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"ssd_intra_chunk: {name} {tuple(t.shape)}, "
                             f"expected {shape}")
    for name, t in (("x", x), *((n, t) for n, (t, _) in want.items())):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_intra_chunk: {name} must be float32, got "
                            f"{t.dtype}")
    if Q > MAX_Q or hp > MAX_HP or ds > MAX_DS:
        raise ValueError(f"ssd_intra_chunk: takes Q <= {MAX_Q}, hp <= "
                         f"{MAX_HP}, ds <= {MAX_DS}; got Q={Q}, hp={hp}, "
                         f"ds={ds}")


def ssd_intra_chunk_cost(B, nc, Q, nh, hp, ds):
    """(operations, bytes) of one K8 call: CB over each chunk's causal
    triangle, then per head the decay and weights on it, the weighted sum
    over x and the chunk states; the five inputs read once and y and the
    states written once, float32."""
    tri = Q * (Q + 1) // 2
    ops = B * nc * (2 * ds * tri + nh * (
        4 * tri + 2 * hp * tri + 3 * Q + Q * ds + 2 * Q * ds * hp))
    bytes_ = 4 * (2 * B * nc * Q * nh * hp + 2 * B * nc * nh * Q
                  + 2 * B * nc * Q * ds + B * nc * nh * hp * ds)
    return ops, bytes_


def ssd_intra_chunk_bwd_cost(B, nc, Q, nh, hp, ds):
    """(operations, bytes) of one K8b call: dw and w^T dy over the
    triangle, u = B dst^T and (sd x)^T dst, dsd and the elementwise work on
    the triangle, per head; CB, dC and dB's CB term per chunk.  The seven
    inputs read once and the five gradients written once, float32."""
    tri = Q * (Q + 1) // 2
    ops = B * nc * (3 * 2 * ds * tri + nh * (
        4 * hp * tri + 4 * Q * ds * hp + 2 * Q * hp + 6 * tri))
    bytes_ = 4 * (3 * B * nc * Q * nh * hp + 4 * B * nc * nh * Q
                  + 4 * B * nc * Q * ds + B * nc * nh * hp * ds)
    return ops, bytes_


def ssd_intra_chunk_plain(x, cum, dt, Bc, Cc):
    """(y_intra (B,nc,Q,nh,hp), states (B,nc,nh,hp,ds)), float32: the
    intra-chunk part of ``ssd_chunked``.  x (B,nc,Q,nh,hp); cum / dt
    (B,nc,nh,Q); Bc / Cc (B,nc,Q,ds)."""
    Q = x.shape[2]
    CB = torch.einsum("bcqn,bcsn->bcqs", Cc, Bc)               # (B,nc,Q,Q)
    diff = cum[..., :, None] - cum[..., None, :]               # (B,nc,nh,Q,Q)
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(diff.masked_fill(~causal, NEG_INF))      # mask, then exp
    w = CB[:, :, None] * decay * dt[..., None, :]
    y = torch.einsum("bchqs,bcshp->bcqhp", w, x)
    sd = torch.exp(cum[..., -1:] - cum) * dt                   # (B,nc,nh,Q)
    states = torch.einsum("bcsn,bcshp->bchpn", Bc,
                          x * sd.permute(0, 1, 3, 2)[..., None])
    return y, states


def ssd_intra_chunk(x, cum, dt, Bc, Cc):
    """(y_intra, states) as ``ssd_intra_chunk_plain``, through K8 for CUDA
    tensors; differentiable (backward: ``ssd_intra_chunk_bwd``)."""
    _check_intra(x, cum, dt, Bc, Cc)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, cum, dt, Bc, Cc)):
        return _SSDIntraChunk.apply(x, cum, dt, Bc, Cc)
    return _forward(x, cum, dt, Bc, Cc)


class _SSDIntraChunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cum, dt, Bc, Cc):
        y, states = _forward(x, cum, dt, Bc, Cc)
        ctx.save_for_backward(x, cum, dt, Bc, Cc)
        return y, states

    @staticmethod
    def backward(ctx, dy, dstates):
        x, cum, dt, Bc, Cc = ctx.saved_tensors
        return ssd_intra_chunk_bwd(x, cum, dt, Bc, Cc, dy.contiguous(),
                                   dstates.contiguous())


def _check_device(dev, **tensors) -> None:
    for name, t in tensors.items():
        check(name, t, dtype=torch.float32, shape=tuple(t.shape), device=dev)


def _forward(x, cum, dt, Bc, Cc):
    B, nc, Q, nh, hp = x.shape
    ds = Bc.shape[-1]
    QP = -(-Q // 64) * 64           # CB's scratch: (B*nc, QP, QP) tiles
    if x.device.type == "meta":     # the CUDA branch's allocations
        cb = torch.empty(B * nc * QP * QP, dtype=torch.float32, device="meta")
        y = torch.empty(B, nc, Q, nh, hp, dtype=torch.float32, device="meta")
        states = torch.empty(B, nc, nh, hp, ds, dtype=torch.float32,
                             device="meta")
        tally("ssd_intra_chunk", *ssd_intra_chunk_cost(B, nc, Q, nh, hp, ds),
              "tf32x3")
        del cb
        return y, states
    if route(x) == "cpu":
        return ssd_intra_chunk_plain(x, cum, dt, Bc, Cc)
    dev = x.device
    _check_device(dev, x=x, cum=cum, dt=dt, Bc=Bc, Cc=Cc)
    cb = torch.empty(B * nc * QP * QP, dtype=torch.float32, device=dev)
    y = torch.empty(B, nc, Q, nh, hp, dtype=torch.float32, device=dev)
    states = torch.empty(B, nc, nh, hp, ds, dtype=torch.float32, device=dev)
    launch("ssd_intra_chunk", *(t.data_ptr() for t in
                                (x, cum, dt, Bc, Cc, cb, y, states)),
           B, nc, Q, nh, hp, ds)
    ssd_intra_chunk.launches += 1
    return y, states


#: kernel launches made through this wrapper (CUDA tensors only)
ssd_intra_chunk.launches = 0


def ssd_intra_chunk_bwd_plain(x, cum, dt, Bc, Cc, dy, dstates):
    """(dx, dcum, ddt, dBc, dCc), float32: the gradients of
    ``ssd_intra_chunk_plain`` at (x, cum, dt, Bc, Cc) for the output
    gradients dy (B,nc,Q,nh,hp) and dstates (B,nc,nh,hp,ds), written out.
    Per (b, c, h), with L[q,s] = exp(cum[q] - cum[s]) for s <= q (else 0,
    masked before the exp), w = CB L dt[s], E[s] = exp(cum[Q-1] - cum[s]),
    sd = E dt and u[s,p] = sum_n B[s,n] dst[p,n]:

      dw[q,s]  = dy[q,:] . x[s,:]                    (s <= q)
      dx[s,:]  = sum_q w[q,s] dy[q,:] + sd[s] u[s,:]
      g        = dw w;   dsd[s] = x[s,:] . u[s,:]
      dcum[i]  = sum_s g[i,s] - sum_q g[q,i] - dsd[i] sd[i]
                 + [i = Q-1] sum_s dsd[s] sd[s]
      ddt[s]   = sum_q dw[q,s] CB[q,s] L[q,s] + dsd[s] E[s]
      dCB      = sum_h dw L dt[s];   dC = dCB B
      dB       = dCB^T C + sum_h (sd x)^T dst

    The diagonal's terms of dcum (q = s; s = Q-1 in the states' term)
    cancel in exact arithmetic and are kept, as JAX's vjp keeps them."""
    Q = x.shape[2]
    CB = torch.einsum("bcqn,bcsn->bcqs", Cc, Bc)[:, :, None]   # (B,nc,1,Q,Q)
    diff = cum[..., :, None] - cum[..., None, :]               # (B,nc,nh,Q,Q)
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    L = torch.exp(diff.masked_fill(~causal, NEG_INF))          # mask, then exp
    dts = dt[..., None, :]                                     # dt[s]
    w = CB * L * dts
    dw = torch.einsum("bcqhp,bcshp->bchqs", dy, x)   # used only as dw L
    E = torch.exp(cum[..., -1:] - cum)                         # (B,nc,nh,Q)
    sd = E * dt
    u = torch.einsum("bcsn,bchpn->bcshp", Bc, dstates)         # (B,nc,Q,nh,hp)
    sd_s = sd.permute(0, 1, 3, 2)[..., None]                   # (B,nc,Q,nh,1)
    dx = torch.einsum("bchqs,bcqhp->bcshp", w, dy) + sd_s * u
    dsd = (x * u).sum(-1).permute(0, 1, 3, 2)                  # (B,nc,nh,Q)
    dwL = dw * L
    g = dwL * CB * dts
    dcum = g.sum(-1) - g.sum(-2) - dsd * sd
    dcum[..., -1] += (dsd * sd).sum(-1)
    ddt = (dwL * CB).sum(-2) + dsd * E
    dCB = (dwL * dts).sum(2)                                   # (B,nc,Q,Q)
    dCc = torch.einsum("bcqs,bcsn->bcqn", dCB, Bc)
    dBc = torch.einsum("bcqs,bcqn->bcsn", dCB, Cc) + torch.einsum(
        "bcshp,bchpn->bcsn", x * sd_s, dstates)
    return dx, dcum, ddt, dBc, dCc


#: K8b's head groups: dCB is summed over at most BWD_GROUPS groups of
#: heads and dB's state term over at most BWD_STATE_GROUPS, each group's
#: partial in the scratch
BWD_GROUPS, BWD_STATE_GROUPS = 3, 6


def ssd_intra_chunk_bwd_scratch(B, nc, Q, nh, hp, ds) -> int:
    """float32 elements of K8b's workspace (the layout of
    ``csrc/ssd_intra_chunk_bwd.cu``), QP = Q rounded up to 64, T = QP / 64,
    NG = min(nh, 3) and NGS = min(nh, 6) head groups: CB over (B*nc, QP,
    QP); each group's partial dCB, (NG, B*nc, QP, QP); the per-head partial
    sums of dcum's rows, dcum's columns and ddt over each 64 x 64 tile,
    (B*nc*nh, T, QP) each; sd, (B*nc*nh, QP); each state group's part of
    dB's state term, (NGS, B*nc, QP, ds)."""
    QP = -(-Q // 64) * 64
    T, BC = QP // 64, B * nc
    NG, NGS = min(nh, BWD_GROUPS), min(nh, BWD_STATE_GROUPS)
    return ((1 + NG) * BC * QP * QP + (3 * T + 1) * BC * nh * QP
            + NGS * BC * QP * ds)


def ssd_intra_chunk_bwd(x, cum, dt, Bc, Cc, dy, dstates):
    """(dx, dcum, ddt, dBc, dCc) of ``ssd_intra_chunk`` at (x, cum, dt, Bc,
    Cc) for the output gradients dy (y_intra's shape) and dstates (the
    states'), float32: K8b for CUDA tensors, the plain version on the
    CPU."""
    _check_intra(x, cum, dt, Bc, Cc)
    B, nc, Q, nh, hp = x.shape
    ds = Bc.shape[-1]
    for name, t, shape in (("dy", dy, x.shape),
                           ("dstates", dstates, (B, nc, nh, hp, ds))):
        if tuple(t.shape) != tuple(shape) or t.dtype != torch.float32:
            raise ValueError(f"ssd_intra_chunk_bwd: {name} "
                             f"{tuple(t.shape)} {t.dtype}, expected "
                             f"{tuple(shape)} torch.float32")
    n_scratch = ssd_intra_chunk_bwd_scratch(B, nc, Q, nh, hp, ds)
    if x.device.type == "meta":     # the CUDA branch's allocations
        scratch = torch.empty(n_scratch, dtype=torch.float32, device="meta")
        grads = tuple(torch.empty_like(t) for t in (x, cum, dt, Bc, Cc))
        tally("ssd_intra_chunk_bwd",
              *ssd_intra_chunk_bwd_cost(B, nc, Q, nh, hp, ds), "tf32x3")
        del scratch
        return grads
    if route(x) == "cpu":
        return ssd_intra_chunk_bwd_plain(x, cum, dt, Bc, Cc, dy, dstates)
    dev = x.device
    _check_device(dev, x=x, cum=cum, dt=dt, Bc=Bc, Cc=Cc, dy=dy,
                  dstates=dstates)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    dcum = torch.empty_like(cum)
    ddt = torch.empty_like(dt)
    dBc = torch.empty_like(Bc)
    dCc = torch.empty_like(Cc)
    launch("ssd_intra_chunk_bwd", *(t.data_ptr() for t in
                                    (x, cum, dt, Bc, Cc, dy, dstates,
                                     scratch)),
           n_scratch, *(t.data_ptr() for t in (dx, dcum, ddt, dBc, dCc)),
           B, nc, Q, nh, hp, ds)
    ssd_intra_chunk_bwd.launches += 1
    return dx, dcum, ddt, dBc, dCc


#: kernel launches made through this wrapper (CUDA tensors only)
ssd_intra_chunk_bwd.launches = 0


def _chunked_inputs(x, dt, A, Bc, Cc, chunk: int):
    """The kernel's inputs in its layouts: x (B,nc,Q,nh,hp), the chunked
    cumulative log-decay and dt (B,nc,nh,Q), B / C (B,nc,Q,ds), float32."""
    B, S, nh, hp = x.shape
    ds = Bc.shape[-1]
    Q = min(chunk, S)
    if Q < 1 or S % Q:
        raise ValueError(f"ssd_scan: S={S} is not a multiple of the chunk "
                         f"{Q}")
    nc = S // Q
    a = (dt * A[None, None, :]).float()                        # log-decay
    cum = torch.cumsum(a.reshape(B, nc, Q, nh), dim=2)
    cum_h = cum.permute(0, 1, 3, 2).contiguous()               # (B,nc,nh,Q)
    dt_h = dt.reshape(B, nc, Q, nh).permute(0, 1, 3, 2).float().contiguous()
    xr = x.reshape(B, nc, Q, nh, hp).float().contiguous()
    Br = Bc.reshape(B, nc, Q, ds).float().contiguous()
    Cr = Cc.reshape(B, nc, Q, ds).float().contiguous()
    return xr, cum_h, dt_h, Br, Cr


def _inter_chunk(y_intra, states, cum_h, Cr, init, out_dtype):
    """The inter-chunk recurrence over the chunks (sequential, a
    (B,nh,hp,ds) carry) and y = y_intra + y_inter, as (B,S,nh,hp)."""
    B, nc, Q, nh, hp = y_intra.shape
    chunk_decay = torch.exp(cum_h[..., -1])                    # (B,nc,nh)
    carry = init
    prevs = []
    for c in range(nc):
        prevs.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prevs = torch.stack(prevs, dim=1)                          # (B,nc,nh,hp,ds)
    dec_in = torch.exp(cum_h).permute(0, 1, 3, 2)[..., None]   # (B,nc,Q,nh,1)
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", Cr, prevs) * dec_in
    y = (y_intra + y_inter).reshape(B, nc * Q, nh, hp)
    return y.to(out_dtype), carry.to(out_dtype)


def ssd_scan(x, dt, A, Bc, Cc, chunk: int):
    """(y (B,S,nh,hp), final_state (B,nh,hp,ds)) in x's dtype, the
    intra-chunk part through K8."""
    xr, cum_h, dt_h, Br, Cr = _chunked_inputs(x, dt, A, Bc, Cc, chunk)
    y_intra, states = ssd_intra_chunk(xr, cum_h, dt_h, Br, Cr)
    B, _, _, nh, hp = xr.shape
    init = torch.zeros(B, nh, hp, Br.shape[-1], dtype=torch.float32,
                       device=x.device)
    return _inter_chunk(y_intra, states, cum_h, Cr, init, x.dtype)


def ssd_chunked(x, dt, A, Bc, Cc, chunk: int, initial_state=None):
    """The plain SSD chunked scan (the oracle; ``ssd_scan`` without K8),
    from ``initial_state`` (B,nh,hp,ds) or zeros."""
    xr, cum_h, dt_h, Br, Cr = _chunked_inputs(x, dt, A, Bc, Cc, chunk)
    y_intra, states = ssd_intra_chunk_plain(xr, cum_h, dt_h, Br, Cr)
    B, _, _, nh, hp = xr.shape
    init = (torch.zeros(B, nh, hp, Br.shape[-1], dtype=torch.float32,
                        device=x.device)
            if initial_state is None else initial_state.float())
    return _inter_chunk(y_intra, states, cum_h, Cr, init, x.dtype)


def ssd_sequential_ref(x, dt, A, Bc, Cc):
    """The O(S) recurrence: state_t = exp(dt_t A) state_{t-1} + dt_t B_t
    (x) x_t, y_t = C_t . state_t.  Returns (y, final_state) in x's dtype."""
    B, S, nh, hp = x.shape
    ds = Bc.shape[-1]
    state = torch.zeros(B, nh, hp, ds, dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        x_t, dt_t = x[:, t].float(), dt[:, t].float()
        B_t, C_t = Bc[:, t].float(), Cc[:, t].float()
        decay = torch.exp(dt_t * A[None])                      # (B,nh)
        state = state * decay[..., None, None] + torch.einsum(
            "bn,bhp->bhpn", B_t, x_t * dt_t[..., None])
        ys.append(torch.einsum("bn,bhpn->bhp", C_t, state))
    return torch.stack(ys, dim=1).to(x.dtype), state.to(x.dtype)
