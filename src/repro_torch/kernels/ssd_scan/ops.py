"""K8 wrapper, its plain PyTorch version, and the SSD chunked scan around
it (counterpart of ``repro/kernels/ssd_scan/{kernel,ops,ref}.py`` and of
``ssd_chunked`` in ``repro/models/ssm.py``; forward only on the card).

``ssd_intra_chunk``        the intra-chunk outputs and chunk states: CUDA
                           tensors launch ``csrc/ssd_intra_chunk.cu`` (its
                           three products as 3xTF32 tensor-core MMAs), CPU
                           tensors take ``ssd_intra_chunk_plain`` (and
                           differentiate through it).  K8 has no backward
                           kernel yet: a CUDA input that requires a
                           gradient raises ``NotImplementedError``.
``ssd_scan``               the whole scan as the JAX wrapper runs it: the
                           chunked cumulative log-decay, K8, then the
                           inter-chunk recurrence (a loop over the chunks,
                           as JAX's ``lax.scan``) and the inter-chunk output.
``ssd_chunked``            the plain oracle (``models/ssm.py:ssd_chunked``),
                           with an optional initial state.
``ssd_sequential_ref``     the O(S) recurrence, the ground-truth semantics.

Shapes: x (B,S,nh,hp); dt (B,S,nh), already softplus'ed; A (nh,), negative;
Bc / Cc (B,S,ds), shared over heads.  S must be a multiple of the chunk
min(chunk, S), as JAX asserts.  The kernel takes chunks of up to 256 rows,
hp <= 64 and ds <= 128 (every SSM config of the zoo); anything else raises,
on either device.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import check, launch, route

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
    tensors."""
    _check_intra(x, cum, dt, Bc, Cc)
    if route(x) == "cpu":
        return ssd_intra_chunk_plain(x, cum, dt, Bc, Cc)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, cum, dt, Bc, Cc)):
        raise NotImplementedError(
            "ssd_intra_chunk: K8 has no backward on the card yet (N2, the "
            "SSD intra-chunk backward kernel); SSM and hybrid archs train "
            "on the CPU only")
    B, nc, Q, nh, hp = x.shape
    ds = Bc.shape[-1]
    dev = x.device
    for name, t in (("x", x), ("cum", cum), ("dt", dt), ("Bc", Bc),
                    ("Cc", Cc)):
        check(name, t, dtype=torch.float32, shape=tuple(t.shape), device=dev)
    QP = -(-Q // 64) * 64           # CB's scratch: (B*nc, QP, QP) tiles
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
