"""K7 / K7b wrappers and their plain PyTorch versions (counterpart of
``repro/kernels/flash_attention/{kernel,ops,ref}.py``).

``flash_attention``        GQA causal attention: CUDA tensors launch
                           ``csrc/flash_attention.cu``, CPU tensors take
                           ``flash_attention_plain``.  When a gradient is
                           wanted it runs as a ``torch.autograd.Function``
                           (JAX's ``custom_vjp``) whose backward is
                           ``flash_attention_bwd``; it saves q, k, v, the
                           output and each row's log-sum-exp, which K7
                           writes as an extra output only then.
``flash_attention_lse``    the same forward, not differentiable, returning
                           (out, lse): lse (B,K,G,S) float32 is each row's
                           log-sum-exp of its scaled causal scores.
``flash_attention_plain``  the kernel's arithmetic in torch ops: float32
                           scores, softmax and P.V, output in q's dtype
                           (and the log-sum-exp, when asked).
``flash_attention_bwd``    dq, dk, dv (JAX's backward is ``jax.vjp`` of the
                           oracle) from the forward's lse: CUDA tensors
                           launch K7b, ``csrc/flash_attention_bwd.cu``, CPU
                           tensors take ``flash_attention_bwd_plain``.
                           bfloat16 at hd 64 / 128 (the ``"wgmma"`` route,
                           ``bwd_route``) needs the lse; the other routes
                           recompute the statistics and ignore it.
``flash_attention_bwd_plain``  float32 recompute of P (from lse when given,
                           else a softmax), then dV = P^T dO, dP = dO V^T,
                           dS = P (dP - D) with D = rowsum(dO O), dQ =
                           scale dS K, dK = scale dS^T Q, dK and dV summed
                           over each KV head's G query heads.

Shapes: q (B,S,K,G,hd) (query head h = kv head h // G, group h % G, as
``q.reshape(B,S,K,G,hd)`` lays them out), k / v (B,S,K,hd).  The wrapper
takes what the JAX kernel takes: float32 or bfloat16 (all three alike), hd
a multiple of 16 up to 256, and S at most one 512-row block or a multiple
of it (JAX asserts S % min(512, S) == 0).  Anything else raises, on either
device.

On ``meta`` tensors (the dry run, ``launch/dryrun.py``) both wrappers return
``meta`` outputs of the kernel's shapes, allocate its workspace on ``meta``
and ``tally`` the call's operations and bytes (``flash_attention_cost``,
``flash_attention_bwd_cost``, which chip_smoke's kernel table uses too);
they neither launch a kernel nor run a plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import check, launch, route, tally

#: the JAX kernel's default block: S must be <= BLOCK or a multiple of it
BLOCK = 512
NEG_INF = -1e30


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 5 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention: q (B,S,K,G,hd), k and v "
                         f"(B,S,K,hd) expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, K, G, hd = q.shape
    if tuple(k.shape) != (B, S, K, hd) or tuple(v.shape) != (B, S, K, hd):
        raise ValueError(f"flash_attention: k / v {tuple(k.shape)} / "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v all float32 or all "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd % 16 or not 16 <= hd <= 256:
        raise ValueError(f"flash_attention: head_dim {hd} is not a multiple "
                         f"of 16 in [16, 256]")
    if S > BLOCK and S % BLOCK:
        raise ValueError(f"flash_attention: S={S} is neither <= {BLOCK} nor "
                         f"a multiple of {BLOCK}")


def flash_attention_cost(B, S, K, G, hd, esz):
    """(operations, bytes) of one K7 call on q (B,S,K,G,hd): 4 hd
    operations per causal (query, key) pair and head (QK^T and PV); q, k, v
    read once and the output written once, ``esz`` bytes an element."""
    H = K * G
    return (4 * B * H * hd * S * (S + 1) // 2,
            (2 * B * S * H * hd + 2 * B * S * K * hd) * esz)


def flash_attention_bwd_cost(B, S, K, G, hd, esz):
    """(operations, bytes) of one K7b call: 10 hd operations per causal
    pair and head (S = QK^T, dP = dO V^T, dV, dQ, dK); q, k, v, out, dout
    read once and dq, dk, dv written once."""
    H = K * G
    return (10 * hd * B * H * S * (S + 1) // 2,
            (4 * B * S * H * hd + 4 * B * S * K * hd) * esz)


def bwd_route(dtype: torch.dtype, hd: int) -> str:
    """K7b's kernels for an input type and head width: ``"wgmma"`` (bf16 at
    hd 64 / 128; reads the forward's log-sum-exp), ``"mma"`` (bf16 at the
    other hd <= 128) or ``"fma"`` (float32, and bf16 above 128)."""
    if dtype == torch.bfloat16 and hd in (64, 128):
        return "wgmma"
    return "mma" if dtype == torch.bfloat16 and hd <= 128 else "fma"


def flash_attention_bwd_scratch(B, S, K, G, hd, dtype) -> int:
    """float32 elements of K7b's workspace: D per row on the ``"wgmma"``
    route; each row's log-sum-exp and D on the others."""
    rows = B * K * G * S
    return rows if bwd_route(dtype, hd) == "wgmma" else 2 * rows


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float, return_lse: bool = False):
    """out (B,S,K,G,hd) in q's dtype: float32 causal softmax(scale q.k)
    times float32 v, as the kernel computes it (materializes the
    (B,K,G,S,S) scores); with ``return_lse``, (out, lse) with lse
    (B,K,G,S) float32 the rows' log-sum-exp of the scaled scores."""
    S = q.shape[1]
    s = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float()) * scale
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~causal, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", p, v.float()).to(q.dtype)
    return (out, torch.logsumexp(s, dim=-1)) if return_lse else out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Causal GQA attention, out (B,S,K,G,hd) in q's dtype; differentiable
    (backward: ``flash_attention_bwd``)."""
    _check_shapes(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, float(scale))
    return _forward(q, k, v, scale)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float):
    """(out, lse): ``flash_attention``'s output and each row's log-sum-exp
    of its scaled causal scores, (B,K,G,S) float32, from one K7 launch on
    CUDA tensors; not differentiable."""
    _check_shapes(q, k, v)
    return _forward(q, k, v, scale, with_lse=True)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = _forward(q, k, v, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(),
                                         ctx.scale, lse)
        return dq, dk, dv, None


def _forward(q, k, v, scale, with_lse=False):
    """out, or (out, lse) with ``with_lse``."""
    B, S, K, G, hd = q.shape
    if q.device.type == "meta":
        tally("flash_attention", *flash_attention_cost(
            *q.shape, q.element_size()), _dtype_name(q))
        out = torch.empty_like(q)
        if not with_lse:
            return out
        return out, torch.empty(B, K, G, S, dtype=torch.float32,
                                device="meta")
    if route(q) == "cpu":
        return flash_attention_plain(q, k, v, scale, return_lse=with_lse)
    dev = q.device
    check("q", q, dtype=q.dtype, shape=(B, S, K, G, hd), device=dev)
    check("k", k, dtype=q.dtype, shape=(B, S, K, hd), device=dev)
    check("v", v, dtype=q.dtype, shape=(B, S, K, hd), device=dev)
    out = torch.empty_like(q)
    lse = (torch.empty(B, K, G, S, dtype=torch.float32, device=dev)
           if with_lse else None)
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError("flash_attention: bfloat16 tensors must start on a "
                         "16-byte boundary (the kernel loads 16-byte rows)")
    launch("flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
           out.data_ptr(), 0 if lse is None else lse.data_ptr(),
           int(q.dtype == torch.bfloat16), B, S, K, G, hd, float(scale))
    flash_attention.launches += 1
    return (out, lse) if with_lse else out


#: kernel launches made through this wrapper (CUDA tensors only)
flash_attention.launches = 0


def flash_attention_bwd_plain(q, k, v, out, dout, scale: float, lse=None):
    """(dq, dk, dv) in q's dtype: the gradients of causal GQA attention
    with float32 softmax, recomputed in float32 (materializes the
    (B,K,G,S,S) scores); P = exp(scale q.k - lse) from the forward's
    log-sum-exp (B,K,G,S) when given, else a softmax."""
    S = q.shape[1]
    q32, k32, v32 = q.float(), k.float(), v.float()
    do32 = dout.float()
    s = torch.einsum("bqkgh,bskh->bkgqs", q32, k32) * scale
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~causal, NEG_INF)
    p = (torch.softmax(s, dim=-1) if lse is None
         else torch.exp(s - lse.float()[..., None]))
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, do32)
    dp = torch.einsum("bqkgh,bskh->bkgqs", do32, v32)
    d = (do32 * out.float()).sum(-1).permute(0, 2, 3, 1)      # (B,K,G,S)
    ds = p * (dp - d[..., None])
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, k32) * scale
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, q32) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q, k, v, out, dout, scale: float, lse=None):
    """(dq, dk, dv) of ``flash_attention`` at (q, k, v) with output ``out``
    and its gradient ``dout`` (out's shape and dtype), in q's dtype; lse
    (B,K,G,S) float32 the forward's (``flash_attention_lse``), required on
    the card's ``"wgmma"`` route."""
    _check_shapes(q, k, v)
    for name, t in (("out", out), ("dout", dout)):
        if tuple(t.shape) != tuple(q.shape) or t.dtype != q.dtype:
            raise ValueError(f"flash_attention_bwd: {name} "
                             f"{tuple(t.shape)} {t.dtype} does not match q "
                             f"{tuple(q.shape)} {q.dtype}")
    B, S, K, G, hd = q.shape
    if lse is not None and (tuple(lse.shape) != (B, K, G, S)
                            or lse.dtype != torch.float32):
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} "
                         f"{lse.dtype}, expected {(B, K, G, S)} "
                         f"torch.float32")
    n_scratch = flash_attention_bwd_scratch(B, S, K, G, hd, q.dtype)
    if q.device.type == "meta":         # the CUDA branch's allocations
        grads = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        scratch = torch.empty(n_scratch, dtype=torch.float32, device="meta")
        tally("flash_attention_bwd", *flash_attention_bwd_cost(
            B, S, K, G, hd, q.element_size()), _dtype_name(q))
        del scratch
        return grads
    if route(q) == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, dout, scale, lse)
    if lse is None and bwd_route(q.dtype, hd) == "wgmma":
        raise ValueError("flash_attention_bwd: bfloat16 at hd 64 / 128 "
                         "needs the forward's log-sum-exp (lse, from "
                         "flash_attention_lse)")
    dev = q.device
    for name, t in (("q", q), ("out", out), ("dout", dout)):
        check(name, t, dtype=q.dtype, shape=(B, S, K, G, hd), device=dev)
    for name, t in (("k", k), ("v", v)):
        check(name, t, dtype=q.dtype, shape=(B, S, K, hd), device=dev)
    if lse is not None:
        check("lse", lse, dtype=torch.float32, shape=(B, K, G, S),
              device=dev)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 for t in (q, k, v, out, dout, dq, dk, dv)):
        raise ValueError("flash_attention_bwd: bfloat16 tensors must start "
                         "on a 16-byte boundary (the kernel loads 16-byte "
                         "rows)")
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=dev)
    launch("flash_attention_bwd", *(t.data_ptr() for t in
                                    (q, k, v, out, dout)),
           0 if lse is None else lse.data_ptr(),
           *(t.data_ptr() for t in (dq, dk, dv, scratch)), n_scratch,
           int(q.dtype == torch.bfloat16), B, S, K, G, hd, float(scale))
    flash_attention_bwd.launches += 1
    return dq, dk, dv


#: kernel launches made through this wrapper (CUDA tensors only)
flash_attention_bwd.launches = 0
