"""GQA attention: the prefill path through K7 and the KV-cache decode path
(counterpart of ``repro/models/attention.py``).

``attention_forward`` runs the causal attention through K7
(``repro_torch.kernels.flash_attention``): a CUDA tensor launches the
hand-written kernel, a CPU tensor takes its plain version.  There is no
``attn_impl`` switch and no jnp full / chunked fallback (``attn_chunk`` and
``attn_chunk_threshold`` are not read), as the encoder has no
``use_pallas``: the port always takes the kernel's path.

``decode_attention_forward`` has no kernel in the JAX package either
(einsum, masked softmax, einsum) and stays in torch ops.  With
``cfg.decode_split`` nc > 0 dividing the cache length it is JAX's
flash-decoding split softmax: the cache viewed as nc chunks, each
chunk's float32 max, sum and P·V (the mask at -1e30, so a chunk with no
valid position weighs exp(-1e30 - m) = 0 in the merge), merged in
float32 over the chunks in order (``_split_partials``, ``_merge``);
otherwise the full softmax.  On a mesh whose model ranks split the
cache's positions the ranks' partials merge (``_decode_on_mesh``).  The
KV cache is
updated in place at ``cache_index`` (slice assignment into the caller's
tensors) where JAX's ``dynamic_update_slice`` returns a copy; the returned
cache dict holds the same tensors.

``attention_axes`` is JAX's logical-axes tree.  Under a
``distributed/model_parallel.ModelParallel`` whose rules put the model
axis on ``heads`` (and whose local heads are a multiple of the GQA group
G), ``attention_forward`` runs tensor-parallel: the rank's ``wq`` /
``bq`` hold its q heads, ``wk`` / ``wv`` / ``bk`` / ``bv`` the kv heads
those q heads read, K7 / K7b run on its (B, S, K / m, G, hd) heads, and
``wo``'s row slice gives a partial output summed over the model ranks in
rank order (Megatron's f and g: ``copy_in``, ``sum_out``).  Under a
serving ``ModelParallel`` the prefill also returns every kv head at the
positions of the rank's cache block, and decode runs on that block.
"""

from __future__ import annotations

import math

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import (
    _dense_init, apply_rope, cast, rope_angles,
)


def attention_axes(cfg: ModelConfig) -> dict:
    axes = {
        "wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", "kv_heads", "head_dim"),
        "wv": ("embed", "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
    }
    if cfg.qkv_bias:
        axes["bq"] = ("heads", "head_dim")
        axes["bk"] = ("kv_heads", "head_dim")
        axes["bv"] = ("kv_heads", "head_dim")
    return axes


def init_attention(gen: torch.Generator, cfg: ModelConfig, *,
                   device=None) -> dict:
    D, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    params = {
        "wq": _dense_init(gen, (D, H, hd), device=device),
        "wk": _dense_init(gen, (D, K, hd), device=device),
        "wv": _dense_init(gen, (D, K, hd), device=device),
        "wo": _dense_init(gen, (H, hd, D), device=device,
                          scale=1.0 / math.sqrt(H * hd)
                          / math.sqrt(2 * cfg.num_layers)),
    }
    if cfg.qkv_bias:
        for name, heads in (("bq", H), ("bk", K), ("bv", K)):
            params[name] = torch.zeros(heads, hd, dtype=torch.float32,
                                       device=device)
    return params


def _proj(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk", h, w) as one matmul."""
    D, nh, hd = w.shape
    return (h @ w.reshape(D, nh * hd)).reshape(*h.shape[:-1], nh, hd)


def _project_q(cfg: ModelConfig, p: dict, h: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    q = _proj(h, cast(p["wq"], cfg.compute_dtype))
    if cfg.qkv_bias:
        q = q + cast(p["bq"], cfg.compute_dtype)
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    return apply_rope(q, cos, sin)


def _project_kv(cfg: ModelConfig, p: dict, h: torch.Tensor,
                positions: torch.Tensor):
    """k, v of ``h`` at ``positions`` (RoPE on k)."""
    dt = cfg.compute_dtype
    k = _proj(h, cast(p["wk"], dt))
    v = _proj(h, cast(p["wv"], dt))
    if cfg.qkv_bias:
        k = k + cast(p["bk"], dt)
        v = v + cast(p["bv"], dt)
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    return apply_rope(k, cos, sin), v


def _project_qkv(cfg: ModelConfig, p: dict, h: torch.Tensor,
                 positions: torch.Tensor):
    return (_project_q(cfg, p, h, positions),
            *_project_kv(cfg, p, h, positions))


def _out_proj(cfg: ModelConfig, p: dict, ctx: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd", ctx, wo)."""
    wo = cast(p["wo"], cfg.compute_dtype)
    H, hd, D = wo.shape
    return ctx.reshape(*ctx.shape[:-2], H * hd) @ wo.reshape(H * hd, D)


def _rank_kv(p: dict, mp) -> dict:
    """``p`` with ``wk`` / ``wv`` / ``bk`` / ``bv`` (whole in serving) cut
    to the kv heads this model rank's q heads read."""
    k0, k1 = mp.kv_heads
    out = dict(p)
    for name in ("wk", "wv", "bk", "bv"):
        if name in p:
            out[name] = p[name].narrow(p[name].dim() - 2, k0, k1 - k0)
    return out


def attention_forward(cfg: ModelConfig, p: dict, h: torch.Tensor,
                      positions: torch.Tensor, mp=None):
    """Prefill attention.  Returns (out (B,S,D), (k, v)) — the final K/V
    (B,S,K,hd) for the prefill cache.  Under ``mp`` with
    ``split_attention`` the heads are this model rank's (k, v its kv
    heads).  Under a serving ``mp`` the K/V returned are every kv head's
    at the positions of the rank's cache block ``mp.span`` (below the
    prompt's end): with the heads split, ``h``'s rows there projected
    through the whole ``wk`` / ``wv``; else rows of the K/V computed."""
    B, S, _ = h.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    tp = mp is not None and mp.split_attention
    pk = p
    if tp:
        h = mp.copy_in(h)
        H, K = H // mp.model_size, K // mp.model_size
        if mp.serving:
            pk = _rank_kv(p, mp)
    q, k, v = _project_qkv(cfg, pk, h, positions)
    qg = q.reshape(B, S, K, H // K, hd)
    ctx = flash_attention(qg.contiguous(), k.contiguous(), v.contiguous(),
                          1.0 / math.sqrt(hd))
    out = _out_proj(cfg, p, ctx.reshape(B, S, H, hd))
    if mp is not None and mp.serving:
        lo, hi = mp.span.lo, min(mp.span.hi, S)
        lo = min(lo, hi)
        if tp:
            k, v = _project_kv(cfg, p, h[:, lo:hi], positions[:, lo:hi])
        else:
            k, v = k[:, lo:hi], v[:, lo:hi]
    return (mp.sum_out(out) if tp else out), (k, v)


def decode_attention_forward(cfg: ModelConfig, p: dict, h: torch.Tensor,
                             cache: dict, cache_index: int, mp=None):
    """One-token decode.  h (B,1,D); cache {'k', 'v'} (B,S_max,K,hd),
    written in place at ``cache_index`` (a host int: the decode loop never
    reads it back from the card).  Under a serving ``mp`` the cache is
    this rank's block of positions (``_decode_on_mesh``)."""
    if mp is not None:
        return _decode_on_mesh(cfg, p, h, cache, cache_index, mp)
    B = h.shape[0]
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    positions = torch.full((B, 1), cache_index, dtype=torch.int32,
                           device=h.device)
    q, k_new, v_new = _project_qkv(cfg, p, h, positions)
    k_cache, v_cache = cache["k"], cache["v"]
    k_cache[:, cache_index] = k_new[:, 0].to(k_cache.dtype)
    v_cache[:, cache_index] = v_new[:, 0].to(v_cache.dtype)

    qg = q.reshape(B, K, H // K, hd)
    ctx = _decode_softmax(cfg, qg, k_cache, v_cache, cache_index)
    out = _out_proj(cfg, p, ctx.reshape(B, H, hd))
    return out[:, None, :], {"k": k_cache, "v": v_cache}


def _splits(cfg: ModelConfig, S_max: int) -> int:
    """JAX's chunk count of the split softmax for a cache of ``S_max``
    positions, or 0 (the full softmax)."""
    nc = cfg.decode_split
    return nc if nc and S_max % nc == 0 else 0


def _decode_softmax(cfg: ModelConfig, qg, k_cache, v_cache,
                    cache_index: int) -> torch.Tensor:
    """softmax(q k / sqrt(hd)) v over a whole cache's positions <=
    ``cache_index``: (B, K, G, hd) in the compute dtype."""
    B, S_max, K, hd = k_cache.shape
    scale = 1.0 / math.sqrt(hd)
    pos = torch.arange(S_max, device=qg.device)
    nc = _splits(cfg, S_max)
    if nc:
        view = (B, nc, S_max // nc, K, hd)
        m_c, l_c, acc_c = _split_partials(
            qg, k_cache.view(view), v_cache.view(view),
            pos.view(nc, -1) <= cache_index, scale)
        return _merge(m_c, l_c, acc_c, m_c.amax(-1)).to(qg.dtype)
    s = torch.einsum("bkgh,bskh->bkgs", qg, k_cache).float() * scale
    s = s.masked_fill(~(pos <= cache_index), float("-inf"))
    probs = torch.softmax(s, dim=-1).to(qg.dtype)
    return torch.einsum("bkgs,bskh->bkgh", probs, v_cache)


def _split_partials(qg, kc, vc, valid, scale: float):
    """Each chunk's float32 max ``m_c`` and sum ``l_c`` (B, K, G, c) and
    P·V ``acc_c`` (B, K, G, c, hd) in the compute dtype, of the chunks
    ``kc`` / ``vc`` (B, c, L, K, hd) whose positions ``valid`` (c, L)
    marks (JAX's ``decode_split`` partials)."""
    s = torch.einsum("bkgh,bcskh->bkgcs", qg, kc).float() * scale
    s = s.masked_fill(~valid, -1e30)
    m_c = s.amax(-1)
    pr = torch.exp(s - m_c[..., None])
    acc_c = torch.einsum("bkgcs,bcskh->bkgch", pr.to(qg.dtype), vc)
    return m_c, pr.sum(-1), acc_c


def _merge(m_c, l_c, acc_c, m) -> torch.Tensor:
    """The chunks' partials weighed by exp(m_c - m) and summed over the
    chunks in order, float32: sum(acc w) / max(sum(l w), 1e-20)."""
    w = torch.exp(m_c - m[..., None])
    num, den = _weighed(l_c, acc_c, w)
    return num / torch.clamp(den, min=1e-20)[..., None]


def _weighed(l_c, acc_c, w):
    """(sum over chunks of acc_c w (B, K, G, hd), of l_c w (B, K, G))."""
    return (acc_c.float() * w[..., None]).sum(-2), (l_c * w).sum(-1)


def _decode_on_mesh(cfg: ModelConfig, p: dict, h: torch.Tensor,
                    cache: dict, cache_index: int, mp):
    """One-token decode on a rank whose cache holds positions [lo, hi) of
    every kv head (JAX's ``cache_seq`` split, ``attention.py:148-203``).
    q: the rank's heads gathered over the model ranks in rank order
    where the heads split, else whole; the new k / v of every kv head
    (the whole ``wk`` / ``wv``), written by the rank whose range holds
    ``cache_index``.  A rank whose cache is not split over the model
    ranks takes ``_decode_softmax`` alone.  Where the model ranks split
    the positions, the softmax is JAX's split softmax in chunks of Sc
    positions: S_max / nc with ``cfg.decode_split`` nc dividing the whole
    cache length S_max (JAX reads the condition on it, ``mp.span``), else
    one chunk of S_max.  A rank cuts its span at the chunk boundaries and
    takes each piece's float32 max m, sum l and P·V acc (the mask at
    -1e30; P cast to the compute dtype before P·V, as JAX's
    ``decode_split`` does; a chunk that straddles two ranks' spans is
    merged as a piece of its own on each, whose ``acc`` is rounded to the
    compute dtype at its own max).  The pieces merge: M the max of m over
    the model ranks (finite: rank 0 holds position 0), w = exp(m - M)
    (0 for a piece with no valid position), ``acc w`` and ``l w`` summed
    over the rank's pieces in order, then over the model ranks in rank
    order, acc / l cast to the compute dtype.  Then the rank's heads
    through ``wo``'s rows, summed over the model ranks (or every head
    through the whole ``wo``)."""
    B = h.shape[0]
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    tp = mp.split_attention
    positions = torch.full((B, 1), cache_index, dtype=torch.int32,
                           device=h.device)
    if tp:
        q = mp.gather_heads(_project_q(cfg, p, h, positions)[:, 0])
        k_new, v_new = _project_kv(cfg, p, h, positions)
    else:
        q, k_new, v_new = _project_qkv(cfg, p, h, positions)
        q = q[:, 0]
    k_cache, v_cache = cache["k"], cache["v"]
    lo, hi, split, S_max = mp.span
    if lo <= cache_index < hi:
        k_cache[:, cache_index - lo] = k_new[:, 0].to(k_cache.dtype)
        v_cache[:, cache_index - lo] = v_new[:, 0].to(v_cache.dtype)

    qg = q.reshape(B, K, G, hd)
    if not split:
        ctx = _decode_softmax(cfg, qg, k_cache, v_cache, cache_index)
    else:
        Sc = S_max // (_splits(cfg, S_max) or 1)
        ctx = _split_on_mesh(qg, k_cache, v_cache, cache_index, lo, Sc,
                             scale, mp)
    ctx = ctx.reshape(B, H, hd)
    if tp:
        h0, h1 = mp.head_range
        out = mp.sum_out(_out_proj(cfg, p, ctx[:, h0:h1]))
    else:
        out = _out_proj(cfg, p, ctx)
    return out[:, None, :], {"k": k_cache, "v": v_cache}


def _split_on_mesh(qg, k_cache, v_cache, cache_index, lo, Sc, scale, mp):
    """JAX's split softmax over a cache whose positions the model ranks
    split: this rank's pieces of the Sc-position chunks merged with the
    other ranks' (``_decode_on_mesh``)."""
    n, hd = k_cache.shape[1], k_cache.shape[3]
    pos = lo + torch.arange(n, device=qg.device)
    if n:
        # the rank's span cut at the chunk boundaries inside it
        cuts = [0] + [c * Sc - lo for c in range(lo // Sc + 1,
                                                 -(-(lo + n) // Sc))] + [n]
        parts = [_split_partials(
            qg, k_cache[:, a:b, None].transpose(1, 2),
            v_cache[:, a:b, None].transpose(1, 2),
            (pos[a:b] <= cache_index)[None], scale)
            for a, b in zip(cuts[:-1], cuts[1:])]
        m_c, l_c, acc_c = (torch.cat(x, dim=3) for x in zip(*parts))
        M = mp.model_max(m_c.amax(-1))
        num, den = _weighed(l_c, acc_c, torch.exp(m_c - M[..., None]))
    else:                                     # an empty span: no pieces
        mp.model_max(qg.new_full(qg.shape[:3], float("-inf"),
                                 dtype=torch.float32))
        num = qg.new_zeros(qg.shape, dtype=torch.float32)
        den = num[..., 0]
    tot = mp.model_sum(torch.cat([num, den[..., None]], dim=-1))
    return (tot[..., :hd] / torch.clamp(tot[..., hd:], min=1e-20)).to(
        qg.dtype)
