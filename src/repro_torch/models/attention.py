"""GQA attention: the prefill path through K7 and the KV-cache decode path
(counterpart of ``repro/models/attention.py``).

``attention_forward`` runs the causal attention through K7
(``repro_torch.kernels.flash_attention``): a CUDA tensor launches the
hand-written kernel, a CPU tensor takes its plain version.  There is no
``attn_impl`` switch and no jnp full / chunked fallback (``attn_chunk`` and
``attn_chunk_threshold`` are not read), as the encoder has no
``use_pallas``: the port always takes the kernel's path.

``decode_attention_forward`` has no kernel in the JAX package either
(einsum, masked softmax, einsum) and stays in torch ops.  JAX's
``decode_split`` (a flash-decoding split softmax over ``decode_split``
chunks of the cache, which ``benchmarks/perf_iterations.py`` sets) is not
carried over (ROADMAP A); a cache split over a mesh's model ranks merges
the ranks' partials instead (``_decode_on_mesh``).  The KV cache is
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
    S_max = k_cache.shape[1]
    s = torch.einsum("bkgh,bskh->bkgs", qg, k_cache).float() * (
        1.0 / math.sqrt(hd))
    valid = torch.arange(S_max, device=h.device) <= cache_index
    s = s.masked_fill(~valid, float("-inf"))
    probs = torch.softmax(s, dim=-1).to(qg.dtype)
    ctx = torch.einsum("bkgs,bskh->bkgh", probs, v_cache)
    out = _out_proj(cfg, p, ctx.reshape(B, H, hd))
    return out[:, None, :], {"k": k_cache, "v": v_cache}


def _decode_on_mesh(cfg: ModelConfig, p: dict, h: torch.Tensor,
                    cache: dict, cache_index: int, mp):
    """One-token decode on a rank whose cache holds positions [lo, hi) of
    every kv head (JAX's ``cache_seq`` split, ``attention.py:148-203``).
    q: the rank's heads gathered over the model ranks in rank order
    where the heads split, else whole; the new k / v of every kv head
    (the whole ``wk`` / ``wv``), written by the rank whose range holds
    ``cache_index``.  Where the cache splits over the model ranks each
    rank takes the float32 max m, sum l and P·V acc over its valid
    positions (p <= cache_index; m = -inf and l = acc = 0 where it has
    none; P cast to the compute dtype before P·V, as JAX's
    ``decode_split`` does), and the partials merge: M the max of m over
    the model ranks, w = exp(m - M) (0 where m = -inf: rank 0 holds
    position 0, so M is finite), l and acc scaled by w and summed in
    rank order, acc / l cast to the compute dtype.  Then the rank's heads through ``wo``'s rows,
    summed over the model ranks (or every head through the whole
    ``wo``)."""
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
    lo, hi, split = mp.span
    if lo <= cache_index < hi:
        k_cache[:, cache_index - lo] = k_new[:, 0].to(k_cache.dtype)
        v_cache[:, cache_index - lo] = v_new[:, 0].to(v_cache.dtype)

    qg = q.reshape(B, K, G, hd)
    n = k_cache.shape[1]
    s = torch.einsum("bkgh,bskh->bkgs", qg, k_cache).float() * scale
    valid = lo + torch.arange(n, device=h.device) <= cache_index
    s = s.masked_fill(~valid, float("-inf"))
    if split:
        if n:
            m = s.amax(-1)
        else:
            m = s.new_full((B, K, G), float("-inf"))
        mine = torch.isfinite(m)
        pr = torch.exp(s - torch.where(mine, m, 0.0)[..., None])
        acc = torch.einsum("bkgs,bskh->bkgh", pr.to(qg.dtype),
                           v_cache).float()
        M = mp.model_max(m)
        w = torch.where(mine, torch.exp(torch.where(mine, m, M) - M), 0.0)
        parts = torch.cat([acc * w[..., None], (pr.sum(-1) * w)[..., None]],
                          dim=-1)
        tot = mp.model_sum(parts)
        ctx = (tot[..., :hd] / torch.clamp(tot[..., hd:], min=1e-20)).to(
            qg.dtype)
    else:
        probs = torch.softmax(s, dim=-1).to(qg.dtype)
        ctx = torch.einsum("bkgs,bskh->bkgh", probs, v_cache)
    ctx = ctx.reshape(B, H, hd)
    if tp:
        h0, h1 = mp.head_range
        out = mp.sum_out(_out_proj(cfg, p, ctx[:, h0:h1]))
    else:
        out = _out_proj(cfg, p, ctx)
    return out[:, None, :], {"k": k_cache, "v": v_cache}
