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
``decode_split`` (a flash-decoding split softmax for a sharded cache) is set
by no config and no caller and is not carried over.  The KV cache is
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
rank order (Megatron's f and g: ``copy_in``, ``sum_out``).
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


def _project_qkv(cfg: ModelConfig, p: dict, h: torch.Tensor,
                 positions: torch.Tensor):
    dt = cfg.compute_dtype
    q = _proj(h, cast(p["wq"], dt))
    k = _proj(h, cast(p["wk"], dt))
    v = _proj(h, cast(p["wv"], dt))
    if cfg.qkv_bias:
        q = q + cast(p["bq"], dt)
        k = k + cast(p["bk"], dt)
        v = v + cast(p["bv"], dt)
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _out_proj(cfg: ModelConfig, p: dict, ctx: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd", ctx, wo)."""
    wo = cast(p["wo"], cfg.compute_dtype)
    H, hd, D = wo.shape
    return ctx.reshape(*ctx.shape[:-2], H * hd) @ wo.reshape(H * hd, D)


def attention_forward(cfg: ModelConfig, p: dict, h: torch.Tensor,
                      positions: torch.Tensor, mp=None):
    """Prefill attention.  Returns (out (B,S,D), (k, v)) — the final K/V
    (B,S,K,hd) for the prefill cache.  Under ``mp`` with
    ``split_attention`` the heads are this model rank's (k, v its kv
    heads)."""
    B, S, _ = h.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    tp = mp is not None and mp.split_attention
    if tp:
        h = mp.copy_in(h)
        H, K = H // mp.model_size, K // mp.model_size
    q, k, v = _project_qkv(cfg, p, h, positions)
    qg = q.reshape(B, S, K, H // K, hd)
    ctx = flash_attention(qg.contiguous(), k.contiguous(), v.contiguous(),
                          1.0 / math.sqrt(hd))
    out = _out_proj(cfg, p, ctx.reshape(B, S, H, hd))
    return (mp.sum_out(out) if tp else out), (k, v)


def decode_attention_forward(cfg: ModelConfig, p: dict, h: torch.Tensor,
                             cache: dict, cache_index: int):
    """One-token decode.  h (B,1,D); cache {'k', 'v'} (B,S_max,K,hd),
    written in place at ``cache_index`` (a host int: the decode loop never
    reads it back from the card)."""
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
