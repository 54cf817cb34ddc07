"""Shared layers of the LM backbone: norms, RoPE, SwiGLU MLP, embeddings,
the chunked cross-entropy (counterpart of ``repro/models/layers.py``).

Parameters are plain dicts of tensors in the JAX package's tree layout
(``{"w1": (D, F), ...}``); every function is a pure function of them.  The
logical-axes trees of the JAX ``init_*`` functions are ``mlp_axes`` and
``embedding_axes`` (``distributed/sharding.spec_for`` places each leaf by
them); JAX's ``constrain`` calls are left out.  Under a
``distributed/model_parallel.ModelParallel`` whose rules put the model
axis on ``ffn``, ``mlp_forward`` runs tensor-parallel: ``w1`` / ``w3``
column slices and a ``w2`` row slice a rank, between copy-in and
sum-out; ``chunked_cross_entropy`` divides by the count of labels summed
over the data ranks.  Where the model axis splits the vocabulary (JAX's
``constrain`` of the logits on ``vocab``), ``embed_tokens``, the head and
the loss run on each model rank's vocabulary range
(``vocab_parallel_lse``); under the SSM split ``rmsnorm_gated`` takes its
mean of squares over every model rank's ``d_inner`` columns.

Gradients sum in a fixed order on the card: the embedding gather's
backward is a one-hot matmul (``take_rows``), not ``index_add_``, which
sums with atomics there.
"""

from __future__ import annotations

import math
from functools import lru_cache

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype string ("float32", "bfloat16")."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _dense_init(gen: torch.Generator, shape, scale=None, *,
                device=None) -> torch.Tensor:
    """Standard normal * scale in float32; the default scale is
    1/sqrt(fan_in), fan_in = shape[0] (shape[-1] for a vector)."""
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                       device=device).mul_(scale)


def cast(x: torch.Tensor, dtype: str | torch.dtype) -> torch.Tensor:
    """``x`` in ``dtype`` (no copy when it already is)."""
    dt = dtype_of(dtype) if isinstance(dtype, str) else dtype
    return x if x.dtype == dt else x.to(dt)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int, *, device=None) -> dict:
    return {"scale": torch.ones(d, dtype=torch.float32, device=device)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"]).to(x.dtype)


def rmsnorm_gated(scale: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
                  eps: float, mp=None) -> torch.Tensor:
    """Mamba-2 gated norm: RMSNorm(x * silu(z)) * scale.  Under ``mp``
    (the SSM split) ``x`` / ``z`` / ``scale`` are this model rank's
    ``d_inner`` columns: the mean of squares is over the whole width, the
    ranks' sums of squares summed in rank order (``all_sum``)."""
    x32 = x.float() * F.silu(z.float())
    if mp is None:
        var = x32.square().mean(-1, keepdim=True)
    else:
        var = mp.all_sum(x32.square().sum(-1, keepdim=True)) / (
            x32.shape[-1] * mp.model_size)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _rope_freqs(half: int, theta: float, device: torch.device
                ) -> torch.Tensor:
    """1 / theta**(arange(half)/half) in float32, computed on the CPU and
    copied to ``device`` once: the card's ``pow`` may round a frequency one
    ulp away from the CPU's, and an angle is that frequency times a
    position of up to tens of thousands."""
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32) / half))
    return freqs.to(device)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (..., S) -> cos / sin (..., S, head_dim // 2), float32."""
    freqs = _rope_freqs(head_dim // 2, float(theta), positions.device)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x (B,S,H,hd); cos / sin (B,S,half) or (S,half)."""
    half = x.shape[-1] // 2
    if cos.dim() == 2:                       # (S, half)
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:                                    # (B, S, half)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.cat([r1, r2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Dense (SwiGLU) MLP
# ---------------------------------------------------------------------------


def mlp_axes(cfg: ModelConfig) -> dict:
    return {"w1": ("embed", "ffn"), "w3": ("embed", "ffn"),
            "w2": ("ffn", "embed")}


def init_mlp(gen: torch.Generator, cfg: ModelConfig, *, device=None) -> dict:
    D, Fd = cfg.d_model, cfg.d_ff
    return {
        "w1": _dense_init(gen, (D, Fd), device=device),
        "w3": _dense_init(gen, (D, Fd), device=device),
        "w2": _dense_init(gen, (Fd, D), device=device,
                          scale=1.0 / math.sqrt(Fd)
                          / math.sqrt(2 * cfg.num_layers)),
    }


def mlp_forward(cfg: ModelConfig, p: dict, h: torch.Tensor,
                mp=None) -> torch.Tensor:
    """SwiGLU.  Under ``mp`` with ``split_mlp``, ``p`` holds this model
    rank's ``ffn`` slices and the partial outputs are summed over the
    model ranks in rank order."""
    tp = mp is not None and mp.split_mlp
    if tp:
        h = mp.copy_in(h)
    dt = cfg.compute_dtype
    a = h @ cast(p["w1"], dt)
    g = h @ cast(p["w3"], dt)
    out = (F.silu(a) * g) @ cast(p["w2"], dt)
    return mp.sum_out(out) if tp else out


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------


def embedding_axes(cfg: ModelConfig) -> dict:
    axes = {"tokens": ("vocab", "embed")}
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


def init_embedding(gen: torch.Generator, cfg: ModelConfig, *,
                   device=None) -> dict:
    V, D = cfg.vocab_size, cfg.d_model
    params = {"tokens": _dense_init(gen, (V, D), 0.02, device=device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = _dense_init(gen, (D, V), device=device)
    return params


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        onehot = torch.zeros(idx.numel(), ctx.rows, dtype=grad.dtype,
                             device=grad.device)
        onehot.scatter_(1, idx[:, None], 1.0)      # one 1 a row: no sums
        return onehot.t() @ grad, None


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table.index_select(0, idx)`` (idx (n,) int64); its gradient sums
    the rows' gradients as a one-hot matmul, in a fixed order."""
    if torch.is_grad_enabled() and table.requires_grad:
        return _TakeRows.apply(table, idx)
    # lint: allow[R4] no autograd graph here: a gradient takes _TakeRows
    return table.index_select(0, idx)


def embed_tokens(cfg: ModelConfig, p: dict, tokens: torch.Tensor,
                 mp=None) -> torch.Tensor:
    """tokens (B,S) integer -> (B,S,D) in the compute dtype (a gather on
    the device: no host sync).  Under ``mp`` with ``split_vocab`` the table
    holds this model rank's vocabulary range: the rows of the words in it
    (zero for the others), summed over the model ranks in rank order."""
    table = cast(p["tokens"], cfg.compute_dtype)
    idx = tokens.reshape(-1).long()
    if mp is None or not mp.split_vocab:
        flat = take_rows(table, idx)
    else:
        local = idx - mp.vocab_range[0]
        mine = (local >= 0) & (local < table.shape[0])
        flat = take_rows(table, torch.where(mine, local, 0))
        flat = mp.sum_out(torch.where(mine[:, None], flat, 0.0))
    return flat.reshape(*tokens.shape, table.shape[1])


def lm_head_weight(cfg: ModelConfig, embed_params: dict) -> torch.Tensor:
    """(D, V) in the compute dtype (the tied table's transpose is a view);
    under a vocabulary split, the rank's (D, V / m) columns, as its
    ``embed`` holds them."""
    if cfg.tie_embeddings:
        return cast(embed_params["tokens"], cfg.compute_dtype).t()
    return cast(embed_params["lm_head"], cfg.compute_dtype)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def chunked_cross_entropy(cfg: ModelConfig, h: torch.Tensor,
                          w_head: torch.Tensor, labels: torch.Tensor,
                          mp=None) -> torch.Tensor:
    """Mean CE over labels >= 0; logits materialized ``loss_chunk`` tokens
    at a time along seq (bounds the (B, chunk, V) forward transient for
    257k vocabs), float32, the chunks summed in order, then the remainder.
    h (B,S,D), w_head (D,V), labels (B,S) integer.  Under ``mp`` the rows
    are this data rank's: the count of labels is summed over the data
    ranks in rank order, so the ranks' losses add up to the whole batch's
    mean.  With ``split_vocab``, ``w_head`` is the rank's vocabulary
    columns (``vocab_parallel_lse``) and ``h`` enters through ``copy_in``."""
    B, S, D = h.shape
    C = min(cfg.loss_chunk, S)
    n_chunks = S // C
    vp = mp is not None and mp.split_vocab
    if vp:
        h = mp.copy_in(h)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    bounds = [(c * C, (c + 1) * C) for c in range(n_chunks)]
    if S > n_chunks * C:
        bounds.append((n_chunks * C, S))
    for a, b in bounds:
        y = labels[:, a:b].long()
        logits = (h[:, a:b] @ w_head).float()
        if vp:
            lse, gold = vocab_parallel_lse(logits, y, mp)
        else:
            lse = torch.logsumexp(logits, dim=-1)
            # one index a row: the gather's backward writes, never sums
            gold = logits.gather(-1, y.clamp(min=0)[..., None])[..., 0]
        valid = (y >= 0).float()
        tot = tot + torch.sum((lse - gold) * valid)
        cnt = cnt + torch.sum(valid)
    if mp is not None:
        cnt = mp.data_sum(cnt)
    return tot / torch.clamp(cnt, min=1.0)


def vocab_parallel_lse(logits: torch.Tensor, y: torch.Tensor, mp):
    """(log-sum-exp, gold logit), each (B, C), of logits split over the
    model ranks by vocabulary: ``logits`` (B, C, V_r) float32 are this
    rank's columns ``mp.vocab_range``, ``y`` the whole labels.  The shift
    is the max over the model ranks; the sums of exps and the gold logit
    (the owning rank's, zero elsewhere) are summed over the model ranks in
    rank order (``sum_out``: each rank differentiates its own columns,
    its softmax less its one-hot)."""
    lo, hi = mp.vocab_range
    shift = mp.model_max(logits.detach().amax(-1))
    local = y - lo
    mine = (local >= 0) & (local < hi - lo)
    gold = logits.gather(-1, torch.where(mine, local, 0)[..., None])[..., 0]
    parts = torch.stack([torch.exp(logits - shift[..., None]).sum(-1),
                         torch.where(mine, gold, 0.0)])
    sumexp, gold = mp.sum_out(parts)
    return shift + torch.log(sumexp), gold
