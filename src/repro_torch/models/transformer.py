"""LM backbone: period-structured blocks (attention / Mamba-2 mixers,
dense / MoE / no FFN) over depth (counterpart of
``repro/models/transformer.py``).

Parameters are a nested dict of tensors in the JAX params tree's layout —
``{"embed": {"tokens", ["lm_head"]}, "blocks": {"pos<i>": {"norm1",
"mixer", ["norm2", "ffn"]}}, "final_norm"}`` — with the block leaves
stacked on a leading ``blocks`` axis, so ``flatten_tree``'s keys
(``blocks/pos0/mixer/wq``) name the same arrays in both packages
(``repro_torch.interop.lm_params_from_jax``).  Depth is a Python loop over
the stacked leaves' ``unbind`` views (eager PyTorch has no ``scan``); in
training, ``unbind``'s backward stacks each leaf's per-block gradients
once.  ``lm_loss`` is the training objective (``launch/steps.py``).

In training each block is rematerialised as JAX's ``_stack_forward``
does under ``cfg.remat`` (the default): the block runs inside a
non-reentrant ``torch.utils.checkpoint``, so only its input ``h`` (and,
under ``remat_policy == "dots"``, what the policy saves) stays alive until
the backward, which runs the block's forward again before its own.
``"dots"`` is JAX's ``dots_with_no_batch_dims_saveable``: the outputs of
``aten.mm`` / ``aten.addmm`` (an activation by a weight: the
projections, the FFN, the router) are kept, everything else (K7 / K8,
the MoE experts' ``bmm``, norms, elementwise ops) is recomputed; any
other policy is full remat.  The recompute runs the block whole (no
early stop), so each forward collective of a block under ``mp`` runs
twice a step (``ShardPlan.collective_bytes`` counts it), and it re-runs
the same ops on the same inputs: the gradients equal those without
remat, bit for bit.  Prefill and decode never rematerialise.

Leaves are kept in ``cfg.param_dtype``; JAX casts each matmul weight to
``cfg.compute_dtype`` on every use, and ``compute_params`` makes that cast
once (the same numbers), after which every cast here is a no-op.
``init_compute_params`` draws that tree directly, each leaf cast as it is
drawn, so serving never holds the float32 tree.

MoE FFN layers run ``models/moe.py``; ``forward`` returns the sum of their
aux losses over the layers.  On the card, attention layers train through
K7 / K7b and SSM layers through K8 / K8b.  Decode caches are updated in
place; ``decode_step`` returns the same cache tensors and a host int index
(the decode loop never syncs with the card to advance it).

``params_axes`` is JAX's logical dim-name tree of the params (the leaves
of ``init_params``'s tree, stacked leaves led by ``blocks``);
``distributed/sharding.param_specs`` places each leaf by it.  ``forward``
and ``lm_loss`` take an optional ``mp``
(``distributed/model_parallel.ModelParallel``): the params are then this
rank's shards, each leaf is rebuilt (or its compute slice gathered) just
before the block that reads it, and the embedding, the attention, the SSM
mixer, the dense and MoE FFNs, the MoE load-balance term, the head and
the cross-entropy run as that module says.  ``prefill`` and
``decode_step`` take a serving ``mp`` likewise (the rank's params, rows
and decode-state blocks; its vocabulary slice of the logits), and
``decode_state_axes`` is JAX's logical-axes tree of the decode state.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from repro_torch.config import FFN_MOE, FFN_NONE, MIXER_ATTN, ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.frontends import apply_frontend
from repro_torch.models.layers import (
    cast, chunked_cross_entropy, dtype_of, embed_tokens, embedding_axes,
    init_embedding, init_mlp, init_rmsnorm, lm_head_weight, mlp_axes,
    mlp_forward, rmsnorm,
)

#: leaves JAX casts to the compute dtype on use (the matmul weights)
COMPUTE_LEAVES = frozenset({
    "tokens", "lm_head", "wq", "wk", "wv", "wo", "bq", "bk", "bv",
    "w1", "w2", "w3", "in_z", "in_x", "in_B", "in_C", "in_dt",
    "conv_x", "conv_B", "conv_C", "out",
})


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_map_named(fn, tree, name=""):
    if isinstance(tree, dict):
        return {k: _tree_map_named(fn, v, k) for k, v in tree.items()}
    return fn(name, tree)


def _tree_stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _tree_stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _tree_put(dst, src, b: int) -> None:
    """dst[b] = src, leaf by leaf."""
    if isinstance(dst, dict):
        for k in dst:
            _tree_put(dst[k], src[k], b)
    else:
        dst[b].copy_(src)


# ---------------------------------------------------------------------------
# Logical axes
# ---------------------------------------------------------------------------


def _block_axes(cfg: ModelConfig) -> dict:
    axes = {}
    for i, spec in enumerate(cfg.layer_specs()):
        pa = {"norm1": {"scale": ("embed",)}}
        pa["mixer"] = (attn_mod.attention_axes(cfg)
                       if spec.mixer == MIXER_ATTN else ssm_mod.ssm_axes(cfg))
        if spec.ffn != FFN_NONE:
            pa["norm2"] = {"scale": ("embed",)}
            pa["ffn"] = (moe_mod.moe_axes(cfg) if spec.ffn == FFN_MOE
                         else mlp_axes(cfg))
        axes[f"pos{i}"] = pa
    return axes


def params_axes(cfg: ModelConfig) -> dict:
    """Logical dim names of every leaf of ``init_params``'s tree."""
    return {
        "embed": embedding_axes(cfg),
        "blocks": _tree_map(lambda t: ("blocks",) + t, _block_axes(cfg)),
        "final_norm": {"scale": ("embed",)},
    }


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_block(cfg: ModelConfig, gen, device, leaf) -> dict:
    """One block's params; ``leaf(name, x)`` sets each leaf's dtype as it
    is drawn."""
    def draw(init, *args):
        return _tree_map_named(leaf, init(*args, device=device))

    params = {}
    for i, spec in enumerate(cfg.layer_specs()):
        pp = {"norm1": draw(init_rmsnorm, cfg.d_model)}
        pp["mixer"] = draw(attn_mod.init_attention if spec.mixer == MIXER_ATTN
                           else ssm_mod.init_ssm, gen, cfg)
        if spec.ffn != FFN_NONE:
            pp["norm2"] = draw(init_rmsnorm, cfg.d_model)
            pp["ffn"] = draw(moe_mod.init_moe if spec.ffn == FFN_MOE
                             else init_mlp, gen, cfg)
        params[f"pos{i}"] = pp
    return params


def _init_tree(cfg: ModelConfig, gen, device, leaf) -> dict:
    """Blocks drawn one after another into leaves stacked over blocks (one
    block's draw beside the stack at a time; one block is a view)."""
    embed = _tree_map_named(leaf, init_embedding(gen, cfg, device=device))
    nb, stacked = cfg.num_blocks, None
    for b in range(nb):
        blk = _init_block(cfg, gen, device, leaf)
        if nb == 1:
            stacked = _tree_map(lambda x: x[None], blk)
            break
        if stacked is None:
            stacked = _tree_map(lambda x: x.new_empty((nb, *x.shape)), blk)
        _tree_put(stacked, blk, b)
        del blk
    final_norm = _tree_map_named(leaf, init_rmsnorm(cfg.d_model,
                                                    device=device))
    return {"embed": embed, "blocks": stacked, "final_norm": final_norm}


def init_params(cfg: ModelConfig, gen: Optional[torch.Generator], *,
                device=None) -> dict:
    """Random parameters drawn from ``gen`` (a generator on ``device``),
    with ``_dense_init``'s scales, block leaves stacked over blocks, in
    ``cfg.param_dtype``.  ``device="meta"`` (``gen=None``) gives the shapes
    and dtypes only."""
    pdt = dtype_of(cfg.param_dtype)
    return _init_tree(cfg, gen, device, lambda name, x: x.to(pdt))


def compute_params(cfg: ModelConfig, params: dict) -> dict:
    """The params with every matmul weight cast to ``cfg.compute_dtype``
    once (the cast JAX makes on each use); norms, A_log, D_skip, dt_bias
    and the MoE router stay in ``param_dtype``, as JAX uses them."""
    dt = dtype_of(cfg.compute_dtype)
    return _tree_map_named(
        lambda name, x: cast(x, dt) if name in COMPUTE_LEAVES else x, params)


def init_compute_params(cfg: ModelConfig, gen: torch.Generator, *,
                        device=None) -> dict:
    """``compute_params(cfg, init_params(cfg, gen, device=device))``, bit
    for bit, with each leaf cast as soon as it is drawn: the peak is the
    compute tree and one layer's float32 draw, not the whole float32
    tree beside its copy (serving)."""
    pdt, dt = dtype_of(cfg.param_dtype), dtype_of(cfg.compute_dtype)

    def leaf(name, x):
        x = x.to(pdt)
        return cast(x, dt) if name in COMPUTE_LEAVES else x

    return _init_tree(cfg, gen, device, leaf)


def _block(blocks: dict, b: int) -> dict:
    return _tree_map(lambda x: x[b], blocks)


# ---------------------------------------------------------------------------
# Block forward
# ---------------------------------------------------------------------------


def _block_forward(cfg: ModelConfig, bp: dict, h: torch.Tensor, positions,
                   mode: str, caches: Optional[dict], cache_index, mp=None):
    """One period block (cfg.block_size layers).  Returns (h, new_caches,
    aux): the block's MoE aux losses summed in layer order (None without
    MoE layers)."""
    new_caches, aux = {}, None
    for i, spec in enumerate(cfg.layer_specs()):
        pp = bp[f"pos{i}"]
        r = rmsnorm(pp["norm1"], h, cfg.norm_eps)
        nc = None
        if spec.mixer == MIXER_ATTN:
            if mode == "decode":
                out, nc = attn_mod.decode_attention_forward(
                    cfg, pp["mixer"], r, caches[f"pos{i}"], cache_index, mp)
            else:
                out, (k, v) = attn_mod.attention_forward(cfg, pp["mixer"], r,
                                                         positions, mp)
                nc = {"k": k, "v": v} if mode == "prefill" else None
        elif mode == "decode":
            out, nc = ssm_mod.ssm_decode_forward(cfg, pp["mixer"], r,
                                                 caches[f"pos{i}"], mp)
        else:
            out, nc = ssm_mod.ssm_forward(cfg, pp["mixer"], r,
                                          return_cache=(mode == "prefill"),
                                          mp=mp)
        h = h + out
        if spec.ffn != FFN_NONE:
            r = rmsnorm(pp["norm2"], h, cfg.norm_eps)
            if spec.ffn == FFN_MOE:
                out, a = moe_mod.moe_forward(cfg, pp["ffn"], r, mp)
                aux = a if aux is None else aux + a
            else:
                out = mlp_forward(cfg, pp["ffn"], r, mp)
            h = h + out
        if mode in ("prefill", "decode"):
            new_caches[f"pos{i}"] = nc if nc is not None else {}
    return h, new_caches, aux


#: the ops whose outputs ``remat_policy == "dots"`` keeps: the products
#: of an activation by a weight with no batch dim
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_kw(cfg: ModelConfig) -> dict:
    """``checkpoint``'s arguments for ``cfg.remat_policy`` (JAX's
    ``jax.checkpoint(body, policy=...)``): non-reentrant, the whole block
    recomputed (no early stop) and, the blocks drawing no random numbers,
    no RNG state restored."""
    kw = dict(use_reentrant=False, preserve_rng_state=False,
              early_stop=False)
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return kw


def _stack_forward(cfg: ModelConfig, blocks: dict, h, positions, mode: str,
                   caches: Optional[dict] = None, cache_index=None, mp=None):
    """Blocks over depth.  Returns (h, new caches stacked over blocks, the
    MoE aux losses summed over blocks in order; None without MoE).  Under
    ``mp`` each block's leaves are gathered just before it runs (inside
    the rematerialised region in training: the recompute gathers them
    again)."""
    per_block, aux = [], None
    views = None if mp else _tree_map(lambda x: x.unbind(0), blocks)

    def run(h, b, cache):
        bp = mp.block(b) if mp else _tree_map(lambda x: x[b], views)
        return _block_forward(cfg, bp, h, positions, mode, cache,
                              cache_index, mp)

    remat = mode == "train" and cfg.remat and torch.is_grad_enabled()
    kw = _remat_kw(cfg) if remat else None
    for b in range(cfg.num_blocks):
        cache = None if caches is None else _block(caches, b)
        if remat:
            h, nc, a = checkpoint(run, h, b, cache, **kw)
        else:
            h, nc, a = run(h, b, cache)
        per_block.append(nc)
        if a is not None:
            aux = a if aux is None else aux + a
    if mode == "prefill":
        return h, _tree_stack(per_block), aux
    return h, caches, aux   # decode: updated in place; train: None


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def _embed(cfg, params, tokens, frontend, mp=None):
    h = embed_tokens(cfg, params["embed"], tokens, mp)
    h = apply_frontend(cfg, h, frontend)
    positions = torch.arange(h.shape[1], dtype=torch.int32,
                             device=h.device)[None, :]
    return h, positions


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            frontend=None, mp=None):
    """Full forward to the final hidden states.  Returns (h, aux_loss): the
    MoE layers' load-balance losses summed over depth (0 without MoE).
    Under ``mp``, ``params`` are this rank's shards."""
    return _forward(cfg, params, tokens, frontend, mp)[:2]


def _forward(cfg, params, tokens, frontend, mp):
    """(h, aux, the embedding subtree as the step reads it)."""
    embed = mp.embed() if mp else params["embed"]
    h, positions = _embed(cfg, {"embed": embed}, tokens, frontend, mp)
    h, _, aux = _stack_forward(cfg, params["blocks"], h, positions, "train",
                               mp=mp)
    h = rmsnorm(mp.final_norm() if mp else params["final_norm"], h,
                cfg.norm_eps)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h, aux, embed


def lm_loss(cfg: ModelConfig, params: dict, batch: dict, mp=None):
    """batch: {'tokens' (B,S_text), 'labels' (B,S_total), ['frontend']}.
    Returns (CE + 0.01 aux, {"ce", "aux"}).  Under ``mp`` the batch is this
    data rank's rows and each value its share: the data ranks' values add
    up to the whole batch's."""
    h, aux, embed = _forward(cfg, params, batch["tokens"],
                             batch.get("frontend"), mp)
    w_head = lm_head_weight(cfg, embed)
    loss = chunked_cross_entropy(cfg, h, w_head, batch["labels"], mp)
    return loss + 0.01 * aux, {"ce": loss, "aux": aux}


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            frontend=None, mp=None):
    """Prefill: returns (last-position logits (B,V) float32, caches stacked
    over blocks, next_index S).  Under ``mp`` (a serving
    ``ModelParallel``) ``params`` and ``tokens`` are this rank's: the
    logits are its vocabulary slice and the caches its pieces
    (``ShardPlan.splice`` writes them into its decode-state blocks)."""
    embed = mp.embed() if mp else params["embed"]
    h, positions = _embed(cfg, {"embed": embed}, tokens, frontend, mp)
    h, caches, _ = _stack_forward(cfg, params["blocks"], h, positions,
                                  "prefill", mp=mp)
    h = rmsnorm(mp.final_norm() if mp else params["final_norm"], h,
                cfg.norm_eps)
    logits = (h[:, -1] @ lm_head_weight(cfg, embed)).float()
    return (mp.vocab_slice(logits) if mp else logits), caches, h.shape[1]


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      prefilled: int = 0, *, device=None) -> dict:
    """Zero decode caches (leaves stacked over blocks, compute dtype)."""
    dt = dtype_of(cfg.compute_dtype)
    nb = cfg.num_blocks
    caches = {}
    for i, spec in enumerate(cfg.layer_specs()):
        if spec.mixer == MIXER_ATTN:
            shape = (nb, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
            caches[f"pos{i}"] = {
                "k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}
        else:
            one = ssm_mod.init_ssm_cache(cfg, batch, dt, device=device)
            caches[f"pos{i}"] = _tree_map(
                lambda x: x[None].repeat(nb, *([1] * x.dim())), one)
    return {"caches": caches, "index": int(prefilled)}


def decode_state_axes(cfg: ModelConfig) -> dict:
    """Logical axes of the decode state (JAX's, key for key; mirrors
    ``init_decode_state``): the attention caches' positions are
    ``cache_seq``, which the model axis takes where no other dim of a
    cache leaf can (``ACT_MODEL_PREF`` has no ``kv_heads``)."""
    per_pos = {}
    for i, spec in enumerate(cfg.layer_specs()):
        if spec.mixer == MIXER_ATTN:
            kv = ("blocks", "batch", "cache_seq", "kv_heads", "head_dim")
            per_pos[f"pos{i}"] = {"k": kv, "v": kv}
        else:
            per_pos[f"pos{i}"] = {
                "ssm": ("blocks", "batch", "ssm_heads", None, "ssm_state"),
                "conv": {
                    "x": ("blocks", "batch", None, "d_inner"),
                    "B": ("blocks", "batch", None, "ssm_state"),
                    "C": ("blocks", "batch", None, "ssm_state"),
                },
            }
    return {"caches": per_pos, "index": ()}


def decode_step(cfg: ModelConfig, params: dict, state: dict,
                tokens: torch.Tensor, mp=None):
    """One decode step.  tokens (B,1) -> (logits (B,V) float32, new state);
    the caches are written in place.  Under ``mp`` (a serving
    ``ModelParallel``) the params, tokens and state are this rank's
    blocks and the logits its vocabulary slice."""
    embed = mp.embed() if mp else params["embed"]
    h = embed_tokens(cfg, embed, tokens, mp)
    idx = state["index"]
    h, caches, _ = _stack_forward(cfg, params["blocks"], h, None, "decode",
                                  caches=state["caches"], cache_index=idx,
                                  mp=mp)
    h = rmsnorm(mp.final_norm() if mp else params["final_norm"], h,
                cfg.norm_eps)
    logits = (h[:, 0] @ lm_head_weight(cfg, embed)).float()
    if mp:
        logits = mp.vocab_slice(logits)
    return logits, dict(state, caches=caches, index=idx + 1)
