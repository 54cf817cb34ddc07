"""Top-k MoE FFN with group-local routing and a capacity gather
(counterpart of ``repro/models/moe.py``).

Each batch row is a routing group of up to ``cfg.moe_seq_chunk`` tokens:
float32 router logits, softmax, top-k, the Switch load-balance loss, each
expert's position per slot by a cumsum over the slots in s-major, j-minor
order, a capacity-C gather into per-expert buffers, the three SwiGLU
products as ``bmm`` over the experts, and the gate-weighted combine.  JAX
computes all of it in jnp, outside any Pallas kernel, so the port does it
in torch ops.  ``moe_axes`` is JAX's logical-axes tree.  Under a
``distributed/model_parallel.ModelParallel`` with ``split_moe`` (JAX's
``constrain`` of the expert hidden on ``ffn``) the three products run on
the model rank's ``ffn`` slice of ``w1`` / ``w3`` / ``w2``: routing,
dispatch and the C-1 rule run whole and alike on every model rank (the
router is whole), the dispatched rows and the gates enter through
``copy_in``, and the combined (B, S, D) output is a partial summed over
the model ranks in rank order.  On a mesh the load-balance term's expert
fractions ``ce``, a mean over every row of the batch, count the rows of
every data rank: the ranks' counts are summed in rank order before the
product, so the ranks' aux losses add up to the whole batch's.

Three points where the port is written to give JAX's numbers:

- *Tie order.* ``lax.top_k`` puts the lower expert first among equal
  gates; ``torch.topk`` promises no order, so the top k come from a stable
  descending sort.
- *The slot at C-1 of an overflowing expert.* JAX scatters every slot
  into the (B, E, C) token buffer, a dropped one (position >= C) clipped to
  C-1 with the sentinel S; XLA applies the updates in order, so the last
  dropped slot's sentinel overwrites the token kept at C-1.  That token
  gathers the zero row and adds nothing to the output, though it is kept.
  The port states this as a rule: an expert with more than C slots holds
  the sentinel at C-1.
- *The combine's rounding.* JAX scatter-adds the k weighted contributions
  of a token one slot at a time from a zero of the compute dtype; the port
  adds them in the same order, so a bfloat16 output rounds after each add
  as JAX's does.

Gradients sum in a fixed order on the card: the dispatch and the combine
are autograd functions whose backwards are gathers (``index_select`` and
sums over the k slots in order), not the backwards of ``index_select`` /
``gather``, which scatter with atomics there.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.layers import _dense_init, cast


def moe_axes(cfg: ModelConfig) -> dict:
    return {
        "router": ("embed", "experts"),
        "w1": ("experts", "embed", "ffn"),
        "w3": ("experts", "embed", "ffn"),
        "w2": ("experts", "ffn", "embed"),
    }


def init_moe(gen: torch.Generator, cfg: ModelConfig, *, device=None) -> dict:
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": _dense_init(gen, (D, E), 0.02, device=device),
        "w1": _dense_init(gen, (E, D, Fd), device=device),
        "w3": _dense_init(gen, (E, D, Fd), device=device),
        "w2": _dense_init(gen, (E, Fd, D), device=device,
                          scale=1.0 / math.sqrt(Fd)
                          / math.sqrt(2 * cfg.num_layers)),
    }


def capacity(cfg: ModelConfig, group_tokens: int) -> int:
    """Slots per expert and group: ceil(k * tokens * factor / E), at least
    k, rounded up to a multiple of 4 when above 4."""
    c = math.ceil(cfg.top_k * group_tokens * cfg.capacity_factor
                  / cfg.num_experts)
    c = max(c, cfg.top_k)
    return math.ceil(c / 4) * 4 if c > 4 else c


def moe_forward(cfg: ModelConfig, p: dict, h: torch.Tensor, mp=None):
    """h (B,S,D) -> (out (B,S,D), aux loss, a float32 scalar).  A sequence
    longer than ``cfg.moe_seq_chunk`` and a multiple of it is routed one
    chunk at a time (the dispatch buffers scale with the chunk), the aux
    losses summed in chunk order and divided by their number.  Under
    ``mp`` the rows are this data rank's and the aux loss is its share
    of the whole batch's."""
    B, S, D = h.shape
    G = min(cfg.moe_seq_chunk, S)
    if S > G and S % G == 0:
        nch = S // G
        outs = []
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(nch):
            out_c, a = _moe_group(cfg, p, h[:, i * G:(i + 1) * G], mp)
            outs.append(out_c)
            aux = aux + a
        return torch.cat(outs, dim=1), aux / nch
    return _moe_group(cfg, p, h, mp)


class _Dispatch(torch.autograd.Function):
    """xe[r] = table[src[r]] for the (E*B*C,) expert rows, table = h's rows
    (B*S, D) and a zero row (the sentinel B*S).  The backward gives each
    token the sum, over its k slots in order, of its rows' gradients: slot
    (t, j) sits at expert row ``cell[t, j]``, and holds token t there unless
    it was dropped (or lost at C-1), when ``src[cell[t, j]] != t``."""

    @staticmethod
    def forward(ctx, h_flat, src, cell):
        ctx.save_for_backward(src, cell)
        table = torch.cat([h_flat, h_flat.new_zeros(1, h_flat.shape[1])])
        return table.index_select(0, src)

    @staticmethod
    def backward(ctx, dxe):
        src, cell = ctx.saved_tensors
        T, k = cell.shape
        tok = torch.arange(T, device=cell.device)
        dh = None
        for j in range(k):
            held = (src.index_select(0, cell[:, j]) == tok)[:, None]
            g = torch.where(held, dxe.index_select(0, cell[:, j]), 0.0)
            dh = g if dh is None else dh + g
        return dh, None, None


class _Combine(torch.autograd.Function):
    """out[t] = sum over j in order of w[t, j] * ye[cell[t, j]].  The
    backward to ye gathers each kept slot's w * dout through ``slot`` (the
    slot held by each expert row, the sentinel T*k where none is: those
    rows get 0); a dropped slot has w = 0 and contributes exactly 0."""

    @staticmethod
    def forward(ctx, ye, w, cell, slot):
        ctx.save_for_backward(ye, w, cell, slot)
        out = None
        for j in range(cell.shape[1]):
            c = ye.index_select(0, cell[:, j]) * w[:, j, None]
            out = c if out is None else out + c
        return out

    @staticmethod
    def backward(ctx, dout):
        ye, w, cell, slot = ctx.saved_tensors
        T, k = cell.shape
        dcontrib = (dout[:, None, :] * w[:, :, None]).reshape(T * k, -1)
        dcontrib = torch.cat([dcontrib, dcontrib.new_zeros(1, ye.shape[1])])
        dye = dcontrib.index_select(0, slot)
        dw = torch.stack([
            (dout.float() * ye.index_select(0, cell[:, j]).float()).sum(-1)
            for j in range(k)], dim=1).to(w.dtype)
        return dye, dw, None, None


def _route(cfg: ModelConfig, p: dict, h: torch.Tensor, mp=None):
    """(top_g (B,S,k) normalised, top_e (B,S,k), aux): float32 gates,
    experts in descending gate order, the lower index first among equal
    gates (``lax.top_k``'s order), and the Switch load-balance loss (under
    a training ``mp``, this data rank's share of it; a serving one drops
    the loss, and takes no sum over the data ranks for it)."""
    E, k = cfg.num_experts, cfg.top_k
    logits = h.float() @ p["router"].float()
    gates = torch.softmax(logits, dim=-1)
    srt, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_g, top_e = srt[..., :k], idx[..., :k]
    top_g = top_g / torch.clamp(top_g.sum(-1, keepdim=True), min=1e-9)
    S = h.shape[1]
    me = gates.mean(dim=1)                                        # (B,E)
    frac = F.one_hot(top_e[..., 0], E).float().sum(dim=1) / S     # (B,E)
    if mp is None or mp.serving:    # serving drops the aux loss
        ce = frac.mean(dim=0)
        aux = E * torch.mean(torch.sum(me * ce[None], dim=-1))
    else:                       # every data rank's rows, in rank order
        rows = h.shape[0] * mp.data_size
        ce = mp.data_sum(frac.sum(dim=0)) / rows
        aux = E * (torch.sum(torch.sum(me * ce[None], dim=-1)) / rows)
    return top_g, top_e, aux


def _moe_group(cfg: ModelConfig, p: dict, h: torch.Tensor, mp=None):
    B, S, D = h.shape
    E, k = cfg.num_experts, cfg.top_k
    C = capacity(cfg, S)
    dt = cfg.compute_dtype
    top_g, top_e, aux = _route(cfg, p, h, mp)

    # --- group-local dispatch: slots in s-major, j-minor order ------------
    flat_e = top_e.reshape(B, S * k)
    onehot = F.one_hot(flat_e, E)                                 # (B,S*k,E)
    pos = torch.cumsum(onehot, dim=1).gather(-1, flat_e[..., None])[..., 0] - 1
    keep = pos < C
    safe_pos = torch.clamp(pos, max=C - 1)
    b_idx = torch.arange(B, device=h.device)[:, None]
    # expert rows are (e, b, c) in the (E, B*C, D) layout of the products
    cell = (flat_e * B + b_idx) * C + safe_pos                    # (B,S*k)
    rows = E * B * C
    dump = torch.full_like(cell, rows)          # dropped slots: a spare row
    target = torch.where(keep, cell, dump).reshape(-1)
    tok = (b_idx * S + torch.arange(S, device=h.device).repeat_interleave(k)
           ).reshape(-1)
    src = torch.full((rows + 1,), B * S, dtype=torch.long, device=h.device)
    src.scatter_(0, target, tok)                # kept targets are distinct
    slot = torch.full((rows + 1,), B * S * k, dtype=torch.long,
                      device=h.device)
    slot.scatter_(0, target, torch.arange(B * S * k, device=h.device))
    src, slot = src[:rows], slot[:rows]
    over = (onehot.sum(dim=1) > C).T.reshape(-1)                  # (E*B,)
    last = torch.arange(E * B, device=h.device) * C + (C - 1)
    src[last] = torch.where(over, B * S, src[last])               # JAX's C-1

    cell = cell.reshape(B * S, k)
    tp = mp is not None and mp.split_moe
    xe = _Dispatch.apply((mp.copy_in(h) if tp else h).reshape(B * S, D),
                         src, cell)
    w1, w3, w2 = cast(p["w1"], dt), cast(p["w3"], dt), cast(p["w2"], dt)
    xe = xe.reshape(E, B * C, D)
    a = torch.bmm(xe, w1)
    g = torch.bmm(xe, w3)
    ye = torch.bmm(F.silu(a) * g, w2).reshape(rows, D)

    # --- combine: gather each slot's expert row, weight, add over j -------
    w = torch.where(keep, top_g.reshape(B, S * k), 0.0).to(ye.dtype)
    w = w.reshape(B * S, k)
    if tp:      # a rank's dw covers its ffn slice: summed in rank order
        w = mp.copy_in(w)
    out = _Combine.apply(ye, w, cell, slot).reshape(B, S, D).to(h.dtype)
    return (mp.sum_out(out) if tp else out), aux
