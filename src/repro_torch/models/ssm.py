"""Mamba-2 / SSD mixer (counterpart of ``repro/models/ssm.py``).

Prefill runs the SSD chunked scan with its intra-chunk part through K8
(``repro_torch.kernels.ssd_scan``: a CUDA tensor launches the hand-written
kernel, a CPU tensor takes its plain version); there is no ``attn_impl``
switch.  Decode is the O(1) recurrent update in torch ops (the JAX package
has no kernel there either).  The plain chunked oracle ``ssd_chunked``
lives beside K8 in ``kernels/ssd_scan/ops.py``.

Layout: d_inner is heads-major, x.reshape(B,S,nh,hp).  The decode caches
are updated in place (``copy_`` into the caller's tensors) where JAX
returns new arrays; the returned dict holds the same tensors.
``ssm_axes`` is JAX's logical-axes tree.  Under a
``distributed/model_parallel.ModelParallel`` with ``split_ssm`` (JAX's
``constrain`` of ``z`` / ``x`` on ``d_inner``), ``ssm_forward`` runs on
the model rank's heads: ``in_z`` / ``in_x`` / ``in_dt`` give its
``d_inner`` / ``ssm_heads`` columns, ``conv_x`` / ``A_log`` / ``D_skip``
/ ``dt_bias`` / ``norm`` are its slices, K8 / K8b run on (B, S, nh / m,
hp), ``B`` and ``C`` are computed whole and enter through ``copy_in`` (so
``in_B`` / ``in_C`` keep the same gradient bits on every model rank), the
gated norm's mean is over every rank's columns, and ``out``'s rows give a
partial output summed over the model ranks in rank order; prefill's cache
is then the rank's heads' state and ``d_inner`` tail, and
``ssm_decode_forward`` under a serving ``mp`` runs on them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models.layers import _dense_init, cast, rmsnorm_gated


def ssm_axes(cfg: ModelConfig) -> dict:
    return {
        "in_z": ("embed", "d_inner"),
        "in_x": ("embed", "d_inner"),
        "in_B": ("embed", "ssm_state"),
        "in_C": ("embed", "ssm_state"),
        "in_dt": ("embed", "ssm_heads"),
        "conv_x": ("conv", "d_inner"),
        "conv_B": ("conv", "ssm_state"),
        "conv_C": ("conv", "ssm_state"),
        "A_log": ("ssm_heads",),
        "D_skip": ("ssm_heads",),
        "dt_bias": ("ssm_heads",),
        "norm": ("d_inner",),
        "out": ("d_inner", "embed"),
    }


def init_ssm(gen: torch.Generator, cfg: ModelConfig, *, device=None) -> dict:
    D, din, ds, nh, cw = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                          cfg.ssm_heads, cfg.ssm_conv)

    def dense(shape, scale=None):
        return _dense_init(gen, shape, scale, device=device)

    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_z": dense((D, din)),
        "in_x": dense((D, din)),
        "in_B": dense((D, ds)),
        "in_C": dense((D, ds)),
        "in_dt": dense((D, nh), 0.02),
        "conv_x": dense((cw, din), 1.0 / math.sqrt(cw)),
        "conv_B": dense((cw, ds), 1.0 / math.sqrt(cw)),
        "conv_C": dense((cw, ds), 1.0 / math.sqrt(cw)),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "D_skip": torch.ones(nh, **f32),
        "dt_bias": torch.zeros(nh, **f32),
        "norm": torch.ones(din, **f32),
        "out": dense((din, D), 1.0 / math.sqrt(din)
                     / math.sqrt(2 * cfg.num_layers)),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) as ``jax.nn.softplus`` computes it (logaddexp(x, 0))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv + SiLU: x (B,S,C), w (cw,C)."""
    cw, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, cw - 1, 0))
    out = torch.zeros_like(x)
    for i in range(cw):
        out = out + xp[:, i:i + S, :] * w[i][None, None, :]
    return F.silu(out)


def _projections(cfg: ModelConfig, p: dict, h: torch.Tensor,
                 h_heads: torch.Tensor | None = None):
    """z, x, B, C, dt of ``h``; z, x and dt from ``h_heads`` where given
    (the model rank's copy-in)."""
    dt_ = cfg.compute_dtype
    hh = h if h_heads is None else h_heads
    z, x, dt = (hh @ cast(p[n], dt_) for n in ("in_z", "in_x", "in_dt"))
    Bc, Cc = (h @ cast(p[n], dt_) for n in ("in_B", "in_C"))
    return z, x, Bc, Cc, dt


def ssm_forward(cfg: ModelConfig, p: dict, h: torch.Tensor, *,
                return_cache: bool = False, mp=None):
    """Prefill.  h (B,S,D) -> out (B,S,D) and, with ``return_cache``, the
    decode cache: the final SSM state (compute dtype) and the last cw-1 raw
    (pre-conv, pre-SiLU) projections of x, B and C.  Under ``mp`` with
    ``split_ssm``, ``p`` holds this model rank's heads (the cache, its
    heads')."""
    B, S, _ = h.shape
    nh, hp, cw = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_conv
    dt_ = cfg.compute_dtype
    tp = mp is not None and mp.split_ssm
    if tp:
        nh //= mp.model_size
    z, x, Bc, Cc, dt_raw = _projections(cfg, p, h,
                                        mp.copy_in(h) if tp else None)
    x = _causal_conv(x, cast(p["conv_x"], dt_))
    Bc = _causal_conv(Bc, cast(p["conv_B"], dt_))
    Cc = _causal_conv(Cc, cast(p["conv_C"], dt_))
    if tp:      # K8b's dB / dC cover the rank's heads: summed in rank order
        ds = Bc.shape[-1]
        Bc, Cc = mp.copy_in(torch.cat([Bc, Cc], dim=-1)).split(ds, dim=-1)

    dt = _softplus(dt_raw.float() + p["dt_bias"][None, None])
    A = -torch.exp(p["A_log"])
    xh = x.reshape(B, S, nh, hp)
    y, final = ssd_scan(xh, dt, A, Bc, Cc, cfg.ssm_chunk)
    y = y + xh * p["D_skip"][None, None, :, None].to(y.dtype)
    y = rmsnorm_gated(p["norm"], y.reshape(B, S, nh * hp), z, cfg.norm_eps,
                      mp if tp else None)
    out = y @ cast(p["out"], dt_)
    if tp:
        out = mp.sum_out(out)
    if not return_cache:
        return out, None
    conv_tail = {name: _tail_raw(cfg, p, h, f"in_{name}", cw)
                 for name in ("x", "B", "C")}
    return out, {"ssm": final, "conv": conv_tail}


def _tail_raw(cfg: ModelConfig, p: dict, h: torch.Tensor, name: str,
              cw: int) -> torch.Tensor:
    return h[:, -(cw - 1):, :] @ cast(p[name], cfg.compute_dtype)


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype, *,
                   device=None) -> dict:
    nh, hp, ds, cw, din = (cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state,
                           cfg.ssm_conv, cfg.d_inner)
    z = dict(dtype=dtype, device=device)
    return {
        "ssm": torch.zeros(batch, nh, hp, ds, **z),
        "conv": {"x": torch.zeros(batch, cw - 1, din, **z),
                 "B": torch.zeros(batch, cw - 1, ds, **z),
                 "C": torch.zeros(batch, cw - 1, ds, **z)},
    }


def ssm_decode_forward(cfg: ModelConfig, p: dict, h: torch.Tensor,
                       cache: dict, mp=None):
    """One-token decode.  h (B,1,D); cache {'ssm' (B,nh,hp,ds), 'conv'
    {'x', 'B', 'C'} (B,cw-1,C)}, updated in place.  Under a serving ``mp``
    with ``split_ssm`` the params and the cache hold this model rank's
    heads (``ssm``) and ``d_inner`` columns (``conv`` ``x``), ``B`` / ``C``
    whole; the gated norm's mean is over every rank's columns and the
    partial outputs are summed over the model ranks in rank order.
    Without the split, a cache the model axis places is gathered whole
    over the model ranks first, and the rank keeps its block of the new
    one."""
    if mp is not None and not mp.split_ssm and mp.model_size > 1:
        whole = mp.state_whole(cache)
        out, whole = ssm_decode_forward(cfg, p, h, whole)
        mp.state_keep(cache, whole)
        return out, cache
    B = h.shape[0]
    nh, hp = cfg.ssm_heads, cfg.ssm_headdim
    dt_ = cfg.compute_dtype
    tp = mp is not None and mp.split_ssm
    if tp:
        nh //= mp.model_size
    z, x_raw, B_raw, C_raw, dt_raw = _projections(cfg, p, h)

    def conv_step(raw_new, tail, w):
        window = torch.cat([tail, raw_new], dim=1)             # (B,cw,C)
        out = torch.einsum("bsc,sc->bc", window, w)[:, None, :]
        tail.copy_(window[:, 1:, :])
        return F.silu(out)

    conv = cache["conv"]
    x = conv_step(x_raw, conv["x"], cast(p["conv_x"], dt_))
    Bc = conv_step(B_raw, conv["B"], cast(p["conv_B"], dt_))
    Cc = conv_step(C_raw, conv["C"], cast(p["conv_C"], dt_))

    dt = _softplus(dt_raw[:, 0].float() + p["dt_bias"][None])   # (B,nh)
    A = -torch.exp(p["A_log"])
    xh = x[:, 0].reshape(B, nh, hp).float()
    decay = torch.exp(dt * A[None])                             # (B,nh)
    state = cache["ssm"].float() * decay[..., None, None] + torch.einsum(
        "bn,bhp,bh->bhpn", Bc[:, 0].float(), xh, dt)
    y = torch.einsum("bn,bhpn->bhp", Cc[:, 0].float(), state)
    y = y + xh * p["D_skip"][None, :, None]
    y = y.reshape(B, nh * hp)[:, None, :].to(h.dtype)
    y = rmsnorm_gated(p["norm"], y, z, cfg.norm_eps, mp if tp else None)
    cache["ssm"].copy_(state)
    out = y @ cast(p["out"], dt_)
    return (mp.sum_out(out) if tp else out), cache
