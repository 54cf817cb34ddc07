"""AdamW (decoupled weight decay) with global-norm clipping (counterpart of
``repro/optim/adamw.py``):

- moments in ``TrainConfig.opt_dtype`` (bf16 moments halve the
  optimizer's memory); the update is computed in float32 and stored back
  in each leaf's dtype, as JAX does;
- weight decay on every leaf, norm scales and biases included;
- the learning rate is the schedule's at ``step + 1``;
- a static ``loss_scale`` (the precision policy's) is divided back out of
  the gradients in float32 before the moment update; clipping and the
  reported ``grad_norm`` are in unscaled units;
- optional int8 error-feedback gradient compression (``grad_compress``,
  ``optim/grad_compress.py``), whose residual rides in
  ``TrainState.compress_err``.

On a model mesh (``distributed/model_parallel.py``) the trees hold each
rank's blocks: the update is element by element, so it runs on them as
they are, and the sharded step passes ``norm=`` (the global norm summed
over the mesh) and ``amax=`` (a leaf's largest magnitude over the mesh,
the compression's scale).

Trees are nested dicts of tensors (a flat ``dict(module.named_parameters())``
is one); leaves are visited in insertion order.  ``TrainState.step`` is a
host int, so the schedule is computed on the host and the update makes no
host sync.  The update runs **in place** on the state's params and
moments (JAX returns new arrays): the contrastive fit's parameters are
``nn.Parameter``s its encoder owns, and an LM's optimizer state is most of
the card's memory.  Large leaves are updated in slices of ``UPDATE_CHUNK``
elements, which bounds the float32 temporaries without changing a bit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.config import TrainConfig
from repro_torch.optim.schedules import SCHEDULES

#: elements of a leaf updated at a time (float32 temporaries of 128 MiB)
UPDATE_CHUNK = 1 << 25


class TrainState(NamedTuple):
    step: int
    params: dict
    mu: dict
    nu: dict
    compress_err: Optional[dict] = None  # error-feedback residual (optional)


def tree_leaves(tree) -> list:
    """The tensors of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """``leaves`` (in ``tree_leaves`` order) in the dict structure of
    ``like``.  No closure: a recursive inner function would form a
    reference cycle holding ``leaves`` (a step's gradients) until the
    garbage collector runs, which card memory does not trigger."""
    return _build(like, iter(leaves))


def _build(node, it):
    if isinstance(node, dict):
        return {k: _build(v, it) for k, v in node.items()}
    return next(it)


def _map(fn, tree):
    return tree_unflatten(tree, [fn(x) for x in tree_leaves(tree)])


def adamw_init(params, tcfg: TrainConfig) -> TrainState:
    """Zero moments in ``tcfg.opt_dtype`` and, with ``grad_compress``, a
    zero float32 residual, shaped and placed like ``params``."""
    dt = getattr(torch, tcfg.opt_dtype)
    zeros = lambda p: torch.zeros_like(p, dtype=dt)  # noqa: E731
    err = (_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
           if tcfg.grad_compress else None)
    return TrainState(0, params, _map(zeros, params), _map(zeros, params),
                      err)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tree_leaves(tree)))


def _slices(n: int):
    return [(a, min(a + UPDATE_CHUNK, n)) for a in range(0, n, UPDATE_CHUNK)]


@torch.no_grad()
def adamw_update(grads, state: TrainState, tcfg: TrainConfig,
                 norm=global_norm):
    """One AdamW step, in place on ``state``'s params and moments.  Returns
    ``(state with step + 1, {"lr": float, "grad_norm": 0-d tensor})``;
    ``norm`` maps the gradient tree to its norm (the clipping's)."""
    step = state.step + 1
    lr = SCHEDULES[tcfg.schedule](
        step, base_lr=tcfg.learning_rate, total_steps=tcfg.total_steps,
        warmup_steps=tcfg.warmup_steps)
    inv_scale = 1.0 / tcfg.loss_scale
    gnorm = norm(grads) * inv_scale
    clip = torch.clamp(tcfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    scale = inv_scale * clip
    b1, b2, eps, wd = tcfg.beta1, tcfg.beta2, tcfg.eps, tcfg.weight_decay
    f = np.float32
    c1 = float(f(1.0) - f(b1) ** f(step))
    c2 = float(f(1.0) - f(b2) ** f(step))
    for p, g, m, v in zip(*(tree_leaves(t) for t in
                            (state.params, grads, state.mu, state.nu))):
        pf, gf, mf, vf = (t.view(-1) for t in (p, g.contiguous(), m, v))
        for a, b in _slices(pf.numel()):
            g32 = gf[a:b].float() * scale
            m_new = b1 * mf[a:b].float() + (1 - b1) * g32
            v_new = b2 * vf[a:b].float() + (1 - b2) * torch.square(g32)
            update = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
            p32 = pf[a:b].float()
            pf[a:b].copy_(p32 - lr * (update + wd * p32))
            mf[a:b].copy_(m_new)
            vf[a:b].copy_(v_new)
    return state._replace(step=step), {"lr": lr, "grad_norm": gnorm}


def apply_gradients(state: TrainState, grads, tcfg: TrainConfig, *,
                    norm=global_norm, amax=None):
    """Compress the gradients first when ``grad_compress`` is on (the new
    residual replaces ``state.compress_err``), then ``adamw_update``.
    ``norm`` and ``amax`` are the sharded step's reductions over its
    mesh (``adamw_update``, ``compress_decompress``)."""
    if tcfg.grad_compress and state.compress_err is not None:
        from repro_torch.optim.grad_compress import compress_decompress

        grads, new_err = compress_decompress(grads, state.compress_err,
                                             amax=amax)
        state = state._replace(compress_err=new_err)
    return adamw_update(grads, state, tcfg, norm=norm)
