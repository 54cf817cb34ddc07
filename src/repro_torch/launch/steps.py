"""Step functions of the LM launchers: train / prefill / decode (counterpart
of ``repro/launch/steps.py``).

``make_train_step(cfg, tcfg)`` differentiates the scaled loss
(``apply_gradients`` divides ``tcfg.loss_scale`` back out), reports the
unscaled one, and applies the gradients in place on the state's tensors;
with ``tcfg.microbatch > 1`` the batch is split into that many
micro-batches whose gradients are summed in order into float32 zeros and
divided by their number (JAX's ``lax.scan`` over the splits).  The
gradients are ``torch.autograd.grad`` of the loss with respect to every
parameter leaf; the leaves are made to require gradients on the first
step.

``abstract_params`` and ``train_state_specs`` are JAX's shape-only
trees: ``meta`` tensors of the parameters' and the ``TrainState``'s
shapes and dtypes, no storage allocated (the train launcher's restore
target and the dry run's arguments, ``launch/dryrun.py``).  The JAX
module's sharding trees (``param_shardings``, ``train_state_shardings``,
``batch_shardings``, ...) place arrays on a device mesh; the port runs on
one card and has none of them (ROADMAP A9c).
"""

from __future__ import annotations

import torch

from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.models import transformer as tf
from repro_torch.optim import TrainState, adamw_init, apply_gradients
from repro_torch.optim.adamw import tree_leaves, tree_unflatten


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    def train_step(state: TrainState, batch: dict):
        if tcfg.microbatch and tcfg.microbatch > 1:
            grads, metrics = _accumulated_grads(cfg, state.params, batch,
                                                tcfg)
        else:
            loss, aux, grads = _grads(cfg, state.params, batch,
                                      tcfg.loss_scale)
            metrics = dict(aux, loss=loss / tcfg.loss_scale)
        new_state, opt_metrics = apply_gradients(state, grads, tcfg)
        return new_state, dict(metrics, **opt_metrics)

    return train_step


def _scaled_lm_loss(cfg, params, batch, scale):
    loss, aux = tf.lm_loss(cfg, params, batch)
    return loss * scale, aux


def _grads(cfg, params, batch, scale):
    """(scaled loss, aux, gradients in ``params``' tree), all detached."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, aux = _scaled_lm_loss(cfg, params, batch, scale)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in aux.items()},
            tree_unflatten(params, list(grads)))


def _accumulated_grads(cfg, params, batch, tcfg):
    """Gradient accumulation over ``tcfg.microbatch`` splits of the batch,
    summed in split order."""
    n = tcfg.microbatch
    B = next(iter(batch.values())).shape[0]
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in tree_leaves(params)]
    loss_acc = torch.zeros((), dtype=torch.float32, device=acc[0].device)
    for i in range(n):
        mb = {k: v[i * (B // n):(i + 1) * (B // n)] for k, v in batch.items()}
        loss, _, grads = _grads(cfg, params, mb, tcfg.loss_scale)
        acc = [a + g for a, g in zip(acc, tree_leaves(grads))]
        loss_acc = loss_acc + loss
    grads = tree_unflatten(params, [a / n for a in acc])
    return grads, {"loss": loss_acc / (n * tcfg.loss_scale)}


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        logits, caches, idx = tf.prefill(cfg, params, batch["tokens"],
                                         batch.get("frontend"))
        return logits, {"caches": caches, "index": idx}

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, state, batch):
        return tf.decode_step(cfg, params, state, batch["tokens"])

    return decode_step


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes and dtypes (``cfg.param_dtype``) as
    ``meta`` tensors."""
    return tf.init_params(cfg, None, device="meta")


def train_state_specs(cfg: ModelConfig, tcfg: TrainConfig) -> TrainState:
    """``adamw_init`` of ``abstract_params``: a ``TrainState`` of ``meta``
    tensors (moments in ``tcfg.opt_dtype``)."""
    return adamw_init(abstract_params(cfg), tcfg)
