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
target and the dry run's arguments, ``launch/dryrun.py``).

On a (data, model) mesh of ranks, ``param_specs`` and
``train_state_shardings`` are the JAX module's sharding trees with a spec
(``distributed/sharding.py``) where JAX has a ``NamedSharding``: the step
replicated, params, ``mu``, ``nu`` and ``compress_err`` under the param
specs.  ``make_sharded_train_step(cfg, tcfg, rules, group)`` is the train
step on this rank's blocks and rows (``distributed/model_parallel.py``),
with JAX's gradient accumulation over ``tcfg.microbatch`` micro-batches
of the global batch;
its ``info`` names the leaves the model axis splits in compute and
each leaf's mode.  ``batch_specs_tree`` and ``decode_state_specs_tree``
are JAX's ``batch_shardings`` / ``decode_state_shardings`` as specs
(activation rules: a dim GSPMD would pad is split ceil-wise,
``distributed/sharding.ceil_region``); ``make_sharded_prefill_step`` and
``make_sharded_decode_step`` are JAX's prefill and decode steps on this
rank's params, batch rows and decode-state blocks under them, returning
its vocabulary slice of the logits as JAX's step leaves them split.
"""

from __future__ import annotations

import torch

from repro_torch.config import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.distributed.sharding import MeshRules
from repro_torch.distributed.sharding import param_specs as _param_specs
from repro_torch.models import transformer as tf
from repro_torch.models.specs import batch_axes_tree, batch_specs
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


def _scaled_lm_loss(cfg, params, batch, scale, mp=None):
    loss, aux = tf.lm_loss(cfg, params, batch, mp=mp)
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


def param_specs(cfg: ModelConfig, aparams: dict, rules: MeshRules) -> dict:
    """Every param leaf's spec (JAX's ``param_shardings``)."""
    return _param_specs(tf.params_axes(cfg), aparams, rules)


def train_state_shardings(cfg: ModelConfig, tcfg: TrainConfig,
                          astate: TrainState, rules: MeshRules
                          ) -> TrainState:
    """The specs of a ``TrainState`` (JAX's ``train_state_shardings``):
    the step replicated (``()``), params, moments and residual under the
    param specs."""
    psh = param_specs(cfg, astate.params, rules)
    err = None if astate.compress_err is None else psh
    return TrainState(step=(), params=psh, mu=psh, nu=psh, compress_err=err)


def batch_specs_tree(cfg: ModelConfig, shape: ShapeConfig,
                     rules: MeshRules) -> dict:
    """Every batch field's spec (JAX's ``batch_shardings``): the data axes
    on ``batch`` where they divide it, else replicated."""
    return _param_specs(batch_axes_tree(cfg, shape), batch_specs(cfg, shape),
                        rules, is_param=False)


def decode_state_specs_tree(cfg: ModelConfig, shape: ShapeConfig,
                            rules: MeshRules) -> dict:
    """Every decode-state leaf's spec at ``shape`` (JAX's
    ``decode_state_shardings``; the index replicated, ``()``)."""
    from repro_torch.distributed.model_parallel import state_specs

    return state_specs(cfg, rules, shape.global_batch, shape.seq_len)


def _mesh_plan(cfg: ModelConfig, rules: MeshRules, group):
    """(ShardPlan, this rank's MeshGroups); ``group`` a ``Group`` (every
    rank of the job calls this, in the same order) or ``MeshGroups``."""
    from repro_torch.distributed.group import MeshGroups
    from repro_torch.distributed.model_parallel import ShardPlan

    plan = ShardPlan(cfg, rules)
    groups = (group if isinstance(group, MeshGroups)
              else group.mesh_groups(rules.mesh))
    if groups is None:
        raise ValueError(f"this rank is outside the {rules.mesh.shape} mesh")
    return plan, groups


def _serve_step(step, plan, groups):
    """Hang a serving step's plan, groups, greedy token and info on it."""
    from repro_torch.distributed.model_parallel import ModelParallel

    step.plan, step.groups = plan, groups
    step.argmax = ModelParallel(plan, groups, {}, serving=True).argmax
    step.info = {"mesh": tuple(plan.mesh.shape), "split": plan.split_leaves,
                 "modes": {lf.key: lf.mode for lf in plan.leaves}}
    return step


def make_sharded_prefill_step(cfg: ModelConfig, rules: MeshRules, group):
    """JAX's prefill step on one rank of ``rules.mesh``:
    ``prefill_step(params, batch, state)`` with ``params`` this rank's
    blocks of the compute params (``plan.shard``), ``batch`` its rows
    (``plan.serve_batch``) and ``state`` its decode-state blocks
    (``plan.decode_state(global batch, max_seq, rank=)``), into which the
    prompt's caches are spliced in place; returns (this rank's
    vocabulary slice of the last position's logits, float32, the state
    at index S).  ``step.argmax(logits)`` is the greedy token; the step
    carries ``plan``, ``groups`` and ``info`` as the train step does."""
    from repro_torch.distributed.model_parallel import ModelParallel

    plan, groups = _mesh_plan(cfg, rules, group)

    @torch.no_grad()
    def prefill_step(params: dict, batch: dict, state: dict):
        mp = ModelParallel(plan, groups, params, serving=True,
                           span=state["span"])
        logits, caches, idx = tf.prefill(cfg, params, batch["tokens"],
                                         batch.get("frontend"), mp)
        mp.splice(state["caches"], caches)
        return logits, dict(state, index=idx)

    return _serve_step(prefill_step, plan, groups)


def make_sharded_decode_step(cfg: ModelConfig, rules: MeshRules, group):
    """JAX's decode step on one rank of ``rules.mesh``:
    ``decode_step(params, state, batch)`` (``batch["tokens"]`` the rank's
    (B, 1) rows) -> (its vocabulary slice of the logits, the state one
    position on; the caches written in place, the index a host int)."""
    from repro_torch.distributed.model_parallel import ModelParallel

    plan, groups = _mesh_plan(cfg, rules, group)

    @torch.no_grad()
    def decode_step(params: dict, state: dict, batch: dict):
        mp = ModelParallel(plan, groups, params, serving=True,
                           span=state["span"])
        return tf.decode_step(cfg, params, state, batch["tokens"], mp)

    return _serve_step(decode_step, plan, groups)


def make_sharded_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                            rules: MeshRules, group):
    """The train step of one rank of ``rules.mesh``: ``train_step(state,
    batch)`` with ``state`` this rank's blocks (``plan.shard``, then
    ``adamw_init``) and ``batch`` its rows (``plan.local_batch``); the
    metrics are the whole batch's (the data ranks' shares summed in rank
    order).  With ``tcfg.microbatch`` n > 1, ``batch`` is the rank's rows
    of each micro-batch in turn (``plan.local_batch(batch, index,
    microbatch=n)``): each micro-batch runs the sharded forward and
    backward (its label count and MoE expert fractions its own, its
    gradient summed over the data ranks), the rank's gradient blocks
    add up in micro-batch order into float32 zeros and are divided by n,
    and the metrics are JAX's ``{"loss"}``, the micro-batches' losses
    summed over the data ranks, then in order.  ``group`` is the
    ``Group`` the mesh is laid over (its mesh
    groups are built here: every rank of the job calls this, in the same
    order) or a rank's ``MeshGroups``.  The step carries ``plan``,
    ``groups`` and ``info`` ({"mesh", "split": the leaves the model axis
    splits in compute, "modes": each leaf's use, "whole", "split" or
    "take"})."""
    from repro_torch.distributed.model_parallel import ModelParallel

    plan, groups = _mesh_plan(cfg, rules, group)
    n = tcfg.microbatch if tcfg.microbatch and tcfg.microbatch > 1 else 1

    def grads_of(params, batch):
        """(scaled loss share, aux shares, gradients) of one (micro-)batch
        of this rank's rows."""
        mp = ModelParallel(plan, groups, params)
        loss, aux = _scaled_lm_loss(cfg, params, batch, tcfg.loss_scale, mp)
        grads = torch.autograd.grad(loss, tree_leaves(params),
                                    allow_unused=True, materialize_grads=True)
        return loss.detach(), aux, list(grads), mp

    def train_step(state: TrainState, batch: dict):
        leaves = tree_leaves(state.params)
        for p in leaves:
            p.requires_grad_(True)
        if n == 1:
            loss, aux, grads, mp = grads_of(state.params, batch)
            shares = torch.stack([loss / tcfg.loss_scale, aux["ce"].detach(),
                                  aux["aux"].detach()])
            total = mp.data_sum(shares)
            metrics = {"ce": total[1], "aux": total[2], "loss": total[0]}
        else:
            # JAX's scan over micro-batches: the rank's rows come
            # micro-batch-major (``plan.local_batch(microbatch=n)``)
            B = next(iter(batch.values())).shape[0] // n
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves]
            losses = []
            for i in range(n):
                loss, _, g, mp = grads_of(
                    state.params,
                    {k: v[i * B:(i + 1) * B] for k, v in batch.items()})
                grads = [a + b for a, b in zip(grads, g)]
                losses.append(loss)
            grads = [a / n for a in grads]
            # each micro-batch's loss summed over the data ranks, then
            # over the micro-batches in order
            per = mp.data_sum(torch.stack(losses))
            loss_acc = torch.zeros((), dtype=torch.float32,
                                   device=per.device)
            for i in range(n):
                loss_acc = loss_acc + per[i]
            metrics = {"loss": loss_acc / (n * tcfg.loss_scale)}
        grads = tree_unflatten(state.params, grads)
        new_state, opt_metrics = apply_gradients(
            state, grads, tcfg, norm=mp.global_norm, amax=mp.amax)
        return new_state, dict(metrics, **opt_metrics)

    train_step.plan, train_step.groups = plan, groups
    train_step.info = {"mesh": tuple(rules.mesh.shape),
                       "split": plan.split_leaves,
                       "modes": {lf.key: lf.mode for lf in plan.leaves}}
    return train_step

