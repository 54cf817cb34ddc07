"""Per-block rematerialisation in the port's LM training (JAX's
``ModelConfig.remat`` / ``remat_policy``, on by default), on the CPU.

The recompute re-runs each block's ops on the same inputs, so the loss
and every gradient leaf are bit-equal under ``remat_policy`` "full",
"dots" and ``remat=False``: llama3.2-3b and mamba2-780m at smoke size,
jamba at one block (attention, SSM and MoE layers: K7, K8 and the
experts' ``bmm`` in one checkpointed block) and dbrx at one layer.  What
the forward leaves alive for the backward orders off > dots > full.  The
dry run (``launch/dryrun.lower_one``) measures the step under its
config's remat: llama3.2-3b at 8 x 2048, full width and depth, fits one
card with it and does not without.  ``lower_cell``'s mesh records take
JAX's ``rules_kw``.  JAX parity of the step under each policy is in
``test_torch_lm_train.py`` (``MODEL_OPTIONS``); the mesh's in
``test_torch_model_parallel.py``.
"""

import weakref

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.config import KIND_TRAIN, ShapeConfig
from repro_torch.configs import get_arch, smoke_arch
from repro_torch.data import TokenStream
from repro_torch.launch import dryrun
from repro_torch.models import transformer as tf
from repro_torch.optim.adamw import tree_leaves

#: the archs and what their smoke configs replace
ARCHS = {"llama3.2-3b": {}, "mamba2-780m": {}, "jamba-v0.1-52b": {},
         "dbrx-132b": {"num_layers": 1}}
POLICIES = {"off": {"remat": False},
            "full": {"remat": True, "remat_policy": "full"},
            "dots": {"remat": True, "remat_policy": "dots"}}
GiB = 2 ** 30
#: an 80 GB card's usable bytes, as chip_smoke's depth search reads them
CARD_GiB = 79
#: JAX's expert-parallel preferences (``benchmarks/perf_iterations.py``)
EP_PARAM_PREF = ("experts", "vocab", "ffn", "heads", "d_inner", "ssm_heads",
                 "attn_hidden", "embed")
EP_ACT_PREF = ("experts", "vocab", "ffn", "heads", "d_inner", "ssm_heads",
               "cache_seq")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one intra-op thread (several test processes share the
    host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch, policy, layers=None):
    over = dict(ARCHS[arch], **POLICIES[policy])
    if layers:
        over["num_layers"] = layers
    cfg = smoke_arch(arch).replace(**over)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    batch = TokenStream(cfg.vocab_size, 64, 2, seed=0, frontend=cfg.frontend,
                        d_model=cfg.d_model,
                        frontend_tokens=cfg.frontend_tokens).next()
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    return cfg, params, leaves, {k: torch.from_numpy(v)
                                 for k, v in batch.items()}


def _loss_and_grads(arch, policy):
    cfg, params, leaves, batch = _setup(arch, policy)
    loss, aux = tf.lm_loss(cfg, params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return [loss.detach(), aux["ce"].detach(), aux["aux"].detach(),
            *grads]


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_remat_gradients_equal_no_remat_bit_for_bit(arch, policy):
    """The loss, its CE and aux terms and every gradient leaf under the
    policy are ``torch.equal`` to those with ``remat=False``."""
    want = _loss_and_grads(arch, "off")
    got = _loss_and_grads(arch, policy)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), i


class _Live(TorchDispatchMode):
    """The storages the ops under it make, by weak reference."""

    def __init__(self):
        super().__init__()
        self.made = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (list, tuple)) else (out,)):
            if isinstance(t, torch.Tensor):
                s = t.untyped_storage()
                self.made.setdefault(s._cdata, (weakref.ref(s), s.nbytes()))
        return out

    def held(self) -> int:
        return sum(nb for ref, nb in self.made.values()
                   if ref() is not None)


def _held_for_the_backward(policy):
    """(bytes of the storages the forward made that are alive when it
    returns, bytes that autograd's saved-tensor hooks see saved)."""
    cfg, params, leaves, batch = _setup("llama3.2-3b", policy, layers=4)
    saved = {}

    def pack(t):
        saved[t.untyped_storage()._cdata] = t.untyped_storage().nbytes()
        return t

    live = _Live()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), live:
        loss, _ = tf.lm_loss(cfg, params, batch)
    held = live.held()
    torch.autograd.grad(loss, leaves, allow_unused=True)
    return held, sum(saved.values())


def test_dots_keeps_less_than_no_remat_and_more_than_full():
    """What the forward leaves alive for the backward: with remat off
    every block's saved tensors, under "full" only the blocks' inputs,
    under "dots" those and the products the policy saves.  A checkpoint's
    own saved-tensor hooks take the blocks' saved tensors, so the hooks
    around the step see the same (the embedding, head and loss) under
    both policies, and less than with remat off."""
    off, full, dots = (_held_for_the_backward(p)
                       for p in ("off", "full", "dots"))
    assert full[0] < dots[0] < off[0], (full, dots, off)
    assert full[1] == dots[1] < off[1], (full, dots, off)


def _dry(**over):
    rec = dryrun.lower_one(get_arch("llama3.2-3b").replace(**over),
                           ShapeConfig("train", 2048, 8, KIND_TRAIN))
    m = rec["memory"]
    return rec, (m["argument_bytes_per_device"]
                 + m["temp_bytes_per_device"]) / GiB


def test_dry_run_fits_llama_8x2048_only_with_remat():
    """llama3.2-3b's train step at 8 x 2048, full width and depth: the
    dry run predicts below CARD_GiB with JAX's default remat and 115.45
    GiB without it (the step that keeps every block's activations); the
    recompute adds FLOPs and runs K7 twice a layer (its tally), K7b
    once."""
    on, on_gib = _dry()
    off, off_gib = _dry(remat=False)
    assert on_gib < CARD_GiB < off_gib
    assert round(off_gib, 2) == 115.45
    assert on["memory"]["fits"] and not off["memory"]["fits"]
    assert on["cost"]["flops_per_device"] > off["cost"]["flops_per_device"]
    layers = get_arch("llama3.2-3b").num_layers
    for rec, fwd in ((on, 2 * layers), (off, layers)):
        k = rec["cost"]["kernels"]
        assert k["flash_attention"]["calls"] == fwd
        assert k["flash_attention_bwd"]["calls"] == layers


@pytest.mark.parametrize("arch,rules_kw", [
    ("llama3.2-3b", {"fsdp": False}),
    ("dbrx-132b", {"param_model_pref": EP_PARAM_PREF,
                   "act_model_pref": EP_ACT_PREF})])
def test_mesh_records_take_jax_rules_kw(arch, rules_kw):
    """``lower_cell(..., pod=True, rules_kw=)``: JAX's ``fsdp=False`` and
    its expert-parallel preferences give ``ok`` records whose placement
    differs from the default rules'."""
    rec = dryrun.lower_cell(arch, "train_4k", pod=True, rules_kw=rules_kw)
    base = dryrun.lower_cell(arch, "train_4k", pod=True)
    assert rec["status"] == base["status"] == "ok"
    assert rec["collectives"]["per_device_bytes"] > 0
    assert (rec["memory"]["params_per_device"],
            rec["collectives"]["per_device_bytes"]) != (
        base["memory"]["params_per_device"],
        base["collectives"]["per_device_bytes"])


def test_seq_shard_raises_naming_a19():
    with pytest.raises(ValueError, match="seq_shard.*A19"):
        dryrun.lower_cell("llama3.2-3b", "train_4k", pod=True,
                          rules_kw={"seq_shard": True})
