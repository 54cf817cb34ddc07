"""The port's training path against the JAX package's, on the CPU.

Every random number of a JAX step comes from its key tree
(``packed_loss``: ``r1, r2, rp1, rp2 = split(fold_in(base, i), 4)``; each
view's key feeds ``augment_view_packed`` (split 3: strategy, node mask,
edge mask) and ``encode_packed`` (split ``len(dims)``: dropout masks of the
non-last layers, then the feature noise); ``rp*`` the projection dropout).
``_jax_draws`` rebuilds that tree with ``jax.random`` and hands the port the
same draws as tensors, so both sides compute the same function.  Params
start from JAX ``init_rgcn`` through ``params_from_jax``.  Widths are
narrow, (64, 32, 32, 48): the node features are 64 wide by construction.

Tolerances, relative to the largest magnitude of each compared array:
InfoNCE, the schedule and one AdamW update 1e-6 (float32 formulas written
alike, summed in another order); the loss 1e-5; gradients and the
parameters after three steps 1e-4 (two autodiff systems sum the backward
in different orders, and Adam divides by sqrt(v), which magnifies that
noise where a gradient is small).  Augmented masks and edge norms, the
train/validation split and the batch selections are compared exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.train as jax_train_mod
from repro.config import TrainConfig as JTrainConfig
from repro.core.augment import augment_view_packed as jax_augment
from repro.core.batching import pack_graphs
from repro.core.contrastive import info_nce as jax_info_nce
from repro.core.graphs import build_kernel_graph
from repro.core.rgcn import RGCNConfig as JRGCNConfig
from repro.core.rgcn import encode_packed as jax_encode_packed
from repro.core.rgcn import init_rgcn as jax_init_rgcn
from repro.core.train import ContrastiveTrainer as JTrainer
from repro.core.train import GCLTrainConfig as JGCLTrainConfig
from repro.core.train import _engine_fns, packed_loss as jax_packed_loss
from repro.optim.adamw import TrainState, adamw_update as jax_adamw_update
from repro.optim.schedules import SCHEDULES as JSCHEDULES
from repro.sampling.store import flatten_tree
from repro.tracing.templates import make_kernel
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.augment import augment_view_packed
from repro_torch.core.contrastive import info_nce
from repro_torch.core.rgcn import (
    EncodeDraws, RGCNConfig, encode_packed,
)
from repro_torch.core.sampler import GCLSamplerConfig
from repro_torch.core.train import (
    METRIC_KEYS, ContrastiveTrainer, FitInterrupted, GCLTrainConfig,
    ViewDraws, packed_loss, train_step,
)
from repro_torch.interop import params_from_jax, params_to_numpy
from repro_torch.optim import SCHEDULES, TrainConfig, adamw_update
from repro_torch.optim import TrainState as TTrainState
from repro_torch.optim import adamw_init
from repro_torch.sampling import evaluate, get_method
from repro_torch.tracing.programs import get_program

DIMS = (64, 32, 32, 48)
TAU = 0.05
JRC = JRGCNConfig(dims=DIMS)
RC = RGCNConfig(dims=DIMS)
TEMPLATES = [("gemm", {"M": 128, "N": 128, "K": 128}),
             ("elementwise", {"n": 4096, "nops": 3, "iters": 4}),
             ("stencil", {"nx": 512, "ny": 4, "pts": 5, "iters": 8}),
             ("reduction", {"n": 65536}),
             ("softmax", {"rows": 64, "cols": 1000})]


def _graphs(n=12, seed=0):
    ks = [make_kernel(f"k{i}", *TEMPLATES[i % len(TEMPLATES)], i,
                      seed=seed * 10 + i) for i in range(n)]
    return [build_kernel_graph(k.trace(cap_warps=2, cap_instr=40))
            for k in ks]


GRAPHS = _graphs()


def _packed(idx):
    packed, _ = pack_graphs([GRAPHS[i] for i in idx])
    return packed


def _tb(packed):
    return {k: torch.from_numpy(v) for k, v in packed.items()}


def _jb(packed):
    return {k: jnp.asarray(v) for k, v in packed.items()}


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _scale_close(got, want, rtol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _jax_view(rv, rp, packed, jrc, train):
    """One view's draws from JAX's keys, as the port's ViewDraws."""
    P, Q = len(packed["node_mask"]), len(packed["edge_mask"])
    G = len(packed["graph_mask"])
    r_combo, r_node, r_edge = jax.random.split(rv, 3)
    combo = jax.random.randint(r_combo, (G,), 0, 6)
    node_keep = jax.random.bernoulli(r_node, 1 - 0.15, (P,))
    edge_keep = jax.random.bernoulli(r_edge, 1 - 0.15, (Q,))
    base = (_t(combo).long(), _t(node_keep), _t(edge_keep))
    if not train:
        return ViewDraws(*base)
    rngs = jax.random.split(rv, len(jrc.dims))
    noise = jax.random.normal(rngs[-1], (P, jrc.dims[0]), jrc.policy.compute)
    dropout = tuple(
        _t(jax.random.bernoulli(rngs[i], 1 - jrc.dropout,
                                (P, jrc.dims[i + 1])))
        for i in range(len(jrc.dims) - 2))
    proj_keep = jax.random.bernoulli(rp, 1 - jrc.dropout,
                                     (G, jrc.proj_hidden))
    return ViewDraws(*base, EncodeDraws(noise=_t(noise), dropout=dropout),
                     _t(proj_keep))


def _jax_draws(rng, packed, jrc=JRC, train=True):
    if train:
        r1, r2, rp1, rp2 = jax.random.split(rng, 4)
        return (_jax_view(r1, rp1, packed, jrc, True),
                _jax_view(r2, rp2, packed, jrc, True))
    r1, r2 = jax.random.split(rng)
    return (_jax_view(r1, None, packed, jrc, False),
            _jax_view(r2, None, packed, jrc, False))


@pytest.fixture(scope="module")
def jparams():
    return jax_init_rgcn(jax.random.PRNGKey(5), JRC)


def _encoder(jparams, rc=RC):
    return params_from_jax(flatten_tree(jparams), rc)


# ---------------------------------------------------------------------------
# loss, schedule, optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", [1, 8])
def test_info_nce_matches_jax(B):
    rng = np.random.default_rng(B)
    z1 = rng.standard_normal((B, 16)).astype(np.float32)
    z2 = (z1 + 0.3 * rng.standard_normal((B, 16))).astype(np.float32)
    loss, m = info_nce(_t(z1), _t(z2), TAU)
    jloss, jm = jax_info_nce(jnp.asarray(z1), jnp.asarray(z2), TAU)
    _scale_close(float(loss), float(jloss), 1e-6)
    for k in ("nce_acc", "pos_sim", "neg_sim"):
        _scale_close(float(m[k]), float(jm[k]), 1e-6)


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_schedule_matches_jax(schedule):
    kw = dict(base_lr=7e-4, total_steps=120, warmup_steps=20)
    got = [SCHEDULES[schedule](s, **kw) for s in range(0, 160, 3)]
    want = [float(JSCHEDULES[schedule](s, **kw)) for s in range(0, 160, 3)]
    _scale_close(got, want, 1e-6)


@pytest.mark.parametrize("loss_scale", [1.0, 4.0])
@pytest.mark.parametrize("step", [0, 7])
def test_adamw_update_matches_jax(step, loss_scale):
    """One update with clipping active (gradient norm ~30 > 1), nonzero
    moments, weight decay on every leaf, lr at step+1."""
    rng = np.random.default_rng(step)
    shapes = {"a": (5, 3), "b": (3,), "c": (2, 4, 4)}
    mk = lambda s: {k: rng.standard_normal(v).astype(np.float32) * s  # noqa
                    for k, v in shapes.items()}
    params, grads, mu = mk(1.0), mk(10.0 * loss_scale), mk(0.1)
    nu = {k: np.abs(v) for k, v in mk(0.01).items()}
    tcfg = TrainConfig(learning_rate=7e-4, warmup_steps=20, total_steps=120,
                       loss_scale=loss_scale)
    jt = JTrainConfig(learning_rate=7e-4, warmup_steps=20, total_steps=120,
                      loss_scale=loss_scale)
    st, jm = jax_adamw_update(
        {k: jnp.asarray(v) for k, v in grads.items()},
        TrainState(jnp.asarray(step, jnp.int32),
                   *({k: jnp.asarray(v) for k, v in d.items()}
                     for d in (params, mu, nu))), jt)
    tp, tm, tn = ({k: _t(v) for k, v in d.items()} for d in (params, mu, nu))
    ts, m = adamw_update({k: _t(v) for k, v in grads.items()},
                         TTrainState(step, tp, tm, tn), tcfg)
    assert ts.step == step + 1
    assert float(jm["grad_norm"]) > 1.0                 # clipping active
    _scale_close(float(m["grad_norm"]), float(jm["grad_norm"]), 1e-6)
    _scale_close(m["lr"], float(jm["lr"]), 1e-6)
    for got, want in ((tp, st.params), (tm, st.mu), (tn, st.nu)):
        for k in shapes:
            _scale_close(got[k].numpy(), want[k], 1e-6)


# ---------------------------------------------------------------------------
# augmentation, encoder, loss and gradients
# ---------------------------------------------------------------------------

def test_augment_view_packed_matches_jax():
    """The port's view from JAX's draws: node / edge masks, the re-derived
    edge norm and the noise gate are equal to JAX's, element for element."""
    packed = _packed(range(6))
    for i in range(4):
        rv = jax.random.PRNGKey(100 + i)
        want, wnoise = jax_augment(rv, _jb(packed))
        vd = _jax_view(rv, None, packed, JRC, False)
        got, gnoise = augment_view_packed(_tb(packed), vd.combo,
                                          vd.node_keep, vd.edge_keep)
        for k in ("node_mask", "edge_mask", "edge_norm"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        np.testing.assert_array_equal(gnoise.numpy(), np.asarray(wnoise))


@pytest.mark.parametrize("unfused", [False, True])
def test_encode_packed_eval_matches_jax_paths(jparams, unfused):
    """Eval-mode encode, fused (K1) and unfused (K5 + matmul, per-layer
    normalizer, four-sum readout), against JAX's ``encode_packed`` with and
    without ``unfused_ref`` (the latter on its Pallas ``rgcn_spmm`` path in
    interpret mode), at 1e-5."""
    packed = _packed(range(5))
    jrc = dataclasses.replace(JRC, use_pallas=unfused)
    want = jax_encode_packed(jparams, jrc, _jb(packed), unfused_ref=unfused)
    with torch.no_grad():
        got = encode_packed(_encoder(jparams), RC, _tb(packed),
                            unfused_ref=unfused)
    _scale_close(got.numpy(), want, 1e-5)


def test_train_mode_encode_matches_jax(jparams):
    """Training-mode encode (feature noise on the gated graphs, dropout
    after the non-last layers) from JAX-derived draws."""
    packed = _packed(range(6))
    rv = jax.random.PRNGKey(9)
    jview, jgate = jax_augment(rv, _jb(packed))
    want = jax_encode_packed(jparams, JRC, jview, rng=rv, train=True,
                             noise_gate=jgate)
    vd = _jax_view(rv, jax.random.PRNGKey(0), packed, JRC, True)
    view, gate = augment_view_packed(_tb(packed), vd.combo, vd.node_keep,
                                     vd.edge_keep)
    with torch.no_grad():
        got = encode_packed(_encoder(jparams), RC, view, train=True,
                            draws=dataclasses.replace(vd.enc,
                                                      noise_gate=gate))
    _scale_close(got.numpy(), want, 1e-5)


def _leaf_grads(enc, loss):
    params = dict(enc.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    return {k.replace(".", "/"): g.numpy() for k, g in zip(params, grads)}


def test_packed_loss_and_grads_match_jax(jparams):
    """``packed_loss(train=True)`` on the rebuilt key tree: the loss within
    1e-5 and every parameter's gradient within 1e-4 of
    ``jax.value_and_grad``."""
    packed = _packed([0, 3, 5, 7, 8, 10])
    rng = jax.random.PRNGKey(21)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jax_packed_loss(p, JRC, TAU, _jb(packed), rng, train=True),
        has_aux=True)(jparams)
    enc = _encoder(jparams)
    loss, m = packed_loss(enc, RC, TAU, _tb(packed),
                          _jax_draws(rng, packed), train=True)
    _scale_close(loss.item(), float(jloss), 1e-5)
    for k in ("nce_acc", "pos_sim", "neg_sim"):
        _scale_close(m[k].item(), float(jm[k]), 1e-5)
    got = _leaf_grads(enc, loss)
    want = flatten_tree(jgrads)
    assert set(got) == set(want)
    for k in want:
        _scale_close(got[k], want[k], 1e-4)


def test_eval_loss_matches_jax(jparams):
    """Eval mode (augmentations only: no dropout, no feature noise) against
    the JAX engine's ``eval_loss`` on the same key."""
    packed = _packed(range(8))
    eng = _engine_fns(JRC, JGCLTrainConfig().opt, TAU, None)
    rng = jax.random.PRNGKey(77)
    jloss, jm = eng.eval_loss(jparams, _jb(packed), rng)
    with torch.no_grad():
        loss, m = packed_loss(_encoder(jparams), RC, TAU, _tb(packed),
                              _jax_draws(rng, packed, train=False),
                              train=False)
    _scale_close(float(loss), float(jloss), 1e-5)
    _scale_close(float(m["nce_acc"]), float(jm["nce_acc"]), 1e-6)


def test_three_steps_match_jax_engine(jparams):
    """Three optimizer steps of the port against the JAX engine's ``step``
    on the same batches and keys (``fold_in(base, i)``): the metrics of
    every step and every parameter after step 3 within 1e-4."""
    tc = GCLTrainConfig()
    jopt = JGCLTrainConfig().opt
    assert dataclasses.asdict(tc.opt) == dataclasses.asdict(jopt)
    _three_engine_steps(jparams, tc.opt, jopt)


@pytest.mark.parametrize("option", [{"grad_compress": True},
                                    {"opt_dtype": "bfloat16"}],
                         ids=["grad_compress", "bf16_moments"])
def test_three_steps_with_jax_optimizer_options(jparams, option):
    """The fit's step takes JAX's optimizer options as JAX's fit does (its
    ``apply_gradients``): int8 error-feedback compression and bf16
    moments, three steps on JAX's draws within 1e-4 (bf16 moments: plus
    what one moment rounding can move a parameter), the residual and the
    moments in their dtypes."""
    opt = dataclasses.replace(GCLTrainConfig().opt, **option)
    jopt = dataclasses.replace(JGCLTrainConfig().opt, **option)
    state, tstate = _three_engine_steps(jparams, opt, jopt)
    assert (tstate.compress_err is None) == (state.compress_err is None)
    want_dt = jnp.dtype(jopt.opt_dtype)
    assert all(str(v.dtype) == f"torch.{want_dt}"
               for v in tstate.mu.values())
    if tstate.compress_err is not None:
        assert all(v.dtype == torch.float32
                   for v in tstate.compress_err.values())


def _three_engine_steps(jparams, opt, jopt):
    step = jax.jit(_engine_fns(JRC, jopt, TAU, None).step)
    from repro.optim.adamw import adamw_init as jax_adamw_init

    state = jax_adamw_init(jparams, jopt)
    enc = _encoder(jparams)
    tstate = adamw_init(dict(enc.named_parameters()), opt)
    base = jax.random.PRNGKey(3)
    for i, idx in enumerate([[0, 1, 2, 3], [4, 5, 6, 7], [1, 3, 8, 9]]):
        packed = _packed(idx)
        key = jax.random.fold_in(base, i)
        state, jm = step(state, _jb(packed), key)
        tstate, got = train_step(enc, RC, TAU, opt, _tb(packed),
                                 _jax_draws(key, packed), tstate)
        for j, k in enumerate(METRIC_KEYS):
            _scale_close(float(got[j]), float(jm[k]), 1e-4)
    want = flatten_tree(state.params)
    got = params_to_numpy(enc)
    # a bf16 moment one rounding (2^-8) from JAX's, where the float32
    # values on either side of it differ by an ulp, moves that element's
    # update by up to 2^-8 of its size (|update| <= ~1 in Adam's first
    # steps): at most 2^-8 x the sum of the rates, absolutely
    lrs = [SCHEDULES[opt.schedule](t, base_lr=opt.learning_rate,
                                   total_steps=opt.total_steps,
                                   warmup_steps=opt.warmup_steps)
           for t in (1, 2, 3)]
    flip = 2 ** -8 * sum(lrs) if opt.opt_dtype == "bfloat16" else 0.0
    for k in want:
        w = np.asarray(want[k], np.float64)
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(got[k], w, rtol=1e-4,
                                   atol=1e-4 * scale + flip)
    return state, tstate


# ---------------------------------------------------------------------------
# the fit: split, resume, end to end
# ---------------------------------------------------------------------------

def test_split_and_selections_equal_jax_fit(monkeypatch):
    """The validation split and every step's batch selection equal what the
    JAX trainer's ``fit`` uses (captured from its engine call and its
    validation pack)."""
    seen = {}

    def fake_scan(self, graphs, selections, state, *a, **kw):
        seen["selections"] = np.array(selections)
        return state, {"trunc_nodes": 0, "host_syncs": 0}

    real_pack = jax_train_mod.pack_graphs

    def spy_pack(graphs, **kw):
        seen["val"] = [next(i for i, g in enumerate(GRAPHS) if g is x)
                       for x in graphs]
        return real_pack(graphs, **kw)

    monkeypatch.setattr(JTrainer, "_fit_scan", fake_scan)
    monkeypatch.setattr(jax_train_mod, "pack_graphs", spy_pack)
    jtc = JGCLTrainConfig(steps=9, batch_size=4, seed=3)
    JTrainer(JRC, jtc).fit(GRAPHS)
    tr = ContrastiveTrainer(RC, GCLTrainConfig(steps=9, batch_size=4, seed=3),
                            device="cpu")
    train_idx, val_idx, selections = tr.split(len(GRAPHS))
    np.testing.assert_array_equal(selections, seen["selections"])
    assert list(val_idx) == seen["val"]
    assert not set(train_idx) & set(val_idx)


def _tc(**kw):
    base = dict(steps=8, batch_size=4, log_every=3)
    base.update(kw)
    return GCLTrainConfig(**base)


def test_interrupt_resume_bit_exact(tmp_path):
    """A fit interrupted at step k and resumed reproduces the uninterrupted
    fit's parameters, history and validation loss bit for bit: each step's
    draws depend on (seed, step) alone."""
    tc = _tc(checkpoint_every=3)
    full, i_full = ContrastiveTrainer(RC, tc, device="cpu").fit(GRAPHS)
    ck = str(tmp_path / "ck")
    with pytest.raises(FitInterrupted):
        ContrastiveTrainer(RC, tc, device="cpu").fit(
            GRAPHS, checkpoint_dir=ck, interrupt_after=5)
    assert CheckpointManager(ck).latest_step() == 5
    res, i_res = ContrastiveTrainer(RC, tc, device="cpu").fit(
        GRAPHS, checkpoint_dir=ck)
    assert i_res["resumed_from"] == 5
    a, b = params_to_numpy(full), params_to_numpy(res)
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert i_full["history"] == i_res["history"]
    assert len(i_full["history"]) == 8
    assert i_full["val_loss"] == i_res["val_loss"]
    assert i_full["host_syncs"] == 3 + 1         # ceil(8 / 3) flushes + val


def test_resume_carries_the_optimizer_options_state(tmp_path):
    """With int8 compression and bf16 moments the checkpoint carries the
    error residual (float32) and the moments (bfloat16, as their bits), so
    a resumed fit still equals the uninterrupted one bit for bit."""
    opt = dataclasses.replace(_tc().opt, grad_compress=True,
                              opt_dtype="bfloat16")
    tc = _tc(checkpoint_every=3, opt=opt)
    full, i_full = ContrastiveTrainer(RC, tc, device="cpu").fit(GRAPHS)
    ck = str(tmp_path / "ck")
    with pytest.raises(FitInterrupted):
        ContrastiveTrainer(RC, tc, device="cpu").fit(
            GRAPHS, checkpoint_dir=ck, interrupt_after=5)
    tree, _ = CheckpointManager(ck).restore_tree()
    assert "compress_err" in tree["state"]
    res, i_res = ContrastiveTrainer(RC, tc, device="cpu").fit(
        GRAPHS, checkpoint_dir=ck)
    assert i_res["resumed_from"] == 5
    a, b = params_to_numpy(full), params_to_numpy(res)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert i_full["history"] == i_res["history"]


def test_resume_refuses_foreign_seed(tmp_path):
    ck = str(tmp_path / "ck")
    with pytest.raises(FitInterrupted):
        ContrastiveTrainer(RC, _tc(checkpoint_every=2), device="cpu").fit(
            GRAPHS, checkpoint_dir=ck, interrupt_after=2)
    with pytest.raises(ValueError, match="different seed"):
        ContrastiveTrainer(RC, _tc(checkpoint_every=2, seed=1),
                           device="cpu").fit(GRAPHS, checkpoint_dir=ck)


def test_checkpoint_manager_round_trip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": np.arange(3, dtype=np.float32),
            "b": {"layers": [{"w": np.ones((2, 2))}, {"w": np.zeros(1)}]},
            "n": np.int64(4)}
    for s in (1, 2, 3):
        mgr.save(s, tree)
    mgr.wait()
    assert mgr.all_steps() == [2, 3]
    got, step = mgr.restore_tree()
    assert step == 3 and int(got["n"]) == 4
    assert np.array_equal(got["b"]["layers"][0]["w"], np.ones((2, 2)))
    assert not any(n.endswith(".tmp") for n in
                   __import__("os").listdir(str(tmp_path)))


def test_staged_edges_are_validated_before_upload():
    """Out-of-range endpoints raise before any result: on the host arrays
    in the trainer's staging, and once per call for a direct
    ``encode_packed`` caller."""
    packed = _packed(range(3))
    bad = dict(packed, edge_dst=packed["edge_dst"].copy())
    bad["edge_dst"][0] = len(packed["node_mask"])
    tr = ContrastiveTrainer(RC, _tc(), device="cpu")
    with pytest.raises(IndexError):
        tr._upload(bad)
    with pytest.raises(IndexError):
        encode_packed(params_from_jax(flatten_tree(
            jax_init_rgcn(jax.random.PRNGKey(0), JRC)), RC), RC, _tb(bad))


def test_fit_trains_and_round_trips_to_jax_layout():
    """A short fit lowers the loss; the fitted encoder goes back to the JAX
    ``flatten_tree`` layout and JAX's encoder reproduces its embeddings."""
    tc = _tc(steps=24, log_every=24, batch_size=6)
    enc, info = ContrastiveTrainer(RC, tc, device="cpu").fit(GRAPHS)
    losses = [h["loss"] for h in info["history"]]
    assert len(losses) == 24 and np.all(np.isfinite(losses))
    assert np.mean(losses[-6:]) < np.mean(losses[:6])
    assert np.isfinite(info["val_loss"])
    flat = params_to_numpy(enc)
    back = params_from_jax(flat, RC)
    for k, v in params_to_numpy(back).items():
        assert np.array_equal(v, flat[k])
    from repro.sampling.store import unflatten_tree

    packed = _packed(range(5))
    want = jax_encode_packed(
        jax.tree_util.tree_map(jnp.asarray, unflatten_tree(flat)), JRC,
        _jb(packed))
    with torch.no_grad():
        got = encode_packed(enc, RC, _tb(packed))
    _scale_close(got.numpy(), want, 1e-5)


def test_gcl_method_fits_and_plans_nw():
    """``prepare`` with no adopted encoder fits one (on the CPU only when
    asked), embeds and plans nw end to end; a card is the default."""
    cfg = GCLSamplerConfig(rgcn=RC)
    m = get_method("gcl", cfg=cfg, steps=6, batch_size=8, device="cpu")
    prog = get_program("nw")
    art = m.prepare(prog)
    assert np.isfinite(art.meta["train"]["val_loss"])
    assert art.meta["trained_on"] and "encoder_reused" not in art.meta
    plan = m.plan(prog, art)
    ev = evaluate(plan, prog, "P1")
    assert 1 <= plan.num_clusters <= len(prog)
    assert np.isfinite(ev.error_pct["cycles"]) and np.isfinite(ev.speedup)
    again = m.prepare(get_program("3mm"))        # the fitted encoder serves
    assert again.meta.get("encoder_reused")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_method("gcl", cfg=cfg)
