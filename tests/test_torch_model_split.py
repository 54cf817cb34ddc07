"""The model placements that a (data, model) mesh splits in compute beyond
attention and the dense FFN (``distributed/model_parallel.py``): the
vocabulary-parallel cross-entropy, the SSM's gated norm over a rank's
``d_inner`` columns and the MoE experts' ``ffn``, each on two gloo ranks
of a (1, 2) mesh against the port's one-card function on the same
seeded inputs, and the plan's choice of modes on abstract meshes.

The one-card functions are held to JAX elsewhere (``test_torch_lm.py``,
``test_torch_lm_train.py``, ``test_torch_moe.py``); the whole sharded
step of every split against JAX runs in ``test_torch_model_parallel.py``.
The ranks run once for the module (one intra-op thread a rank, results
through a file).  Tolerances, float32: values 1e-6 relative, gradients
1e-5 of their norm (the ranks' sums are taken in another order).
Nothing here imports JAX: the spawned ranks import this module.
"""

import math
import os
import pickle
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs import get_arch, smoke_arch
from repro_torch.distributed.group import init_group
from repro_torch.distributed.model_parallel import (
    MOE_SPLIT, SSM_SPLIT, ModelParallel, ShardPlan,
)
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import layers as t_layers
from repro_torch.models import moe as t_moe

WORLD = 2
TOL = 1e-6
GRAD_TOL = 1e-5
RANKS_DEADLINE = 120
#: the uneven vocabulary: ranks take ceil(509 / 2) = 255 and 254 words;
#: the loss chunk 16 over S = 40 leaves a remainder chunk of 8
CE = dict(vocab_size=509, loss_chunk=16)
CE_SHAPE = (2, 40)
#: ROADMAP C9's overflow: B=1, S=6, k=1, E=2, C=2, experts [0,0,0,0,1,0]
C9 = dict(num_experts=2, top_k=1, capacity_factor=0.5)
C9_EXPERTS = [0, 0, 0, 0, 1, 0]


def _ce_inputs():
    cfg = smoke_arch("llama3.2-3b").replace(**CE)
    rng = np.random.default_rng(7)
    B, S = CE_SHAPE
    h = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    w = (0.3 * rng.standard_normal((cfg.d_model, cfg.vocab_size))
         ).astype(np.float32)
    y = rng.integers(0, cfg.vocab_size, (B, S))
    y[0, :5] = -1
    y[1, 17] = -1
    y[1, 20:23] = (0, 254, 508)        # the ranges' first and last words
    y[1, 30] = 255
    return cfg, h, w, y


def _norm_inputs():
    cfg = smoke_arch("mamba2-780m")
    rng = np.random.default_rng(8)
    shape = (2, 16, cfg.d_inner)
    x, z, g = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    scale = (1 + 0.1 * rng.standard_normal(cfg.d_inner)).astype(np.float32)
    return cfg, x, z, g, scale


def _moe_inputs():
    """C9's case (test_torch_moe's ``_one_hot_router``) with the port's
    seeded expert weights and an upstream gradient."""
    cfg = smoke_arch("dbrx-132b").replace(**C9)
    p = {k: v.numpy() for k, v in t_moe.init_moe(
        torch.Generator().manual_seed(5), cfg).items()}
    D, E = cfg.d_model, cfg.num_experts
    router = np.zeros((D, E), np.float32)
    for e in range(E):
        router[e, e] = 1.0
    p["router"] = router
    h = np.zeros((1, len(C9_EXPERTS), D), np.float32)
    for s, e in enumerate(C9_EXPERTS):
        h[0, s, e] = 4.0
        h[0, s, E:] = np.random.default_rng(s).standard_normal(D - E)
    g = np.random.default_rng(9).standard_normal(h.shape).astype(np.float32)
    return cfg, p, h, g


def _mp(cfg, mesh, groups):
    plan = ShardPlan(cfg, mesh_mod.make_rules(mesh))
    return ModelParallel(plan, groups, {})


def _leaf(x):
    return torch.from_numpy(np.ascontiguousarray(x)).requires_grad_(True)


def _np(t):
    return t.detach().numpy().copy()


def _rank_main(rank, world, tmp):
    torch.set_num_threads(1)
    g = init_group("gloo", rank, world, os.path.join(tmp, "store"))
    mesh = mesh_mod.make_debug_mesh(1, WORLD, group=g)
    groups = g.mesh_groups(mesh)
    out = {}

    cfg, h, w, y = _ce_inputs()
    m = _mp(cfg, mesh, groups)
    lo, hi = m.vocab_range
    hh, wr = _leaf(h), _leaf(w[:, lo:hi])
    loss = t_layers.chunked_cross_entropy(cfg, hh, wr, torch.from_numpy(y),
                                          m)
    dh, dw = torch.autograd.grad(loss, (hh, wr))
    out["ce"] = {"range": (lo, hi), "mode": m.plan.split_vocab,
                 "loss": float(loss.detach()), "dh": _np(dh), "dw": _np(dw)}

    cfg, x, z, gy, scale = _norm_inputs()
    m = _mp(cfg, mesh, groups)
    n = cfg.d_inner // WORLD
    cols = slice(rank * n, (rank + 1) * n)
    xr, zr, sr = _leaf(x[..., cols]), _leaf(z[..., cols]), _leaf(scale[cols])
    yr = t_layers.rmsnorm_gated(sr, xr, zr, cfg.norm_eps, m)
    grads = torch.autograd.grad(yr, (xr, zr, sr),
                                torch.from_numpy(gy[..., cols].copy()))
    out["norm"] = {"split": m.split_ssm, "y": _np(yr),
                   "grads": [_np(t) for t in grads]}

    cfg, p, h, gy = _moe_inputs()
    m = _mp(cfg, mesh, groups)
    f = cfg.d_ff // WORLD
    sl = slice(rank * f, (rank + 1) * f)
    pr = {"router": _leaf(p["router"]), "w1": _leaf(p["w1"][..., sl]),
          "w3": _leaf(p["w3"][..., sl]), "w2": _leaf(p["w2"][:, sl])}
    hh = _leaf(h)
    o, aux = t_moe.moe_forward(cfg, pr, hh, m)
    leaves = (hh, pr["router"], pr["w1"], pr["w3"], pr["w2"])
    grads = torch.autograd.grad((o * torch.from_numpy(gy)).sum() + aux,
                                leaves)
    out["moe"] = {"split": m.split_moe, "out": _np(o),
                  "aux": float(aux.detach()),
                  "grads": [_np(t) for t in grads]}
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("split_ranks"))
    ctx = mp.start_processes(_rank_main, args=(WORLD, tmp), nprocs=WORLD,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + RANKS_DEADLINE
    try:
        while not ctx.join(timeout=1):
            assert time.monotonic() < deadline, "the ranks timed out"
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()
    out = []
    for r in range(WORLD):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as fh:
            out.append(pickle.load(fh))
    return out


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _gap(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def test_vocab_parallel_ce_matches_one_card_on_an_uneven_vocabulary(ranks):
    """509 words over two model ranks (255 and 254: the table "take"n from
    the whole, as m does not divide V) and labels of -1 ignored: each
    rank's loss equals the one-card ``chunked_cross_entropy``, its h
    gradient (its columns' part summed over the ranks by ``copy_in``) the
    whole one, its head gradient the one card's columns."""
    cfg, h, w, y = _ce_inputs()
    hh, ww = _leaf(h), _leaf(w)
    loss = t_layers.chunked_cross_entropy(cfg, hh, ww, torch.from_numpy(y))
    dh, dw = torch.autograd.grad(loss, (hh, ww))
    assert [o["ce"]["range"] for o in ranks] == [(0, 255), (255, 509)]
    for o in ranks:
        rec = o["ce"]
        lo, hi = rec["range"]
        assert rec["mode"] == "take"
        assert _rel(rec["loss"], float(loss.detach())) <= TOL
        assert _gap(rec["dh"], _np(dh)) <= GRAD_TOL
        assert _gap(rec["dw"], _np(dw)[:, lo:hi]) <= GRAD_TOL
    assert ranks[0]["ce"]["loss"] == ranks[1]["ce"]["loss"]
    assert np.array_equal(ranks[0]["ce"]["dh"], ranks[1]["ce"]["dh"])


def test_gated_norm_over_two_ranks_matches_one_rank(ranks):
    """The gated norm on each rank's half of ``d_inner`` (the sum of
    squares summed over the ranks both ways): the outputs are the one
    rank's columns and so are the gradients of x, z and the scale."""
    cfg, x, z, gy, scale = _norm_inputs()
    leaves = [_leaf(a) for a in (x, z, scale)]
    y = t_layers.rmsnorm_gated(leaves[2], leaves[0], leaves[1], cfg.norm_eps)
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(gy))
    n = cfg.d_inner // WORLD
    for r, o in enumerate(ranks):
        rec = o["norm"]
        cols = slice(r * n, (r + 1) * n)
        assert rec["split"]
        assert _gap(rec["y"], _np(y)[..., cols]) <= TOL
        for got, want in zip(rec["grads"], grads):
            assert _gap(got, _np(want)[..., cols]) <= GRAD_TOL


def test_c9_overflow_under_a_split_moe(ranks):
    """ROADMAP C9's case with the experts' ``ffn`` split over two model
    ranks: routing, dispatch and the C-1 rule run alike on both, so token
    1 (kept at C-1) is lost and tokens 2, 3, 5 dropped as on one card;
    the summed output, aux and every gradient equal the one card's (the
    router's, and h's, bit-equal on both ranks)."""
    cfg, p, h, gy = _moe_inputs()
    assert t_moe.capacity(cfg, len(C9_EXPERTS)) == 2
    pt = {k: _leaf(v) for k, v in p.items()}
    hh = _leaf(h)
    o, aux = t_moe.moe_forward(cfg, pt, hh)
    leaves = (hh, pt["router"], pt["w1"], pt["w3"], pt["w2"])
    grads = torch.autograd.grad((o * torch.from_numpy(gy)).sum() + aux,
                                leaves)
    served = np.abs(_np(o)[0]).max(-1) > 0
    assert served.tolist() == [True, False, False, False, True, False]
    f = cfg.d_ff // WORLD
    for r, rec in enumerate(o_["moe"] for o_ in ranks):
        sl = slice(r * f, (r + 1) * f)
        assert rec["split"]
        assert _gap(rec["out"], _np(o)) <= TOL
        assert np.array_equal(rec["out"] == 0, _np(o) == 0)
        assert _rel(rec["aux"], float(aux.detach())) <= TOL
        want = [_np(grads[0]), _np(grads[1]), _np(grads[2])[..., sl],
                _np(grads[3])[..., sl], _np(grads[4])[:, sl]]
        for got, w in zip(rec["grads"], want):
            assert _gap(got, w) <= GRAD_TOL
    a, b = ranks[0]["moe"], ranks[1]["moe"]
    for i in (0, 1):
        assert np.array_equal(a["grads"][i], b["grads"][i])
    assert a["out"].tobytes() == b["out"].tobytes()


def _plan(cfg, shape):
    return ShardPlan(cfg, mesh_mod.make_rules(mesh_mod.rank_mesh(shape)))


def test_ssm_stays_whole_where_the_heads_do_not_divide():
    """d_inner 96 (3 heads of 32) over two model ranks: the spec puts the
    model axis on d_inner, but a rank's block would not be whole heads,
    so every SSM leaf is gathered whole; at 3 model ranks of 6 heads the
    SSM splits."""
    cfg = smoke_arch("mamba2-780m").replace(d_model=48, ssm_headdim=32)
    assert cfg.ssm_heads == 3 and cfg.d_inner == 96
    plan = _plan(cfg, (1, 2))
    assert not plan.split_ssm
    assert all(lf.mode == "whole" for lf in plan.leaves if "mixer" in lf.key)
    assert plan.by_key["blocks/pos0/mixer/in_x"].spec[2] == "model"
    six = _plan(cfg.replace(ssm_headdim=16), (1, 3))
    assert six.split_ssm and cfg.replace(ssm_headdim=16).ssm_heads == 6


def test_full_width_placements_split_on_a_2x2_mesh():
    """The leaves the issue's placements name, at the archs' widths on an
    abstract (2, 2) mesh: llama's tied table, every SSM_SPLIT leaf of
    mamba2-780m, jamba's experts and its table and head; the SSM's B / C
    and the router stay whole."""
    llama = _plan(get_arch("llama3.2-3b").replace(num_layers=2), (2, 2))
    assert llama.by_key["embed/tokens"].mode == "split"
    mamba = _plan(get_arch("mamba2-780m").replace(num_layers=2), (2, 2))
    for name in SSM_SPLIT:
        assert mamba.by_key[f"blocks/pos0/mixer/{name}"].mode == "split"
    for name in ("in_B", "in_C", "conv_B", "conv_C"):
        assert mamba.by_key[f"blocks/pos0/mixer/{name}"].mode == "whole"
    jamba = _plan(get_arch("jamba-v0.1-52b").replace(num_layers=8), (2, 2))
    for name in MOE_SPLIT:
        assert jamba.by_key[f"blocks/pos1/ffn/{name}"].mode == "split"
    assert jamba.by_key["blocks/pos1/ffn/router"].mode == "whole"
    assert jamba.by_key["embed/tokens"].mode == "split"
    assert jamba.by_key["embed/lm_head"].mode == "split"
    granite = _plan(get_arch("granite-3-2b").replace(num_layers=1), (2, 2))
    assert granite.split_vocab == "take"
    tok = granite.by_key["embed/tokens"]
    assert granite.out_shape(tok)[0] == 24578          # ceil(49155 / 2)
    assert granite.cut(tok, (0, 1)) == (24578, 49155)


def test_llama_counted_bytes_fall_with_the_vocabulary_split():
    """llama3.2-3b at its widths, 2 layers, (2, 2), JAX's CLI batch: the
    bytes a rank carries a step, counted from the plan, against the
    6,162,714,672 of the table gathered whole (both without remat); under
    JAX's default remat the blocks' gathers and forward sums run again in
    the recompute."""
    llama = get_arch("llama3.2-3b").replace(num_layers=2)
    plan = _plan(llama.replace(remat=False), (2, 2))
    got = plan.collective_bytes(8, 256)
    assert got["total"] == 3_823_886_384 < 6_162_714_672
    assert got["total"] == sum(v for k, v in got.items() if k != "total")
    assert _plan(llama, (2, 2)).collective_bytes(8, 256)["total"] == \
        4_352_466_992
    dbrx = get_arch("dbrx-132b").replace(num_layers=1)
    assert _plan(dbrx.replace(remat=False), (1, 4)).collective_bytes(
        8, 256)["total"] == 705_249_296
    assert _plan(dbrx, (1, 4)).collective_bytes(8, 256)["total"] == \
        957_349_904
    dbrx = _plan(dbrx, (1, 4))
    assert math.prod(dbrx.out_shape(dbrx.by_key["blocks/pos0/ffn/w1"])) == \
        16 * 6144 * 2688
