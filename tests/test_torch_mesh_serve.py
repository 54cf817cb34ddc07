"""Sharded LM serving over a (data, model) mesh of ranks, on the CPU, against
the JAX package: ``decode_state_axes`` and the batch / decode-state specs
(``launch/steps.batch_specs_tree`` / ``decode_state_specs_tree``) against
JAX's, and ``launch/steps.make_sharded_prefill_step`` /
``make_sharded_decode_step`` on four gloo ranks.

The ranks run once for the module (one intra-op thread a rank, results
through files), while this process computes the JAX references:

- JAX's stored prefill and 16 greedy tokens (``reference_lm.npz``,
  llama3.2-3b, mamba2-780m and jamba-v0.1-52b at smoke widths, B = 2, a
  1024-token prompt, max_seq 1040) on a (2, 2) mesh, and llama's on a
  (1, 4) mesh (its q heads whole, the cache over four ranks);
- llama3.2-3b at two layers, B = 1 (replicated over the data axis, as
  ``long_500k``'s batch), a prompt of 8, 12 greedy tokens and max_seq 21
  on (2, 2): rank 1's cache block [11, 21) holds no valid position for
  the first three steps, then the decode crosses into it; and
  mamba2-780m at two layers on a (1, 3) mesh (3 of the 4 ranks): its 8
  SSM heads split ceil-wise 3 / 3 / 2, so the SSM runs whole on its
  gathered state; both run through JAX here, with seeded weights whose
  constant leaves are perturbed, and the caches unsharded against JAX's.

Every rank's logits slice, unsharded, is held to JAX's at TOL of the
largest logit (float32; the ranks sum in rank order); every greedy token
(``ModelParallel.argmax``, fed back) equals JAX's; ``Group.bytes`` after
each step equals ``ShardPlan.collective_bytes(kind=)``.  Nothing here
imports JAX at module level: the spawned ranks import this module.
"""

import functools
import math
import os
import pickle
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.config import SHAPES
from repro_torch.configs import get_arch, list_archs, smoke_arch
from repro_torch.distributed.group import init_group
from repro_torch.distributed.model_parallel import ModelParallel, ShardPlan
from repro_torch.distributed.sharding import (
    MeshRules, ceil_unshard, spec_for,
)
from repro_torch.interop import lm_params_from_jax, lm_params_to_numpy
from repro_torch.launch import mesh as mesh_mod, steps as t_steps
from repro_torch.models import transformer as t_tf

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
FIXTURE = os.path.join(ROOT, "src", "repro_torch", "assets",
                       "reference_lm.npz")
WORLD = 4
TOL = 1e-5
RANKS_DEADLINE = 120
FIX_B, FIX_PROMPT, FIX_TOKENS = 2, 1024, 16
#: the fixture runs: (arch, mesh)
FIX_RUNS = (("llama3.2-3b", (2, 2)), ("mamba2-780m", (2, 2)),
            ("jamba-v0.1-52b", (2, 2)), ("llama3.2-3b", (1, 4)))
#: the short runs held to JAX computed here: name -> (arch, config
#: changes, mesh, batch, prompt, greedy tokens, max_seq, seed)
SHORT = {"llama_b1": ("llama3.2-3b", {"num_layers": 2}, (2, 2), 1, 8, 12,
                      21, 3),
         "mamba_13": ("mamba2-780m", {"num_layers": 2}, (1, 3), 2, 8, 12,
                      21, 4)}
#: JAX's flash-decoding split softmax (``decode_split``), held to JAX's
#: decode with the same field, laid out as SHORT; the decode feeds the
#: seeded tokens of ``_feed`` (not the greedy ones, which bf16 rounding
#: may move): a prompt of 4 and max_seq 21 with 3 chunks of 7 positions,
#: so the first steps' indices (4-6) leave chunks 1 and 2 empty and
#: index 7 opens chunk 1; on (2, 2) the ranks hold [0, 11) and [11, 21)
#: and chunk 1, [7, 14), straddles them; on (1, 4) they hold 6, 6, 6 and
#: 3 positions and chunks 0-2 each straddle two ranks
SPLIT = {f"split_{dt}_{d}x{m}": (
    "llama3.2-3b", {"num_layers": 2, "decode_split": 3,
                    "compute_dtype": dt}, (d, m), 2, 4, 12, 21, 5)
    for dt in ("float32", "bfloat16") for d, m in ((2, 2), (1, 4))}
#: the bf16 split runs against JAX's bf16 decode, of the largest logit:
#: chip_smoke's bf16 serving tolerance (SERVE_MP_TOL); a straddling
#: chunk's pieces round their P·V to bf16 each at its own max, where JAX
#: rounds the chunk's once
SPLIT_BF16_TOL = 0.1
#: llama_b1 with decode_split 4, which does not divide max_seq 21: the
#: full softmax, bit for bit
UNSPLIT = ("llama_b1", {"decode_split": 4})
#: constant-initialized leaves, perturbed (test_torch_lm's PERTURB)
PERTURB = ("scale", "norm", "dt_bias", "D_skip", "bq", "bk", "bv")
#: the argmax ties: vocabularies split over 2 and 4 model ranks (509
#: over 4: 128, 128, 128 and 125 words)
TIE_RUNS = ((512, (2, 2)), (509, (1, 4)))
#: the faked JAX sizes (test_torch_model_parallel's MESHES)
MESHES = {"2x2": ((2, 2), ("data", "model"), ("data",)),
          "16x16": ((16, 16), ("data", "model"), ("data",)),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"),
                      ("pod", "data"))}


def _fix_cfg(arch):
    base = smoke_arch(arch)
    if base.num_experts:
        return base.replace(moe_seq_chunk=FIX_PROMPT // 2)
    return base.replace(num_layers=2 * base.block_size)


def _spec_of(name):
    return SHORT[name] if name in SHORT else SPLIT[name]


def _short_weights(name):
    """(cfg, flat numpy params): the port's seeded draw, its constant
    leaves perturbed."""
    arch, kw, _, _, _, _, _, seed = _spec_of(name)
    cfg = smoke_arch(arch).replace(**kw)
    flat = lm_params_to_numpy(t_tf.init_params(
        cfg, torch.Generator().manual_seed(seed), device="cpu"))
    rng = np.random.default_rng(seed + 100)
    for key in sorted(flat):
        if key.rsplit("/", 1)[-1] in PERTURB:
            flat[key] = (flat[key] + 0.1 * rng.standard_normal(
                flat[key].shape)).astype(np.float32)
    return cfg, flat


def _short_prompt(name, cfg):
    _, _, _, B, P, _, _, seed = _spec_of(name)
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, P)).astype(np.int32)


def _feed(name, cfg):
    """The (B, T) tokens a SPLIT run's decode steps take."""
    _, _, _, B, _, T, _, seed = _spec_of(name)
    return np.random.default_rng(seed + 1).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)


def _tie_logits(V, B=6):
    """Rows whose maxima tie across a model rank boundary (and within a
    rank, and everywhere)."""
    x = np.random.default_rng(V).standard_normal((B, V)).astype(np.float32)
    w = -(-V // 2) if V == 512 else -(-V // 4)
    x[0, [w - 1, w]] = 9.0                    # across the first boundary
    x[1, [w + 3, V - 3]] = 9.0                # later ranks
    x[2, :] = 1.0                             # every word
    x[3, [V - 1]] = 9.0                       # the last word alone
    x[4, [2, w + 2]] = 9.0                    # rank 0 and rank 1
    x[5, [V - 2, V - 1]] = 9.0                # inside the last rank
    return x


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _serve(cfg, params, prompts, tokens, max_seq, mesh, groups, feed=None):
    """Prefill then ``tokens`` greedy decode steps on this rank (or steps
    on the rank's rows of ``feed``'s tokens)."""
    rules = mesh_mod.make_rules(mesh)
    pf = t_steps.make_sharded_prefill_step(cfg, rules, groups)
    dc = t_steps.make_sharded_decode_step(cfg, rules, groups)
    plan, idx = pf.plan, groups.index
    B, P = prompts.shape
    state = plan.decode_state(B, max_seq, rank=idx)
    shapes = {"/".join(p): tuple(x.shape)
              for p, x in _flat(state["caches"]).items()}
    pr = plan.shard(params, idx)
    batch = plan.serve_batch({"tokens": torch.from_numpy(prompts)}, idx)
    b0 = groups.bytes
    logits, state = pf(pr, batch, state)
    tok = pf.argmax(logits)
    carried = [groups.bytes - b0]
    out = {"logits": [logits.float().numpy().copy()],
           "tokens": [tok.numpy()],
           "rows": batch["tokens"].shape[0]}
    if feed is not None:
        feed = plan.serve_batch({"tokens": torch.from_numpy(feed)},
                                idx)["tokens"]
    for t in range(tokens):
        if feed is not None:
            tok = feed[:, t]
        b0 = groups.bytes
        logits, state = dc(pr, state, {"tokens": tok[:, None].int()})
        tok = dc.argmax(logits)
        carried.append(groups.bytes - b0)
        out["logits"].append(logits.float().numpy().copy())
        out["tokens"].append(tok.numpy())
    out.update(
        bytes=carried, shapes=shapes, span=tuple(state["span"]),
        index=state["index"], info=pf.info,
        counted={"prefill": plan.collective_bytes(B, P, kind="prefill"),
                 "decode": plan.collective_bytes(B, max_seq,
                                                 kind="decode")},
        caches={k: v.float().numpy().copy() for k, v in
                _flat(state["caches"]).items()})
    return out


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _rank_main(rank, world, tmp):
    torch.set_num_threads(1)
    g = init_group("gloo", rank, world, os.path.join(tmp, "store"))
    meshes = {}
    for shape in ((2, 2), (1, 4), (1, 3)):
        mesh = mesh_mod.make_debug_mesh(*shape, group=g)
        meshes[shape] = (mesh, g.mesh_groups(mesh))
    out = {"fixture": {}, "short": {}, "ties": {}}
    with np.load(FIXTURE) as f:
        ref = {k: f[k] for k in f.files}
    for arch, shape in FIX_RUNS:
        cfg = _fix_cfg(arch)
        pre = f"{arch}:param:"
        params = lm_params_from_jax({k[len(pre):]: v for k, v in ref.items()
                                     if k.startswith(pre)}, cfg)
        mesh, groups = meshes[shape]
        out["fixture"][(arch, shape)] = _serve(
            cfg, params, ref[f"{arch}:prompts"], FIX_TOKENS,
            FIX_PROMPT + FIX_TOKENS, mesh, groups)
    for name, (_, _, shape, _, _, T, S, _) in SHORT.items():
        mesh, groups = meshes[shape]
        if groups is None:
            continue
        cfg, flat = _short_weights(name)
        out["short"][name] = _serve(cfg, lm_params_from_jax(flat, cfg),
                                    _short_prompt(name, cfg), T, S, mesh,
                                    groups)
    out["split"] = {}
    for name, (_, _, shape, _, _, T, S, _) in SPLIT.items():
        mesh, groups = meshes[shape]
        cfg, flat = _short_weights(name)
        # the compute params, as ``serve.main`` holds them (the counted
        # bytes assume them)
        params = t_tf.compute_params(cfg, lm_params_from_jax(flat, cfg))
        out["split"][name] = _serve(cfg, params,
                                    _short_prompt(name, cfg), T, S, mesh,
                                    groups, _feed(name, cfg))
    name, kw = UNSPLIT
    _, _, shape, _, _, T, S, _ = SHORT[name]
    mesh, groups = meshes[shape]
    cfg, flat = _short_weights(name)
    out["unsplit"] = _serve(cfg.replace(**kw), lm_params_from_jax(flat, cfg),
                            _short_prompt(name, cfg), T, S, mesh, groups)
    for V, shape in TIE_RUNS:
        mesh, groups = meshes[shape]
        cfg = smoke_arch("llama3.2-3b").replace(vocab_size=V)
        m = ModelParallel(ShardPlan(cfg, mesh_mod.make_rules(mesh)), groups,
                          {}, serving=True)
        lo, hi = m.plan.logits_range(groups.coords)
        x = torch.from_numpy(_tie_logits(V))
        b0 = groups.bytes
        got = m.argmax(x[:, lo:hi].contiguous())
        out["ties"][V] = {"got": got.numpy(), "range": (lo, hi),
                          "bytes": groups.bytes - b0}
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module", autouse=True)
def spawned(tmp_path_factory):
    """The ranks, started with the module: the spec tests and JAX's runs
    go on here meanwhile."""
    tmp = str(tmp_path_factory.mktemp("serve_ranks"))
    ctx = mp.start_processes(_rank_main, args=(WORLD, tmp), nprocs=WORLD,
                             join=False, start_method="spawn")
    return ctx, tmp


@pytest.fixture(scope="module")
def jax_short(spawned):
    """JAX's logits, greedy tokens and caches of every SHORT run, computed
    while the ranks run."""
    import jax
    import jax.numpy as jnp

    from repro.configs import smoke_arch as j_smoke_arch
    from repro.launch.serve import _splice_prefill as j_splice
    from repro.models import transformer as j_tf
    from repro.sampling.store import unflatten_tree

    out = {}
    for name, (arch, kw, _, B, _, T, S, _) in {**SHORT, **SPLIT}.items():
        cfg, flat = _short_weights(name)
        feed = _feed(name, cfg) if name in SPLIT else None
        jcfg = j_smoke_arch(arch).replace(**kw)
        params = jax.tree_util.tree_map(jnp.asarray, unflatten_tree(flat))
        logits, caches, idx = j_tf.prefill(
            jcfg, params, jnp.asarray(_short_prompt(name, cfg)))
        state = j_splice(jcfg, j_tf.init_decode_state(jcfg, B, S, int(idx)),
                         caches, int(idx))
        decode = jax.jit(lambda p, s, t, c=jcfg: j_tf.decode_step(c, p, s, t))
        steps, greedy = [np.asarray(logits, np.float32)], []
        for t in range(T):
            tok = jnp.argmax(steps[-1], -1)[:, None].astype(jnp.int32)
            if feed is not None:
                tok = jnp.asarray(feed[:, t:t + 1])
            greedy.append(np.asarray(tok)[:, 0])
            lg, state = decode(params, state, tok)
            steps.append(np.asarray(lg, np.float32))
        greedy.append(np.argmax(steps[-1], -1))
        out[name] = {"logits": steps, "tokens": greedy,
                     "caches": jax.tree_util.tree_map(np.asarray,
                                                      state["caches"])}
    return out


@pytest.fixture(scope="module")
def ranks(spawned, jax_short):
    ctx, tmp = spawned
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


@pytest.fixture(scope="module")
def fixture_ref():
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


def _close(got, want, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale, err / scale)


def _rules(shape):
    return mesh_mod.make_rules(mesh_mod.rank_mesh(shape))


def _runs(ranks, kind, key, shape):
    """The ranks of ``shape``'s mesh's records of run ``key``."""
    n = math.prod(shape)
    return [ranks[r][kind][key] for r in range(n)]


def _unshard_logits(runs, cfg, shape, B, t):
    rules = _rules(shape)
    spec = spec_for(("batch", "vocab"), (B, cfg.vocab_size), rules=rules,
                    is_param=False)
    return ceil_unshard([torch.from_numpy(o["logits"][t]) for o in runs],
                        (B, cfg.vocab_size), spec, rules.mesh).numpy()


# ---------------------------------------------------------------------------
# specs against JAX's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_rules():
    """JAX's MeshRules with faked sizes, one per MESHES entry."""
    import jax

    from repro.distributed.sharding import MeshRules as JMeshRules

    out = {}
    for name, (shape, axes, batch_axes) in MESHES.items():
        msize, fsize = shape[-1], math.prod(shape[:-1])

        class R(JMeshRules):
            @property
            def model_size(self, m=msize):
                return m

            @property
            def fsdp_size(self, f=fsize):
                return f

        out[name] = R(mesh=jax.make_mesh((1, 1), ("data", "model")),
                      batch_axes=batch_axes)
    return out


def _mesh_rules(name):
    shape, axes, batch_axes = MESHES[name]
    return MeshRules(mesh=mesh_mod.rank_mesh(shape, axes),
                     batch_axes=batch_axes)


@pytest.mark.parametrize("arch", list_archs())
def test_decode_state_axes_match_jax(arch):
    from repro.configs import get_arch as j_get_arch
    from repro.models import transformer as j_tf

    assert t_tf.decode_state_axes(get_arch(arch)) == j_tf.decode_state_axes(
        j_get_arch(arch))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_serving_specs_match_jax_on_every_leaf(jax_rules, arch, mesh):
    """Every decode-state leaf at ``decode_32k`` (and ``long_500k`` where
    it applies) and every batch field of the three serving shapes: the
    port's spec against JAX's ``spec_for`` over its axes trees (shapes
    from JAX's ``decode_state_specs`` / ``batch_specs``); the index
    replicated."""
    from repro.distributed.sharding import spec_for as j_spec_for

    from repro_torch.config import shape_applicable

    cfg, rules = get_arch(arch), _mesh_rules(mesh)
    for shape in ("prefill_32k", "decode_32k", "long_500k"):
        if not shape_applicable(cfg, SHAPES[shape])[0]:
            continue
        got = t_steps.batch_specs_tree(cfg, SHAPES[shape], rules)
        batch_axes, batch_shapes, axes, shapes = _jax_serving(arch, shape)
        for k, names in batch_axes.items():
            want = j_spec_for(names, batch_shapes[k], rules=jax_rules[mesh],
                              is_param=False)
            assert got[k] == tuple(want), (shape, k)
        if shape == "prefill_32k":
            continue
        got = t_steps.decode_state_specs_tree(cfg, SHAPES[shape], rules)
        assert got["index"] == ()
        mine = _flat(got["caches"])
        assert set(mine) == set(axes) == set(shapes)
        for key, names in axes.items():
            want = j_spec_for(names, shapes[key], rules=jax_rules[mesh],
                              is_param=False)
            assert mine[key] == tuple(want), (shape, key, mine[key], want)


@functools.lru_cache(maxsize=None)
def _jax_serving(arch, shape):
    """JAX's batch axes and shapes, and its decode-state axes and shapes
    (``decode_state_specs``: ``jax.eval_shape``), of a serving cell."""
    import jax

    from repro.config import SHAPES as J_SHAPES
    from repro.configs import get_arch as j_get_arch
    from repro.models import specs as j_specs
    from repro.models import transformer as j_tf

    jcfg, jshape = j_get_arch(arch), J_SHAPES[shape]
    batch = {k: tuple(v.shape)
             for k, v in j_specs.batch_specs(jcfg, jshape).items()}
    if jshape.kind != "decode":
        return j_specs.batch_axes_tree(jcfg, jshape), batch, None, None
    axes = _flat(j_tf.decode_state_axes(jcfg)["caches"])
    shapes = {tuple(p.key for p in path): tuple(x.shape)
              for path, x in jax.tree_util.tree_leaves_with_path(
                  j_specs.decode_state_specs(jcfg, jshape)["caches"])}
    return j_specs.batch_axes_tree(jcfg, jshape), batch, axes, shapes


def test_long_500k_batch_is_replicated_by_the_rules():
    """``long_500k``'s global batch of 1 does not divide over the data
    ranks: the spec (rule 1) leaves it replicated, so every rank of a
    (2, 2) mesh serves the one row, where ``local_batch`` refuses it; its
    decode-state blocks hold that row and ceil(S / 2) positions."""
    cfg = get_arch("jamba-v0.1-52b").replace(num_layers=8)
    rules = _rules((2, 2))
    specs = t_steps.batch_specs_tree(cfg, SHAPES["long_500k"], rules)
    assert specs == {"tokens": (None, None)}
    plan = ShardPlan(cfg, rules)
    batch = {"tokens": torch.arange(7, dtype=torch.int32)[None]}
    for r in range(4):
        assert torch.equal(plan.serve_batch(batch, r)["tokens"],
                           batch["tokens"])
    with pytest.raises(ValueError, match="does not split"):
        plan.local_batch(batch, 0)
    S = SHAPES["long_500k"].seq_len
    st = plan.decode_state(1, S, device="meta", rank=3)
    assert st["caches"]["pos4"]["k"].shape == (1, 1, S // 2, 8, 128)
    assert tuple(st["span"]) == (S // 2, S, True, S)


def test_decode_state_blocks_follow_the_ceil_rule():
    """max_seq 21 over two model ranks: positions [0, 11) and [11, 21);
    over four: 6, 6, 6 and 3; a rank holds only its block of its rows
    (``meta``: no storage)."""
    cfg = smoke_arch("llama3.2-3b").replace(num_layers=2)
    plan = ShardPlan(cfg, _rules((2, 2)))
    got = [plan.decode_state(4, 21, device="meta", rank=r) for r in range(4)]
    assert [tuple(s["span"]) for s in got] == [(0, 11, True, 21),
                                               (11, 21, True, 21)] * 2
    assert got[1]["caches"]["pos0"]["k"].shape == (2, 2, 10, 2, 16)
    plan = ShardPlan(cfg, _rules((1, 4)))
    spans = [tuple(plan.decode_state(1, 21, device="meta", rank=r)["span"])
             for r in range(4)]
    assert spans == [(0, 6, True, 21), (6, 12, True, 21),
                     (12, 18, True, 21), (18, 21, True, 21)]
    assert plan.state_bytes(1, 21, rank=3) * 2 == plan.state_bytes(1, 21)


# ---------------------------------------------------------------------------
# the ranks against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,shape", FIX_RUNS)
def test_fixture_logits_and_tokens_match_jax(ranks, fixture_ref, arch,
                                             shape):
    """JAX's stored prefill logits and the 16 decode steps' logits, every
    rank's vocabulary slice unsharded, at TOL; every greedy token (the
    ranks' own ``argmax``, fed back) equal to JAX's on every rank."""
    runs = _runs(ranks, "fixture", (arch, shape), shape)
    cfg = _fix_cfg(arch)
    want = [fixture_ref[f"{arch}:prefill_logits"]] + list(
        fixture_ref[f"{arch}:decode_logits"])
    greedy = fixture_ref[f"{arch}:tokens"]
    d = shape[0]
    for t in range(FIX_TOKENS + 1):
        _close(_unshard_logits(runs, cfg, shape, FIX_B, t), want[t])
    for r, o in enumerate(runs):
        rows = slice((r // shape[1]) * (FIX_B // d),
                     (r // shape[1] + 1) * (FIX_B // d))
        got = np.stack(o["tokens"][:FIX_TOKENS], axis=1)
        assert np.array_equal(got, greedy[rows]), (r, got, greedy[rows])
        assert o["index"] == FIX_PROMPT + FIX_TOKENS


@pytest.mark.parametrize("name", sorted(SHORT))
def test_short_runs_match_jax(ranks, jax_short, name):
    """A prompt of 8, 12 greedy tokens, max_seq 21 (llama: B = 1 over
    two data ranks; mamba on (1, 3)): logits at every step, the greedy
    tokens and the unsharded caches against JAX's."""
    arch, kw, shape, B, P, T, S, _ = SHORT[name]
    runs = _runs(ranks, "short", name, shape)
    cfg = smoke_arch(arch).replace(**kw)
    ref = jax_short[name]
    for t in range(T + 1):
        _close(_unshard_logits(runs, cfg, shape, B, t), ref["logits"][t])
    for o in runs:
        assert o["rows"] == B
        assert np.array_equal(np.stack(o["tokens"], 1),
                              np.stack(ref["tokens"], 1))
    plan = ShardPlan(cfg, _rules(shape))
    whole = _flat(plan.unshard_state(
        [{"caches": _nest({k: torch.from_numpy(v)
                           for k, v in o["caches"].items()})}
         for o in runs], B, S))
    jflat = _flat(ref["caches"])
    assert set(whole) == set(jflat)
    for key, got in whole.items():
        _close(got.numpy(), jflat[key], 1e-4)


def _nest(flat):
    out = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def test_a_rank_with_no_valid_position_and_the_crossing(ranks, jax_short):
    """llama's B = 1 run on (2, 2): rank 1 (model coordinate 1) holds
    positions [11, 21), none valid while the index is 8-10; its cache
    rows are zero until the decode writes position 11 into its block;
    every step's logits are JAX's (``test_short_runs_match_jax``)."""
    runs = _runs(ranks, "short", "llama_b1", (2, 2))
    assert [o["span"] for o in runs] == [(0, 11, True, 21),
                                         (11, 21, True, 21)] * 2
    k = runs[1]["caches"][("pos0", "k")]
    assert k.shape == (2, 1, 10, 2, 16)
    assert np.abs(k[:, :, :9]).max() > 0          # positions 11-19
    assert np.abs(k[:, :, 9]).max() == 0          # position 20: not reached


@pytest.mark.parametrize("run", [("fixture", r) for r in FIX_RUNS]
                         + [("short", n) for n in sorted(SHORT)])
def test_group_bytes_equal_the_counted_bytes(ranks, run):
    """``Group.bytes`` after the prefill step and after each decode step
    (each with its greedy token) equal ``collective_bytes(kind=)`` on
    every rank of the mesh."""
    kind, key = run
    shape = key[1] if kind == "fixture" else SHORT[key][2]
    for o in _runs(ranks, kind, key, shape):
        c = o["counted"]
        assert o["bytes"][0] == c["prefill"]["total"] > 0
        assert set(o["bytes"][1:]) == {c["decode"]["total"]}
        for part in c.values():
            assert part["total"] == sum(v for k, v in part.items()
                                        if k != "total")


@pytest.mark.parametrize("arch,shape", FIX_RUNS)
def test_a_rank_allocates_its_block_of_the_decode_state(ranks, arch, shape):
    """Each rank's attention cache is ceil(1040 / m) positions (less on
    the last rank) of its batch rows, its SSM cache its heads; the split
    leaves and modes are the plan's."""
    cfg = _fix_cfg(arch)
    d, m = shape
    S = FIX_PROMPT + FIX_TOKENS
    w = -(-S // m)
    for r, o in enumerate(_runs(ranks, "fixture", (arch, shape), shape)):
        c = r % m
        for key, shp in o["shapes"].items():
            leaf = key.rsplit("/", 1)[-1]
            assert shp[1] == FIX_B // d, (key, shp)
            if leaf in ("k", "v"):
                assert shp[2] == min(w, S - c * w)
                assert o["span"] == (c * w, min((c + 1) * w, S), True, S)
            elif leaf == "ssm":
                assert shp[2] == cfg.ssm_heads // m
        assert o["info"]["mesh"] == shape


@pytest.mark.parametrize("V,shape", TIE_RUNS)
def test_argmax_breaks_ties_as_torch_argmax(ranks, V, shape):
    """``ModelParallel.argmax`` of logits split by vocabulary equals
    ``torch.argmax`` of the whole logits, the first maximum, on ties
    placed across rank boundaries, inside one rank and everywhere; one
    gather of (value, index) a step."""
    want = torch.argmax(torch.from_numpy(_tie_logits(V)), -1).numpy()
    n, m = math.prod(shape), shape[1]
    for r in range(n):
        rec = ranks[r]["ties"][V]
        assert np.array_equal(rec["got"], want), (r, rec["got"], want)
        assert rec["bytes"] == m * 2 * len(want) * 8
    assert want[0] == -(-V // m) - 1 and want[2] == 0


# ---------------------------------------------------------------------------
# decode_split: JAX's flash-decoding split softmax
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SPLIT))
def test_split_softmax_on_the_mesh_matches_jax(ranks, jax_short, name):
    """``decode_split`` 3 over max_seq 21 on (2, 2) and (1, 4): the
    prefill and every decode step's logits (the ranks' slices unsharded)
    against JAX's decode with the same field, float32 at TOL and bf16 at
    SPLIT_BF16_TOL of the largest logit; the collective bytes as
    counted (the merge carries what the unsplit merge does)."""
    arch, kw, shape, B, P, T, S, _ = SPLIT[name]
    runs = _runs(ranks, "split", name, shape)
    cfg = smoke_arch(arch).replace(**kw)
    tol = TOL if kw["compute_dtype"] == "float32" else SPLIT_BF16_TOL
    ref = jax_short[name]
    for t in range(T + 1):
        _close(_unshard_logits(runs, cfg, shape, B, t), ref["logits"][t],
               tol)
    for o in runs:
        assert o["bytes"][0] == o["counted"]["prefill"]["total"]
        assert set(o["bytes"][1:]) == {o["counted"]["decode"]["total"]}


def test_split_that_does_not_divide_the_cache_is_the_full_softmax(ranks):
    """``decode_split`` 4 does not divide max_seq 21: llama_b1's run with
    it is the unsplit run, bit for bit (JAX reads the condition on the
    whole cache length, not a rank's block)."""
    shape = SHORT[UNSPLIT[0]][2]
    for r in range(math.prod(shape)):
        got, want = ranks[r]["unsplit"], ranks[r]["short"][UNSPLIT[0]]
        assert all(np.array_equal(a, b) for a, b in zip(got["logits"],
                                                       want["logits"]))
        assert got["bytes"] == want["bytes"]


#: one card: (decode_split, max_seq, cache_index): the index inside the
#: first chunk (the later chunks empty), at a chunk boundary, in the
#: last chunk, and a split that does not divide the cache
ONE_CARD_SPLITS = [(4, 16, 2), (4, 16, 4), (4, 16, 15), (8, 32, 9),
                   (5, 16, 7)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("split,S,index", ONE_CARD_SPLITS)
def test_one_card_split_softmax_matches_jax(split, S, index, dtype):
    """``decode_attention_forward`` with ``decode_split`` on one card
    against JAX's on the same weights, hidden state and cache: float32
    at TOL of the largest output, bf16 at 2e-2 (K7's bf16 tolerance in
    ``test_torch_lm``); where the split does not divide the cache, the
    port's output is the unsplit one bit for bit."""
    import jax.numpy as jnp

    from repro.configs import smoke_arch as j_smoke_arch
    from repro.models import attention as j_attn

    from repro_torch.models import attention as t_attn

    kw = {"decode_split": split, "compute_dtype": dtype}
    jcfg = j_smoke_arch("llama3.2-3b").replace(**kw)
    cfg = smoke_arch("llama3.2-3b").replace(**kw)
    D, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    rng = np.random.default_rng(split * 100 + index)
    p = {n: (0.1 * rng.standard_normal(shp)).astype(np.float32) for n, shp in
         (("wq", (D, H, hd)), ("wk", (D, K, hd)), ("wv", (D, K, hd)),
          ("wo", (H, hd, D)))}
    h = rng.standard_normal((2, 1, D)).astype(np.float32)
    cache = {n: rng.standard_normal((2, S, K, hd)).astype(np.float32)
             for n in ("k", "v")}
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want, _ = j_attn.decode_attention_forward(
        jcfg, {k: jnp.asarray(v) for k, v in p.items()},
        jnp.asarray(h).astype(jdt),
        {k: jnp.asarray(v).astype(jdt) for k, v in cache.items()}, index)

    def port(c):
        out, _ = t_attn.decode_attention_forward(
            c, {k: torch.from_numpy(v) for k, v in p.items()},
            torch.from_numpy(h).to(tdt),
            {k: torch.from_numpy(v).to(tdt) for k, v in cache.items()},
            index)
        return out.float().numpy()

    got = port(cfg)
    _close(got, np.asarray(want, np.float32),
           TOL if dtype == "float32" else 2e-2)
    if S % split:
        assert np.array_equal(got, port(cfg.replace(decode_split=0)))
