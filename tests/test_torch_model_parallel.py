"""LM model sharding over a (data, model) mesh of ranks, on the CPU, against
the JAX package: the parameter half of ``distributed/sharding.py``
(``spec_for``, ``param_specs``, ``check_spec``, ``shard_leaf`` /
``unshard``), the models' axis trees, ``launch/mesh.py``'s rank meshes,
the sharded train step of ``distributed/model_parallel.py`` /
``launch/steps.make_sharded_train_step``, the sharded checkpoint and the
dry run's mesh records.

Specs are held to JAX's ``spec_for`` with the mesh sizes faked as
``tests/test_sharding_rules.py`` fakes them (JAX's ``spec_for`` reads only
the rules' sizes and axis names), and blocks to JAX's
``NamedSharding.devices_indices_map`` from one subprocess with four host
devices.  The rank-side checks run in one spawn of four gloo ranks (one
intra-op thread a rank, results through files), started with the module
beside a subprocess that runs JAX's one-device steps, while this process
checks the specs: llama3.2-3b (two
layers: the vocabulary, attention and the dense FFN split over the model
axis, the norms' blocks dim over the data axis), mamba2-780m (the
vocabulary and the SSM's heads split), jamba-v0.1-52b at one block
(attention, SSM, the MoE experts' ``ffn``, the untied head) and
granite-3-2b at an uneven vocabulary (the table gathered whole and cut to
a rank's range) at smoke width, float32, three steps on a (2, 2) mesh
from seeded weights carried into the port by ``lm_params_from_jax`` and
into JAX as its params tree.

Tolerances: losses and grad norms 1e-5 relative; a leaf 1e-5 of its norm
against the port's one-card step (the same math, its sums in another
order), except jamba's and granite's parameters after three steps (see
``JAMBA_PARAM_TOL``, ``GRANITE_PARAM_TOL``); the clipped gradient (the
first step's ``mu``) 1e-4 of its norm for every arch; JAX's one-device step at
``test_torch_lm_train``'s TOL for the losses and its 1e-4 of a leaf's
norm for the parameters.  Nothing here imports JAX at module level: the
spawned ranks import this module.
"""

import functools
import json
import math
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import TrainConfig
from repro_torch.configs import get_arch, list_archs, smoke_arch
from repro_torch.distributed import sharding as t_sharding
from repro_torch.distributed.group import init_group
from repro_torch.distributed.model_parallel import (
    ModelParallel, ShardPlan, Sharding, unshard_tree,
)
from repro_torch.distributed.sharding import (
    MeshRules, check_spec, mesh_coords, region, shard_leaf, spec_for,
    unshard,
)
from repro_torch.interop import lm_params_from_jax
from repro_torch.launch import dryrun, mesh as mesh_mod, steps as t_steps
from repro_torch.launch import train as train_mod
from repro_torch.models import transformer as t_tf
from repro_torch.optim import adamw_init

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
WORLD = 4
#: the arch runs of the spawn: arch -> what its smoke config replaces
#: (granite at an uneven vocabulary, 509 words: the model ranks take
#: ceil(509 / 2) = 255 and 254 of them, as GSPMD pads its 49155)
ARCHS = {"llama3.2-3b": {"num_layers": 2}, "mamba2-780m": {},
         "jamba-v0.1-52b": {}, "granite-3-2b": {"vocab_size": 509}}
STEPS = 3
RESUME_STEPS = 2          # llama's steps after the elastic restore
TOL = 1e-5
JAX_PARAM_TOL = 1e-4
#: the clipped gradient (the first step's mu) of a leaf, of its norm:
#: tighter than test_torch_lm_train's 1e-3 for a gradient leaf; jamba's
#: dt_bias and router gradients cancel to 3e-5 of their norms
GRAD_TOL = 1e-4
#: jamba's parameters after three steps, of each leaf's norm, against
#: either reference.  Its step-0 gradients agree at TOL, but a few elements
#: of the dt_bias / router gradients are cancellations below the
#: summation-order noise; Adam turns each into a +-lr update, and the next
#: steps' gradient norms move by ~1e-4 (ROADMAP C, "Not faults").  The
#: port's own one-card step is 5.0e-3 of a leaf's norm from JAX's after
#: these three steps, so the sharded step is held as far as the two
#: references agree with each other; its losses are held at TOL
JAMBA_PARAM_TOL = 1e-2
#: granite's (the uneven vocabulary) parameters after three steps against
#: the one card, of each leaf's norm: its step-0 gradients agree to 5e-7,
#: but Adam takes w2 to 1.1e-5 after three steps, with the vocabulary
#: split (1.12e-5) as without it (1.04e-5, the table gathered whole):
#: the sharded sums' order, not the split
GRANITE_PARAM_TOL = 2e-5
TC = dict(learning_rate=3e-3, warmup_steps=1, total_steps=10)
#: gradient accumulation on (2, 2): arch -> its smoke config's changes,
#: trained STEPS steps with TC's microbatch 2 (each data rank a row of
#: each micro-batch of 2); dbrx-132b at one layer is the MoE arch (its
#: expert fractions a micro-batch's own)
MB_ARCHS = {"llama3.2-3b": {"num_layers": 2},
            "dbrx-132b": {"num_layers": 1}}
TC_MB = dict(TC, microbatch=2)
#: the train launcher with ``--microbatch 2`` (on the (2, 2) mesh through
#: ``main(mesh=)``, and on one card)
CLI_MB = ["--arch", "llama3.2-3b", "--smoke", "--device", "cpu",
          "--num-layers", "2", "--steps", "2", "--batch", "4", "--seq-len",
          "32", "--microbatch", "2", "--log-every", "1"]
#: dbrx's parameters after three micro-batched steps against the one
#: card's, of each leaf's norm: its first step's clipped gradients agree
#: within 6e-7 of a leaf's norm, but a few elements of the embedding's
#: gradient are near zero, where Adam's first updates g / (|g| + eps)
#: turn the summation-order noise into +-lr steps (6.8e-5 of embed/tokens'
#: norm after three steps; llama's largest gap is 3.8e-6)
MB_PARAM_TOL = {"llama3.2-3b": TOL, "dbrx-132b": 1e-4}
#: the faked JAX sizes of tests/test_sharding_rules.py, and the port's
#: real rank meshes of the same sizes
MESHES = {"2x2": ((2, 2), ("data", "model"), ("data",)),
          "16x16": ((16, 16), ("data", "model"), ("data",)),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"),
                      ("pod", "data"))}
#: seconds the spawn may take before the test kills it
RANKS_DEADLINE = 240


def _cfg(arch):
    return smoke_arch(arch).replace(**ARCHS[arch])


def _rules(name):
    shape, axes, batch_axes = MESHES[name]
    return MeshRules(mesh=mesh_mod.rank_mesh(shape, axes),
                     batch_axes=batch_axes)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree.detach().float().cpu().numpy().copy()}


def _norm_gap(got: dict, want: dict) -> dict:
    assert set(got) == set(want)
    return {k: float(np.linalg.norm(got[k].astype(np.float64) - want[k])
                     / max(np.linalg.norm(want[k].astype(np.float64)),
                           1e-30)) for k in want}


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _run(cfg, tc, step, plan, groups, flat, batches, record):
    """Shard ``flat``'s weights, run ``batches``; the rank's records."""
    idx = groups.index
    state = adamw_init(plan.shard(lm_params_from_jax(flat, cfg), idx), tc)
    out = {"metrics": [], "bytes": []}
    for i, b in enumerate(batches):
        carried = groups.bytes
        b = plan.local_batch({k: torch.from_numpy(v) for k, v in b.items()},
                             idx, tc.microbatch)
        state, m = step(state, b)
        out["bytes"].append(groups.bytes - carried)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if i == 0 and record:
            out["mu1"] = _flat(unshard_tree(plan, groups, state.mu))
    return state, out


def _rank_main(rank, world, tmp):
    torch.set_num_threads(1)
    g = init_group("gloo", rank, world, os.path.join(tmp, "store"))
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    tc = TrainConfig(**TC)
    m22 = mesh_mod.make_debug_mesh(2, 2, group=g)
    rules = mesh_mod.make_rules(m22)
    g22 = g.mesh_groups(m22)
    g21 = g.mesh_groups(mesh_mod.make_debug_mesh(2, 1, group=g))
    g14 = g.mesh_groups(mesh_mod.make_debug_mesh(1, 4, group=g))
    out = {"coords": g22.coords}
    backward = ModelParallel._backward
    for arch in ARCHS:
        cfg = _cfg(arch)
        grads = {}

        def recording(self, grad, lf, b, grads=grads):
            # the gradient of each leaf computed whole, before its data sum
            if lf.mode == "whole":
                grads.setdefault((lf.key, b), grad.numpy().copy())
            return backward(self, grad, lf, b)

        ModelParallel._backward = recording
        step = t_steps.make_sharded_train_step(cfg, tc, rules, g22)
        plan = step.plan
        state, rec = _run(cfg, tc, step, plan, g22, inputs[arch]["flat"],
                          inputs[arch]["batches"][:STEPS], True)
        ModelParallel._backward = backward
        rec["params"] = _flat(unshard_tree(plan, g22, state.params))
        rec["probe"] = grads
        rec["info"] = step.info
        rec["state_bytes"] = train_mod.state_bytes(state)
        rec["block_numel"] = plan.block_numel()
        rec["predicted"] = plan.collective_bytes(
            *inputs[arch]["batches"][0]["labels"].shape)
        out[arch] = rec
        if arch == "llama3.2-3b":
            ck = CheckpointManager(os.path.join(tmp, "ck"))
            ck.save(STEPS, state, sharding=Sharding(plan, g22, "cpu"))
            out["elastic"] = _elastic(cfg, tc, g21, ck, inputs[arch])
            # the whole model axis: attention computed whole (one head a
            # rank is not a multiple of G = 2), the FFN split four ways
            step = t_steps.make_sharded_train_step(
                cfg, tc, mesh_mod.make_rules(g14.mesh), g14)
            _, rec = _run(cfg, tc, step, step.plan, g14, inputs[arch]["flat"],
                          inputs[arch]["batches"][:2], False)
            rec["info"] = step.info
            rec["predicted"] = step.plan.collective_bytes(
                *inputs[arch]["batches"][0]["labels"].shape)
            out["mesh_1x4"] = rec
            # remat off: the same program without the recompute; "dots":
            # the mm outputs kept, the rest (the collectives included)
            # recomputed under the selective checkpoint
            for name, over in (("remat_off", dict(remat=False)),
                               ("remat_dots", dict(remat_policy="dots"))):
                c = cfg.replace(**over)
                step = t_steps.make_sharded_train_step(c, tc, rules, g22)
                state, rec = _run(c, tc, step, step.plan, g22,
                                  inputs[arch]["flat"],
                                  inputs[arch]["batches"][:STEPS], False)
                rec["params"] = _flat(unshard_tree(step.plan, g22,
                                                   state.params))
                rec["predicted"] = step.plan.collective_bytes(
                    *inputs[arch]["batches"][0]["labels"].shape)
                out[name] = rec
    tmb = TrainConfig(**TC_MB)
    out["microbatch"] = {}
    for arch, over in MB_ARCHS.items():
        cfg = smoke_arch(arch).replace(**over)
        step = t_steps.make_sharded_train_step(cfg, tmb, rules, g22)
        state, rec = _run(cfg, tmb, step, step.plan, g22,
                          inputs[arch]["flat"],
                          inputs[arch]["batches"][:STEPS], True)
        rec["params"] = _flat(unshard_tree(step.plan, g22, state.params))
        rec["predicted"] = step.plan.collective_bytes(
            *inputs[arch]["batches"][0]["labels"].shape, tmb)
        rec["unsplit"] = step.plan.collective_bytes(
            *inputs[arch]["batches"][0]["labels"].shape)
        out["microbatch"][arch] = rec
    try:
        train_mod.main(["--arch", "llama3.2-3b", "--smoke", "--device",
                        "cpu", "--mesh", "pod"])
    except ValueError as e:
        out["pod_error"] = str(e)
    cli = {}
    train_mod.main(CLI_MB, out=cli, mesh=m22)
    out["cli_microbatch"] = {
        "losses": [float(r["loss"]) for r in cli["steps"]],
        "bytes": cli["collective_bytes"],
        "counted": cli["plan"].collective_bytes(
            4, 32, TrainConfig(microbatch=2))["total"]}
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


def _elastic(cfg, tc, g21, ck, inputs):
    """The (2, 2) checkpoint restored on the (2, 1) mesh of ranks 0 and 1
    and run RESUME_STEPS more steps; on mesh rank 0 also the one-card
    run resumed from it."""
    if g21 is None:
        return None
    like = t_steps.train_state_specs(cfg, tc)
    step = t_steps.make_sharded_train_step(
        cfg, tc, mesh_mod.make_rules(g21.mesh), g21)
    plan = step.plan
    state, at = ck.restore(like, sharding=Sharding(plan, g21, "cpu"))
    batches = inputs["batches"][STEPS:STEPS + RESUME_STEPS]
    losses, carried = [], []
    for b in batches:
        before = g21.bytes
        state, m = step(state, plan.local_batch(
            {k: torch.from_numpy(v) for k, v in b.items()}, g21.index))
        losses.append(float(m["loss"]))
        carried.append(g21.bytes - before)
    out = {"at": at, "step": state.step, "losses": losses,
           "params": _flat(unshard_tree(plan, g21, state.params)),
           "bytes": carried, "predicted": plan.collective_bytes(
               *batches[0]["labels"].shape), "info": step.info}
    if g21.index == 0:
        one, _ = ck.restore(like)
        one_step = t_steps.make_train_step(cfg, tc)
        out["one_losses"] = []
        for b in batches:
            one, m = one_step(one, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
            out["one_losses"].append(float(m["loss"]))
        out["one_params"] = _flat(one.params)
    return out


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: leaves whose constant init (ones, zeros, a linspace) is perturbed, so
#: that a misplaced block shows (``test_torch_lm_train.PERTURB``)
PERTURB = ("scale", "norm", "dt_bias", "D_skip", "bq", "bk", "bv")


@pytest.fixture(scope="module")
def carried():
    """Every arch's weights (the port's init from a seed, the constant
    leaves perturbed) and token batches, as numpy: the ranks and the
    one-card step take them through ``lm_params_from_jax``, JAX as its
    params tree."""
    from repro_torch.data import TokenStream
    from repro_torch.interop import lm_params_to_numpy

    out = {}
    for i, arch in enumerate({**ARCHS, **MB_ARCHS}):
        cfg = (_cfg(arch) if arch in ARCHS
               else smoke_arch(arch).replace(**MB_ARCHS[arch]))
        rng = np.random.default_rng(100 + i)
        flat = lm_params_to_numpy(t_tf.init_params(
            cfg, torch.Generator().manual_seed(i), device="cpu"))
        for k, v in flat.items():
            if k.rsplit("/", 1)[-1] in PERTURB:
                flat[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(
                    np.float32)
        n = STEPS + (RESUME_STEPS if arch == "llama3.2-3b" else 0)
        ds = TokenStream(cfg.vocab_size, 32, 4, seed=2,
                         frontend=cfg.frontend, d_model=cfg.d_model,
                         frontend_tokens=cfg.frontend_tokens)
        out[arch] = {"flat": flat, "batches": [ds.next() for _ in range(n)]}
    return out


@pytest.fixture(scope="module", autouse=True)
def spawned(carried, tmp_path_factory):
    """The four ranks and the JAX subprocess, started before the module's
    first test so that they run while this process checks the specs."""
    tmp = str(tmp_path_factory.mktemp("mp_ranks"))
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(carried, f)
    ctx = mp.start_processes(_rank_main, args=(WORLD, tmp), nprocs=WORLD,
                             join=False, start_method="spawn")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_STEPS, tmp,
         json.dumps([ARCHS, STEPS, TC, MB_ARCHS, TC_MB])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    yield ctx, tmp, jax_proc
    for proc in ctx.processes:
        if proc.is_alive():
            proc.kill()
        proc.join()
    if jax_proc.poll() is None:
        jax_proc.kill()
    jax_proc.communicate()


#: JAX's one-device steps of every arch on the carried weights, in a
#: subprocess started with the module: argv[1] the spawn's directory,
#: argv[2] a JSON of ARCHS, STEPS and TC
JAX_STEPS = r"""
import json, os, pickle, sys
import jax, jax.numpy as jnp
import numpy as np
from repro.config import TrainConfig
from repro.configs import smoke_arch
from repro.launch.steps import make_train_step
from repro.optim import adamw_init
from repro.sampling.store import flatten_tree, unflatten_tree

tmp, (archs, steps, tc, mb_archs, tc_mb) = (sys.argv[1],
                                            json.loads(sys.argv[2]))
with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
    inputs = pickle.load(f)


def run(arch, over, tc):
    cfg = smoke_arch(arch).replace(**over)
    d = inputs[arch]
    state = adamw_init(jax.tree_util.tree_map(
        jnp.asarray, unflatten_tree(d["flat"])), TrainConfig(**tc))
    step = jax.jit(make_train_step(cfg, TrainConfig(**tc)))
    metrics = []
    for b in d["batches"][:steps]:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return {"jax": metrics, "jax_params": {
        k: np.asarray(v, np.float32)
        for k, v in flatten_tree(state.params).items()}}


out = {arch: run(arch, over, tc) for arch, over in archs.items()}
out["microbatch"] = {arch: run(arch, over, tc_mb)
                     for arch, over in mb_archs.items()}
with open(os.path.join(tmp, "jax.pkl"), "wb") as f:
    pickle.dump(out, f)
print("JAX_STEPS_OK")
"""


@pytest.fixture(scope="module")
def references(spawned, carried):
    """Per arch: the port's one-card steps on the carried weights, run
    here while the ranks run, and JAX's one-device steps from the
    module's JAX subprocess."""
    ctx, tmp, jax_proc = spawned
    out = {"microbatch": {}}
    for arch, over in MB_ARCHS.items():
        cfg = smoke_arch(arch).replace(**over)
        tc = TrainConfig(**TC_MB)
        state = adamw_init(lm_params_from_jax(carried[arch]["flat"], cfg), tc)
        step = t_steps.make_train_step(cfg, tc)
        pm = []
        for i, b in enumerate(carried[arch]["batches"][:STEPS]):
            state, m = step(state, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
            pm.append({k: float(v) for k, v in m.items()})
            if i == 0:
                mu1 = _flat(state.mu)
        out["microbatch"][arch] = {"port": pm,
                                   "port_params": _flat(state.params),
                                   "port_mu1": mu1}
    for arch in ARCHS:
        d = carried[arch]
        cfg = _cfg(arch)
        tc = TrainConfig(**TC)
        state = adamw_init(lm_params_from_jax(d["flat"], cfg), tc)
        step = t_steps.make_train_step(cfg, tc)
        pm = []
        for i, b in enumerate(d["batches"][:STEPS]):
            state, m = step(state, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
            pm.append({k: float(v) for k, v in m.items()})
            if i == 0:
                mu1 = _flat(state.mu)
        out[arch] = {"port": pm, "port_params": _flat(state.params),
                     "port_mu1": mu1}
    stdout, stderr = jax_proc.communicate(timeout=RANKS_DEADLINE)
    assert "JAX_STEPS_OK" in stdout, stderr[-3000:]
    with open(os.path.join(tmp, "jax.pkl"), "rb") as f:
        for arch, d in pickle.load(f).items():
            if arch == "microbatch":
                for a, dd in d.items():
                    out[arch][a].update(dd)
            else:
                out[arch].update(d)
    return out


@pytest.fixture(scope="module")
def ranks(spawned, references):
    """Every rank's results once the spawn finished; a rank that raises
    fails the tests and its peers are killed."""
    ctx, tmp, _ = spawned
    deadline = time.monotonic() + RANKS_DEADLINE
    while not ctx.join(timeout=1):
        assert time.monotonic() < deadline, "the ranks timed out"
    out = []
    for r in range(WORLD):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


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


def _jspec(spec) -> tuple:
    return tuple(spec)


# ---------------------------------------------------------------------------
# spec_for against JAX's
# ---------------------------------------------------------------------------

#: every case of tests/test_sharding_rules.py, with JAX's expected spec
SPEC_CASES = [
    (("embed", "ffn"), (8192, 29568), True, ("data", "model")),
    (("vocab", "embed"), (49155, 2048), True, (None, "model")),
    (("vocab", "embed"), (152064, 8192), True, ("model", "data")),
    (("embed", "kv_heads", "head_dim"), (8192, 8, 128), True,
     ("model", None, None)),
    (("embed", "heads", "head_dim"), (8192, 64, 128), True,
     ("data", "model", None)),
    (("batch", "seq", "heads", "head_dim"), (256, 4096, 24, 128), False,
     ("data", None, "model", None)),
    (("batch", "cache_seq", "kv_heads", "head_dim"), (1, 524288, 8, 128),
     False, (None, "model", None, None)),
    (("experts", "embed", "ffn"), (16, 6144, 10752), True,
     (None, "data", "model")),
    (("batch", "embed", "ffn"), (16, 8192, 29568), True,
     ("data", None, "model")),
]


@pytest.mark.parametrize("names,shape,is_param,want", SPEC_CASES)
def test_spec_for_matches_jax_on_its_cases(jax_rules, names, shape,
                                           is_param, want):
    from repro.distributed.sharding import spec_for as j_spec_for

    got = spec_for(names, shape, rules=_rules("16x16"), is_param=is_param)
    assert got == want
    assert got == _jspec(j_spec_for(names, shape, rules=jax_rules["16x16"],
                                    is_param=is_param))


def test_spec_for_matches_jax_on_draws(jax_rules):
    """Hypothesis draws (derandomized, so C12's draws are fixed) of names,
    dims, is_param and mesh: the port's spec is JAX's, and a spec that
    passes ``check_spec`` divides its dims (params exactly)."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    from repro.distributed.sharding import spec_for as j_spec_for

    @settings(max_examples=300, deadline=None, derandomize=True)
    @given(st.lists(st.sampled_from(["embed", "ffn", "heads", "vocab",
                                     "batch", None, "seq", "kv_heads",
                                     "d_inner", "experts", "blocks"]),
                    min_size=1, max_size=4),
           st.lists(st.integers(1, 4096), min_size=4, max_size=4),
           st.booleans(), st.sampled_from(sorted(MESHES)))
    def check(names, dims, is_param, mesh):
        names = tuple(names)
        shape = tuple(dims[:len(names)])
        rules = _rules(mesh)
        got = spec_for(names, shape, rules=rules, is_param=is_param)
        assert got == _jspec(j_spec_for(names, shape,
                                        rules=jax_rules[mesh],
                                        is_param=is_param))
        try:
            check_spec(got, rules.mesh)
        except ValueError:
            return
        if is_param:
            t_sharding.block_shape(shape, got, rules.mesh)

    check()


@pytest.mark.parametrize("arch", list_archs())
def test_params_axes_match_jax(arch):
    from repro.configs import get_arch as j_get_arch
    from repro.models import transformer as j_tf

    assert t_tf.params_axes(get_arch(arch)) == j_tf.params_axes(
        j_get_arch(arch))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_match_jax_on_every_leaf(jax_rules, arch, mesh):
    """Every leaf of every arch's params at (2, 2), (16, 16) and (2, 16,
    16): the port's ``param_specs`` against JAX's ``spec_for`` over
    ``tf.params_axes`` (the shapes from JAX's abstract params)."""
    import jax

    from repro.configs import get_arch as j_get_arch
    from repro.distributed.sharding import spec_for as j_spec_for
    from repro.launch.steps import abstract_params as j_abstract
    from repro.models import transformer as j_tf

    jcfg = j_get_arch(arch)
    jshapes = _jax_shapes(arch)
    jaxes = _flat_axes(j_tf.params_axes(jcfg))
    cfg = get_arch(arch)
    got = _flat_axes(t_steps.param_specs(
        cfg, t_steps.abstract_params(cfg), _rules(mesh)))
    assert set(got) == set(jaxes) == set(jshapes)
    for key, names in jaxes.items():
        want = j_spec_for(names, jshapes[key], rules=jax_rules[mesh],
                          is_param=True)
        assert got[key] == _jspec(want), (key, got[key], want)
        check_spec(got[key], _rules(mesh).mesh)


@functools.lru_cache(maxsize=None)
def _jax_shapes(arch) -> dict:
    """Every leaf's shape in JAX's abstract params of ``arch``."""
    import jax

    from repro.configs import get_arch as j_get_arch
    from repro.launch.steps import abstract_params as j_abstract

    return {"/".join(p.key for p in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                j_abstract(j_get_arch(arch)))}


def _flat_axes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_axes(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def test_c12_spec_is_jax_and_placement_refuses_it(jax_rules):
    """ROADMAP C12: names ('embed', 'embed', 'batch', 'batch') at dims (1,
    1, 16, 16) on the 16-wide data axis.  ``spec_for`` gives JAX's spec,
    which uses 'data' twice; ``check_spec`` and every placement refuse it,
    naming the axis."""
    from repro.distributed.sharding import spec_for as j_spec_for

    names, shape = ("embed", "embed", "batch", "batch"), (1, 1, 16, 16)
    rules = _rules("16x16")
    got = spec_for(names, shape, rules=rules, is_param=True)
    assert got == (None, None, "data", "data")
    assert got == _jspec(j_spec_for(names, shape, rules=jax_rules["16x16"],
                                    is_param=True))
    with pytest.raises(ValueError, match="'data' twice"):
        check_spec(got)
    with pytest.raises(ValueError, match="'data' twice"):
        shard_leaf(torch.zeros(shape), got, rules.mesh, (0, 0))
    with pytest.raises(ValueError, match="'data' twice"):
        unshard([torch.zeros((1, 1, 1, 1))] * 256, got, rules.mesh)


# ---------------------------------------------------------------------------
# blocks against JAX's devices_indices_map
# ---------------------------------------------------------------------------

#: (mesh shape, leaf shape, spec) placed by both packages
BLOCK_CASES = [
    ((2, 2), (8, 6), ("data", "model")),
    ((2, 2), (8, 6), ("model", "data")),
    ((2, 2), (4, 6, 8), (None, "model", None)),
    ((2, 2), (4, 6, 8), ("data", None, None)),
    ((2, 2), (8, 6), (("data", "model"), None)),
    ((2, 2), (8, 6), (("model", "data"), None)),
    ((2, 2), (6,), ("model",)),
    ((2, 2), (3, 5), (None, None)),
    ((1, 4), (8, 6), ("model", None)),
    ((1, 4), (8, 4), ("data", "model")),
    ((1, 4), (4, 8, 2), (None, ("data", "model"), None)),
]

JAX_BLOCKS = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

cases = json.loads(sys.argv[1])
out = []
for shape, leaf, spec in cases:
    devs = np.array(jax.devices()[:4]).reshape(shape)
    mesh = Mesh(devs, ("data", "model"))
    spec = [tuple(s) if isinstance(s, list) else s for s in spec]
    idx = NamedSharding(mesh, P(*spec)).devices_indices_map(tuple(leaf))
    pos = {d.id: [int(i) for i in np.argwhere(devs == d)[0]]
           for d in devs.flat}
    out.append([[pos[d.id], [[s.start or 0, leaf[k] if s.stop is None
                               else s.stop] for k, s in enumerate(sl)]]
                for d, sl in idx.items()])
print("BLOCKS " + json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def _jax_blocks_proc():
    """JAX's blocks, computed by a subprocess with four host devices that
    starts with the module."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_BLOCKS, json.dumps(
            [[list(m), list(s), [list(e) if isinstance(e, tuple) else e
                                 for e in spec]]
             for m, s, spec in BLOCK_CASES])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    yield proc
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def jax_blocks(_jax_blocks_proc):
    out, err = _jax_blocks_proc.communicate(timeout=300)
    line = [ln for ln in out.splitlines() if ln.startswith("BLOCKS ")]
    assert line, err[-2000:]
    return json.loads(line[0][len("BLOCKS "):])


@pytest.mark.parametrize("case", range(len(BLOCK_CASES)))
def test_shard_leaf_blocks_match_jax(jax_blocks, case):
    """Each rank's block is the slice JAX's ``NamedSharding`` gives the
    device at its mesh position, and ``unshard`` inverts ``shard_leaf``."""
    shape, leaf, spec = BLOCK_CASES[case]
    m = mesh_mod.rank_mesh(shape)
    want = {tuple(pos): [tuple(b) for b in bounds]
            for pos, bounds in jax_blocks[case]}
    x = torch.arange(math.prod(leaf), dtype=torch.float32).reshape(leaf)
    blocks = []
    for i in range(m.size):
        c = mesh_coords(m, i)
        got = [(s.start, s.stop) for s in region(leaf, spec, m, c)]
        assert got == want[c], (c, got, want[c])
        blocks.append(shard_leaf(x, spec, m, c))
    assert torch.equal(unshard(blocks, spec, m), x)


# ---------------------------------------------------------------------------
# meshes and the launcher's refusals
# ---------------------------------------------------------------------------

class _Ranks:
    def __init__(self, size):
        self.size = size


def test_rank_meshes_take_jax_shapes_and_refuse_other_groups():
    """The production meshes are JAX's over exactly 256 / 512 ranks; the
    debug mesh lays (data, model) over a group's first ranks; a mesh wider
    than its group, or a production mesh over another count, raises
    naming the ranks it needs; ``make_rules`` is JAX's."""
    pod = mesh_mod.make_production_mesh(group=_Ranks(256))
    assert pod.shape == (16, 16) and pod.axes == ("data", "model")
    assert pod.ranks == tuple(range(256)) and pod.devices == ()
    multi = mesh_mod.make_production_mesh(multi_pod=True, group=_Ranks(512))
    assert multi.shape == (2, 16, 16) and multi.axes[0] == "pod"
    for n in (4, 255, 257):
        with pytest.raises(ValueError, match="256 ranks"):
            mesh_mod.make_production_mesh(group=_Ranks(n))
    with pytest.raises(ValueError, match="512 ranks"):
        mesh_mod.make_production_mesh(multi_pod=True, group=_Ranks(256))
    with pytest.raises(ValueError, match="512 ranks"):
        mesh_mod.make_production_mesh(multi_pod=True)
    assert mesh_mod.make_production_mesh().shape == (1, 1)
    dbg = mesh_mod.make_debug_mesh(2, 2, group=_Ranks(6))
    assert dbg.ranks == (0, 1, 2, 3) and dbg.shape == (2, 2)
    with pytest.raises(ValueError, match="8 ranks"):
        mesh_mod.make_debug_mesh(4, 2, group=_Ranks(4))
    assert mesh_mod.make_rules(multi, multi_pod=True).batch_axes == (
        "pod", "data")
    assert mesh_mod.make_rules(multi, multi_pod=True).fsdp_size == 32
    assert mesh_mod.make_rules(pod).batch_axes == ("data",)


def test_pod_mesh_without_a_group_raises_naming_256():
    for flag, n in (("pod", "256"), ("multipod", "512")):
        with pytest.raises(ValueError, match=f"group of {n} ranks"):
            train_mod.main(["--arch", "llama3.2-3b", "--smoke", "--device",
                            "cpu", "--mesh", flag])


def test_llama_full_width_state_a_rank():
    """llama3.2-3b at its widths, two layers, on a (2, 2) mesh: a rank
    holds 148,836,864 of 595,344,384 parameters; attention and the dense
    FFN split over the model axis (the local heads, 12, are a multiple of
    G = 3); the step's collective bytes a rank at JAX's CLI batch."""
    cfg = get_arch("llama3.2-3b").replace(num_layers=2)
    plan = ShardPlan(cfg, mesh_mod.make_rules(mesh_mod.rank_mesh((2, 2))))
    assert plan.block_numel() == 148_836_864
    assert sum(math.prod(lf.shape) for lf in plan.leaves) == 595_344_384
    assert plan.split_attention and plan.split_mlp
    assert plan.collective_bytes(8, 256)["total"] > 0


@pytest.mark.parametrize("arch,want", [("jamba-v0.1-52b", 204_913_568),
                                       ("grok-1-314b", 1_236_286_848)])
def test_dry_run_pod_records(arch, want):
    """The dry run's (16, 16) record: JAX's per-device parameter count,
    the params and bf16 moments' bytes, nonzero collective bytes and
    their NVLink term; the (2, 16, 16) record holds half the params or a
    little more (leaves that 32 does not divide stay whole over the pod
    and data axes); a prefill cell on a mesh holds the compute params and
    no optimizer."""
    rec = dryrun.lower_cell(arch, "train_4k", pod=True)
    assert rec["status"] == "ok" and rec["num_devices"] == 256
    mem = rec["memory"]
    assert mem["params_per_device"] == want
    assert mem["params_bytes_per_device"] == 4 * want
    assert mem["optimizer_bytes_per_device"] == 2 * 2 * want
    coll = rec["collectives"]["per_device_bytes"]
    assert coll > 0 and coll == sum(rec["collectives"][
        "by_kind_bytes"].values())
    assert rec["roofline"]["collective_s"] == pytest.approx(coll / 450e9)
    assert rec["roofline"]["compute_s"] is None
    multi = dryrun.lower_cell(arch, "train_4k", multi_pod=True)
    assert multi["num_devices"] == 512 and multi["multi_pod"] is True
    assert want / 2 <= multi["memory"]["params_per_device"] < want
    pre = dryrun.lower_cell(arch, "prefill_32k", pod=True)
    assert pre["status"] == "ok"
    assert pre["memory"]["params_per_device"] == want
    assert pre["memory"]["optimizer_bytes_per_device"] == 0
    assert want * 2 <= pre["memory"]["params_bytes_per_device"] < want * 4


def test_train_state_shardings_follow_the_param_specs():
    cfg = _cfg("llama3.2-3b")
    tc = TrainConfig(grad_compress=True)
    rules = _rules("2x2")
    sh = t_steps.train_state_shardings(
        cfg, tc, t_steps.train_state_specs(cfg, tc), rules)
    ps = t_steps.param_specs(cfg, t_steps.abstract_params(cfg), rules)
    assert sh.step == () and sh.params == sh.mu == sh.nu == ps
    assert sh.compress_err == ps


# ---------------------------------------------------------------------------
# the (2, 2) step in the ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(ARCHS))
def test_sharded_step_matches_the_one_card_step(ranks, references, arch):
    """Losses and grad norms 1e-5 relative (jamba's grad norm at step 0
    only); the clipped gradient (the first step's mu) GRAD_TOL and the
    parameters after three steps 1e-5 of each leaf's norm (jamba's
    JAMBA_PARAM_TOL); every rank reports the same metrics and
    parameters."""
    ref = references[arch]
    rec = ranks[0][arch]
    for o in ranks[1:]:
        assert o[arch]["metrics"] == rec["metrics"]
    for i, (got, want) in enumerate(zip(rec["metrics"], ref["port"])):
        assert set(got) == set(want)
        keys = ("loss", "ce", "aux", "grad_norm")
        if arch == "jamba-v0.1-52b" and i:
            keys = ("loss", "ce")       # the later norms: see JAMBA_PARAM_TOL
        for k in keys:
            assert _rel(got[k], want[k]) <= TOL or abs(got[k]) < 1e-12, k
        assert got["lr"] == want["lr"]
    gaps = _norm_gap(rec["mu1"], ref["port_mu1"])
    assert max(gaps.values()) <= GRAD_TOL, gaps
    tol = {"jamba-v0.1-52b": JAMBA_PARAM_TOL,
           "granite-3-2b": GRANITE_PARAM_TOL}.get(arch, TOL)
    gaps = _norm_gap(rec["params"], ref["port_params"])
    assert max(gaps.values()) <= tol, gaps
    for o in ranks[1:]:
        for k, v in o[arch]["params"].items():
            assert np.array_equal(v, rec["params"][k]), k


@pytest.mark.parametrize("arch", list(ARCHS))
def test_sharded_step_matches_jax(ranks, references, arch):
    ref = references[arch]
    rec = ranks[0][arch]
    for got, want in zip(rec["metrics"], ref["jax"]):
        assert _rel(got["loss"], want["loss"]) <= TOL
        assert got["lr"] == pytest.approx(want["lr"], rel=1e-6)
    tol = JAMBA_PARAM_TOL if arch == "jamba-v0.1-52b" else JAX_PARAM_TOL
    gaps = _norm_gap(rec["params"], ref["jax_params"])
    assert max(gaps.values()) <= tol, gaps


@pytest.mark.parametrize("arch", list(ARCHS))
def test_replicated_gradients_are_bit_equal_across_model_ranks(ranks, arch):
    """The gradient of every leaf computed whole, before its data sum, is
    the same bits on both model ranks of a data row."""
    by_coords = {tuple(o["coords"]): o[arch]["probe"] for o in ranks}
    for d in range(2):
        a, b = by_coords[(d, 0)], by_coords[(d, 1)]
        assert a and set(a) == set(b)
        for key in a:
            assert np.array_equal(a[key], b[key]), key


@pytest.mark.parametrize("arch", list(ARCHS))
def test_state_bytes_are_the_specs_count(ranks, arch):
    """A rank holds its blocks of params, mu and nu (float32) and nothing
    else: 12 bytes an element of ``plan.block_numel()``, less than the
    whole."""
    for o in ranks:
        rec = o[arch]
        assert rec["state_bytes"] == 12 * rec["block_numel"]
    whole = sum(v.size for v in ranks[0][arch]["params"].values())
    assert ranks[0][arch]["block_numel"] < whole


@pytest.mark.parametrize("arch", list(ARCHS))
def test_collective_bytes_equal_group_bytes(ranks, arch):
    for o in ranks:
        rec = o[arch]
        assert rec["bytes"] == [rec["predicted"]["total"]] * STEPS


def test_split_leaves_in_the_step_info(ranks):
    from repro_torch.distributed.model_parallel import SSM_SPLIT

    llama = ranks[0]["llama3.2-3b"]["info"]
    assert llama["mesh"] == (2, 2)
    assert set(llama["split"]) == {"embed/tokens"} | {
        f"blocks/pos0/{p}" for p in ("mixer/wq", "mixer/wk", "mixer/wv",
                                     "mixer/wo", "ffn/w1", "ffn/w3",
                                     "ffn/w2")}
    ssm = {f"blocks/pos0/mixer/{n}" for n in SSM_SPLIT}
    mamba = ranks[0]["mamba2-780m"]["info"]
    assert set(mamba["split"]) == {"embed/tokens"} | ssm
    assert all(mamba["modes"][f"blocks/pos0/mixer/{n}"] == "whole"
               for n in ("in_B", "in_C", "conv_B", "conv_C"))
    jamba = ranks[0]["jamba-v0.1-52b"]["info"]
    split = set(jamba["split"])
    assert {"blocks/pos4/mixer/wq", "embed/tokens", "embed/lm_head"} <= split
    assert {f"blocks/pos1/ffn/{w}" for w in ("w1", "w3", "w2")} <= split
    assert {f"blocks/pos{i}/mixer/{n}" for i in (0, 1) for n in SSM_SPLIT
            } <= split
    assert jamba["modes"]["blocks/pos1/ffn/router"] == "whole"
    granite = ranks[0]["granite-3-2b"]["info"]["modes"]
    assert granite["embed/tokens"] == "take"


def test_checkpoint_restores_across_mesh_shapes(ranks):
    """The (2, 2) state saved whole at step 3 and restored on the (2, 1)
    mesh of ranks 0 and 1 continues as the one-card run resumed from the
    same checkpoint: losses 1e-5 relative, parameters 1e-5 of each leaf's
    norm, the two ranks equal."""
    a, b = ranks[0]["elastic"], ranks[1]["elastic"]
    assert ranks[2]["elastic"] is None and ranks[3]["elastic"] is None
    assert a["at"] == STEPS and a["step"] == STEPS + RESUME_STEPS
    assert a["losses"] == b["losses"]
    for got, want in zip(a["losses"], a["one_losses"]):
        assert _rel(got, want) <= TOL
    gaps = _norm_gap(a["params"], a["one_params"])
    assert max(gaps.values()) <= TOL, gaps


def test_other_mesh_shapes_carry_their_counted_bytes(ranks, references):
    """The (1, 4) mesh (attention whole on every model rank: one head a
    rank is no multiple of G; the vocabulary and the FFN split four ways)
    matches the one-card
    step's losses at 1e-5; it and the (2, 1) mesh of the elastic restore
    (no model split) carry the bytes ``collective_bytes`` counts."""
    for o in ranks:
        rec = o["mesh_1x4"]
        assert rec["info"]["split"] == ["embed/tokens"] + [
            f"blocks/pos0/ffn/{w}" for w in ("w1", "w3", "w2")]
        assert rec["bytes"] == [rec["predicted"]["total"]] * 2
        assert rec["predicted"]["tensor_parallel"] > 0
        for got, want in zip(rec["metrics"],
                             references["llama3.2-3b"]["port"]):
            assert _rel(got["loss"], want["loss"]) <= TOL
            assert _rel(got["grad_norm"], want["grad_norm"]) <= TOL
    for o in ranks[:2]:
        rec = o["elastic"]
        assert rec["info"]["split"] == []
        assert rec["bytes"] == [rec["predicted"]["total"]] * RESUME_STEPS
        assert rec["predicted"]["tensor_parallel"] == 0


def test_pod_mesh_in_a_four_rank_group_raises_naming_256(ranks):
    for o in ranks:
        assert "256 ranks" in o["pod_error"], o.get("pod_error")


# ---------------------------------------------------------------------------
# remat and gradient accumulation on (2, 2)
# ---------------------------------------------------------------------------


def test_remat_on_and_off_are_bit_equal_on_the_mesh(ranks):
    """llama3.2-3b's three (2, 2) steps under JAX's default remat (every
    arch run above) and with ``remat=False``: every metric and parameter
    the same bits on every rank; each carries its counted bytes, and the
    recompute's gathers and forward sums are what remat adds."""
    for o in ranks:
        on, off = o["llama3.2-3b"], o["remat_off"]
        assert off["metrics"] == on["metrics"]
        for k, v in off["params"].items():
            assert np.array_equal(v, on["params"][k]), k
        assert off["bytes"] == [off["predicted"]["total"]] * STEPS
        assert on["bytes"] == [on["predicted"]["total"]] * STEPS
        p_on, p_off = on["predicted"], off["predicted"]
        assert p_on["grad_sum"] == p_off["grad_sum"]
        assert p_on["gather"] > p_off["gather"]
        assert p_on["tensor_parallel"] > p_off["tensor_parallel"]


def test_remat_dots_is_bit_equal_on_the_mesh(ranks):
    """llama3.2-3b's three (2, 2) steps under ``remat_policy="dots"``
    (each block's gathers, copies and sums inside the selective
    checkpoint, run again in the recompute): every metric and parameter
    the same bits as under full remat on every rank, and each step
    carries the bytes ``collective_bytes`` counts, full remat's."""
    for o in ranks:
        on, dots = o["llama3.2-3b"], o["remat_dots"]
        assert dots["metrics"] == on["metrics"]
        for k, v in dots["params"].items():
            assert np.array_equal(v, on["params"][k]), k
        assert dots["predicted"] == on["predicted"]
        assert dots["bytes"] == [dots["predicted"]["total"]] * STEPS


@pytest.mark.parametrize("arch", list(MB_ARCHS))
def test_microbatch_on_the_mesh_matches_one_card_and_jax(ranks, references,
                                                         arch):
    """``microbatch=2`` on (2, 2), three steps: the losses (JAX's
    ``{"loss"}``) and grad norms 1e-5 relative to the port's one-card
    micro-batched step, the first step's clipped gradient GRAD_TOL and
    the parameters MB_PARAM_TOL of each leaf's norm; the losses at TOL
    and the parameters JAX_PARAM_TOL against JAX's one-device
    micro-batched step; every rank the same; ``Group.bytes`` the counted
    bytes of two micro-batches."""
    ref = references["microbatch"][arch]
    rec = ranks[0]["microbatch"][arch]
    for o in ranks[1:]:
        assert o["microbatch"][arch]["metrics"] == rec["metrics"]
    for got, want, jax_m in zip(rec["metrics"], ref["port"], ref["jax"]):
        assert set(got) == set(want) == set(jax_m)
        for k in ("loss", "grad_norm"):
            assert _rel(got[k], want[k]) <= TOL, k
        assert got["lr"] == want["lr"]
        assert _rel(got["loss"], jax_m["loss"]) <= TOL
    gaps = _norm_gap(rec["mu1"], ref["port_mu1"])
    assert max(gaps.values()) <= GRAD_TOL, gaps
    gaps = _norm_gap(rec["params"], ref["port_params"])
    assert max(gaps.values()) <= MB_PARAM_TOL[arch], gaps
    gaps = _norm_gap(rec["params"], ref["jax_params"])
    assert max(gaps.values()) <= JAX_PARAM_TOL, gaps
    for o in ranks:
        r = o["microbatch"][arch]
        assert r["bytes"] == [r["predicted"]["total"]] * STEPS
        assert r["predicted"]["gather"] == 2 * r["unsplit"]["gather"]


def test_microbatch_rows_are_jax_micro_batches():
    """``local_batch(microbatch=n)``: data rank r takes rows i B / n + r B
    / (n d) + [0, B / (n d)) of each micro-batch i, micro-batch-major, so
    its micro-batch i is its rows [i B / (n d), (i + 1) B / (n d)); a
    batch that n d does not divide is refused, naming B, n and d."""
    plan = ShardPlan(_cfg("llama3.2-3b"), _rules("2x2"))
    x = torch.arange(8)[:, None]
    got = [plan.local_batch({"tokens": x}, r, microbatch=2)["tokens"][:, 0]
           for r in range(4)]
    assert [g.tolist() for g in got] == [[0, 1, 4, 5], [0, 1, 4, 5],
                                        [2, 3, 6, 7], [2, 3, 6, 7]]
    assert plan.local_batch({"tokens": x}, 2, microbatch=1)[
        "tokens"][:, 0].tolist() == [4, 5, 6, 7]
    with pytest.raises(ValueError, match="batch 6 does not split into 2 "
                                         "micro-batches over 2 data ranks"):
        plan.local_batch({"tokens": x[:6]}, 0, microbatch=2)


def test_train_cli_microbatch_on_the_mesh(ranks, capsys):
    """``launch.train.main(--microbatch 2, mesh=)`` on (2, 2): each rank
    reads its rows of each micro-batch, the losses are the one-card
    launcher's at 1e-5 and equal on every rank, and a step carries the
    bytes the plan counts for two micro-batches."""
    one = {}
    assert train_mod.main(CLI_MB, out=one) == 0
    want = [float(r["loss"]) for r in one["steps"]]
    got = ranks[0]["cli_microbatch"]
    assert len(got["losses"]) == len(want) == 2
    for g, w in zip(got["losses"], want):
        assert _rel(g, w) <= TOL
    for o in ranks:
        rec = o["cli_microbatch"]
        assert rec["losses"] == got["losses"]
        assert rec["bytes"] == rec["counted"]
