"""The port's data-parallel fit over several ranks and its sweep dispatch
placed across devices, on the CPU, against JAX's ``tests/test_scaleout.py``
and ``tests/test_fault.py`` (the multi-width shrink), the port's one-rank
fit and JAX's one-device fit.

Each width (2 and 4) runs its ranks once: a module fixture spawns them
with ``torch.multiprocessing`` on a gloo group joined through a file
store, every rank-side check runs in that one spawn (one intra-op thread
a rank), and the results come back through files.  Sizes are JAX's
(``_graphs()``: 8 graphs; 8 steps of 4 graphs, fault boundaries every 4).
The fits at a width are held to the one-rank fit within JAX's 5e-5
(same math, partial gradients summed in another order), and, on JAX's
initial parameters and per-step draws (recorded from the one-rank fit
under ``test_torch_fit_parity.on_jax_draws`` and replayed in the ranks),
to JAX's one-device fit at ``test_torch_fit_parity``'s tolerances.  The
collectives are held to JAX's ``psum_mean`` / ``compressed_psum_mean``
under ``jax.vmap(..., axis_name="data")``.  The placed sweep runs in this
process over a placement that repeats the CPU.  Nothing here imports JAX
at module level: the spawned ranks import this module.
"""

import dataclasses
import os
import pickle
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.core import rgcn as rgcn_mod
from repro_torch.core import train as train_mod
from repro_torch.core.batching import (
    MAX_EDGES_PER_MICROBATCH, MAX_NODES_PER_MICROBATCH, pack_graphs,
)
from repro_torch.core.rgcn import RGCNConfig
from repro_torch.core.train import (
    ContrastiveTrainer, FitInterrupted, GCLTrainConfig, fit_resilient,
)
from repro_torch.distributed import DeviceLost
from repro_torch.distributed.group import Group, init_group
from repro_torch.distributed.sharding import shard_batch, shard_ranges
from repro_torch.optim.grad_compress import (
    compressed_psum_mean, psum_mean,
)
from repro_torch.sampling.engine import PlanEngine

WIDTHS = (2, 4)
#: W ranks against one rank: test_scaleout.py's tolerance
TOL = 5e-5
TC = GCLTrainConfig(steps=8, batch_size=4, scan_chunk=4, log_every=50)
CAPS = dict(max_nodes_per_graph=MAX_NODES_PER_MICROBATCH,
            max_edges_per_graph=MAX_EDGES_PER_MICROBATCH)
#: the collectives' inputs: (W, ...) rows, rank r holds row r
PSUM_SHAPES = {"w": (16, 4), "b": (7,)}


def _graphs(n=8, cap=48, jax=False):
    """JAX's ``tests/test_scaleout.py`` graphs, from either package."""
    if jax:
        from repro.core.graphs import build_kernel_graph
        from repro.tracing.templates import make_kernel
    else:
        from repro_torch.core.graphs import build_kernel_graph
        from repro_torch.tracing.templates import make_kernel
    ks = [make_kernel(f"k{i}", "gemm",
                      {"M": 128 * (i % 3 + 1), "N": 128, "K": 128}, i, seed=i)
          for i in range(n)]
    return [build_kernel_graph(k.trace(cap_warps=2, cap_instr=cap))
            for k in ks]


def _params(enc) -> dict:
    return {k: v.detach().cpu().numpy().copy()
            for k, v in enc.state_dict().items()}


def _losses(info) -> np.ndarray:
    return np.array([h["loss"] for h in info["history"]])


def _psum_inputs(world: int):
    rng = np.random.default_rng(world)
    grads = {k: rng.normal(size=(world,) + s).astype(np.float32)
             for k, s in PSUM_SHAPES.items()}
    err = {k: (0.01 * rng.normal(size=(world,) + s)).astype(np.float32)
           for k, s in PSUM_SHAPES.items()}
    return grads, err


def _eval_all(enc, group):
    """The InfoNCE in eval mode over all 8 graphs in one batch."""
    tr = ContrastiveTrainer(RGCNConfig(), TC, device="cpu", group=group)
    packed, _ = pack_graphs(_graphs(), **CAPS)
    return tr.eval_loss(enc, packed if group else tr._upload(packed))[0]


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _replaying(recorded: dict):
    """Patch the fit to start from JAX's parameters and take JAX's step
    draws, as recorded; returns the undo."""
    init, draw = rgcn_mod.init_rgcn, train_mod.draw_step
    steps = iter(recorded["draws"])

    def jax_init(_seed, rc):
        enc = rgcn_mod.RGCNEncoder(rc)
        enc.load_state_dict(recorded["init"])
        return enc

    def replay(gen, batch, rc, *, train=True):
        if not train:
            return draw(gen, batch, rc, train=False)
        return tuple(d.to(gen.device) for d in next(steps))

    rgcn_mod.init_rgcn, train_mod.draw_step = jax_init, replay

    def undo():
        rgcn_mod.init_rgcn, train_mod.draw_step = init, draw
    return undo


def _rank_main(rank: int, world: int, tmp: str, recorded_path: str):
    torch.set_num_threads(1)
    group = init_group("gloo", rank, world, os.path.join(tmp, "store"))
    gs = _graphs()
    out = {}

    def fit(tc=TC, g=group, **kw):
        return ContrastiveTrainer(RGCNConfig(), tc, device="cpu",
                                  group=g).fit(gs, **kw)

    b0 = group.bytes
    enc, info = fit()
    out["fit"] = dict(params=_params(enc), losses=_losses(info),
                      val_loss=info["val_loss"],
                      data_shards=info["data_shards"],
                      collective_bytes=info["collective_bytes"],
                      fit_bytes=group.bytes - b0)
    out["eval_all"] = _eval_all(enc, group)

    again, _ = fit()
    out["refit"] = _params(again)
    inline, i_inline = fit(dataclasses.replace(TC, prefetch=False))
    out["inline"] = dict(params=_params(inline), losses=_losses(i_inline),
                         prefetch=(info["prefetch"], i_inline["prefetch"]))

    tc_ck = dataclasses.replace(TC, checkpoint_every=4)
    ck = os.path.join(tmp, "ck")
    try:
        fit(tc_ck, checkpoint_dir=ck, interrupt_after=4)
        out["interrupted"] = False
    except FitInterrupted:
        out["interrupted"] = True
    res, i_res = fit(tc_ck, checkpoint_dir=ck)
    out["resume"] = dict(params=_params(res), losses=_losses(i_res),
                         resumed_from=i_res["resumed_from"])

    undo = _replaying(torch.load(recorded_path, weights_only=False))
    try:
        j_enc, j_info = fit()
    finally:
        undo()
    out["jax_draws"] = dict(params=_params(j_enc), losses=_losses(j_info))

    grads, err = _psum_inputs(world)
    mine = lambda tree: {k: torch.from_numpy(v[rank].copy())  # noqa: E731
                         for k, v in tree.items()}
    out["psum_mean"] = {k: v.numpy() for k, v in
                        psum_mean(mine(grads), group).items()}
    mean, new_err = compressed_psum_mean(mine(grads), mine(err), group)
    out["compressed"] = ({k: v.numpy() for k, v in mean.items()},
                         {k: v.numpy() for k, v in new_err.items()})

    calls = []

    def hook(done):
        """The last rank of the width loses a participant at the width's
        first boundary, until the width is 1."""
        calls.append(done)
        width = world >> (len(calls) - 1)
        if width > 1 and rank == width - 1:
            raise DeviceLost("injected participant loss")

    r_enc, r_info = fit_resilient(
        RGCNConfig(), TC, gs, checkpoint_dir=os.path.join(tmp, "ck_res"),
        fault_hook=hook, device="cpu", group=group)
    out["resilient"] = dict(
        params=None if r_enc is None else _params(r_enc),
        degradations=r_info["degradations"],
        data_shards=r_info["data_shards"],
        steps=len(r_info.get("history", ())))

    one = group.subgroup(1)
    if one is not None:
        a, _ = fit(g=one)
        b, _ = fit(g=None)
        out["one_rank_group"] = (_params(a), _params(b))
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """The one-rank fit (port draws), and the one-rank fit on JAX's
    initial parameters and draws, recorded to a file for the ranks."""
    from repro_torch.interop import params_to_numpy
    from test_torch_fit_parity import on_jax_draws

    gs = _graphs()
    enc, info = ContrastiveTrainer(RGCNConfig(), TC, device="cpu").fit(gs)
    rec = {"draws": []}
    with on_jax_draws():
        rec["init"] = rgcn_mod.init_rgcn(0, RGCNConfig()).state_dict()
        inner = train_mod.draw_step

        def record(gen, batch, rc, *, train=True):
            d = inner(gen, batch, rc, train=train)
            if train:
                rec["draws"].append(d)
            return d

        train_mod.draw_step = record
        try:
            j_enc, j_info = ContrastiveTrainer(RGCNConfig(), TC,
                                               device="cpu").fit(gs)
        finally:
            train_mod.draw_step = inner
    path = str(tmp_path_factory.mktemp("recorded") / "draws.pt")
    torch.save(rec, path)
    return dict(params=_params(enc), losses=_losses(info),
                val_loss=info["val_loss"], eval_all=_eval_all(enc, None),
                path=path, jax_draws=params_to_numpy(j_enc),
                jax_draws_losses=_losses(j_info))


@pytest.fixture(scope="module")
def spawned(recorded, tmp_path_factory):
    """Both widths' ranks, started at once and running while JAX's fit
    compiles (``one_rank``); {width: (process context, directory)}."""
    started = {}
    for world in WIDTHS:
        tmp = str(tmp_path_factory.mktemp(f"ranks{world}"))
        started[world] = (mp.start_processes(
            _rank_main, args=(world, tmp, recorded["path"]), nprocs=world,
            join=False, start_method="spawn"), tmp)
    yield started
    for ctx, _ in started.values():
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()


@pytest.fixture(scope="module")
def one_rank(spawned, recorded):
    """``recorded``'s fits and JAX's one-device fit."""
    from repro.core.rgcn import RGCNConfig as JRGCNConfig
    from repro.core.train import ContrastiveTrainer as JTrainer
    from repro.core.train import GCLTrainConfig as JGCLTrainConfig
    from repro.sampling.store import flatten_tree

    jparams, jinfo = JTrainer(JRGCNConfig(), JGCLTrainConfig(
        steps=TC.steps, batch_size=TC.batch_size, scan_chunk=TC.scan_chunk,
        log_every=TC.log_every)).fit(_graphs(jax=True))
    return dict(recorded, jax=flatten_tree(jparams),
                jax_losses=_losses(jinfo))


#: seconds a width's ranks may take before the test kills them
RANKS_DEADLINE = 400


@pytest.fixture(scope="module", params=WIDTHS, ids=lambda w: f"w{w}")
def ranks(request, spawned, one_rank):
    """(width, every rank's results) once that width's ranks finished; a
    rank that raises fails the test and its peers are killed."""
    world = request.param
    ctx, tmp = spawned[world]
    deadline = time.monotonic() + RANKS_DEADLINE
    while not ctx.join(timeout=1):
        assert time.monotonic() < deadline, f"width {world} timed out"
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return world, out


def _close(got: dict, want: dict, tol=TOL):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=tol,
                                   err_msg=k)


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                        for k in a)


# ---------------------------------------------------------------------------
# sharding a packed batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [1, 2, 3, 4, 5])
def test_shard_batch_is_the_pack_of_its_graphs(world):
    """A rank's share is exactly what ``pack_graphs`` makes of its range
    of whole graphs (ceil(G / W) each, the last ranks fewer or none); one
    rank gets the batch as it is."""
    gs = _graphs()[:4] + _graphs(n=2, cap=200)
    packed, _ = pack_graphs(gs, **CAPS)
    per = -(-len(gs) // world)
    for rank in range(world):
        r = shard_ranges(packed, rank, world)
        lo, hi = min(rank * per, len(gs)), min((rank + 1) * per, len(gs))
        assert r.graphs == (lo, hi)
        got = shard_batch(packed, rank, world)
        if lo == hi:
            assert r.n_graphs == 0
            continue
        want, _ = pack_graphs(gs[lo:hi], **CAPS)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# the fit at a width
# ---------------------------------------------------------------------------

def test_width_fit_matches_one_rank_fit(ranks, one_rank):
    """test_scaleout.py's sharded-vs-single parity: losses, parameters
    and val_loss within 5e-5 of the one-rank fit (and the eval loss of
    all 8 graphs in one batch); every rank ends with the same bits."""
    world, out = ranks
    fit = out[0]["fit"]
    assert fit["data_shards"] == world
    np.testing.assert_allclose(fit["losses"], one_rank["losses"],
                               atol=TOL, rtol=TOL)
    _close(fit["params"], one_rank["params"])
    assert np.isclose(fit["val_loss"], one_rank["val_loss"], atol=TOL)
    assert np.isclose(out[0]["eval_all"], one_rank["eval_all"], atol=TOL)
    for o in out[1:]:
        assert _same(o["fit"]["params"], fit["params"])
        assert o["eval_all"] == out[0]["eval_all"]


def test_width_fit_collective_bytes(ranks):
    """A step carries both views' gathered projections (G x proj_out
    float32 each) and every rank's gradient (W x parameters float32)."""
    world, out = ranks
    n_params = sum(v.size for v in out[0]["fit"]["params"].values())
    rc = RGCNConfig()
    step = 2 * TC.batch_size * rc.proj_out * 4 + world * n_params * 4
    assert out[0]["fit"]["collective_bytes"] == step
    assert out[0]["fit"]["fit_bytes"] > TC.steps * step  # + eval, agreement


def test_refit_at_a_fixed_width_is_bit_exact(ranks):
    world, out = ranks
    for o in out:
        assert _same(o["refit"], o["fit"]["params"])


def test_prefetch_at_a_fixed_width_is_bit_exact(ranks):
    """The ranks' fit with one-ahead staging (the default: each rank's
    share staged a chunk ahead on a worker thread) equals the same fit
    staged inline, bit for bit."""
    world, out = ranks
    for o in out:
        assert o["inline"]["prefetch"] == (True, False)
        assert _same(o["inline"]["params"], o["fit"]["params"])
        np.testing.assert_array_equal(o["inline"]["losses"],
                                      o["fit"]["losses"])


def test_resume_at_a_fixed_width_is_bit_exact(ranks):
    """Interrupted at step 4 and resumed from rank 0's checkpoint, on every
    rank: the losses and parameters of the uninterrupted fit."""
    world, out = ranks
    for o in out:
        assert o["interrupted"]
        assert o["resume"]["resumed_from"] == 4
        np.testing.assert_array_equal(o["resume"]["losses"],
                                      o["fit"]["losses"])
        assert _same(o["resume"]["params"], o["fit"]["params"])


def test_width_fit_matches_jax_fit(ranks, one_rank):
    """On JAX's initial parameters and draws: the W-rank fit against JAX's
    one-device fit at ``test_torch_fit_parity``'s tolerances (the whole
    parameter vector relative to its norm, the losses relative), and
    against the one-rank fit on the same draws within 5e-5."""
    from test_torch_fit_parity import LOSS_TOL, PARAM_TOL, gaps

    from repro_torch.interop import params_to_numpy

    world, out = ranks
    got = out[0]["jax_draws"]
    enc = rgcn_mod.RGCNEncoder(RGCNConfig())
    enc.load_state_dict({k: torch.from_numpy(v)
                         for k, v in got["params"].items()})
    whole, per = gaps(params_to_numpy(enc), one_rank["jax"])
    assert whole <= PARAM_TOL, (whole, per)
    np.testing.assert_allclose(got["losses"], one_rank["jax_losses"],
                               rtol=LOSS_TOL)
    mine = params_to_numpy(enc)
    _close(mine, one_rank["jax_draws"])
    np.testing.assert_allclose(got["losses"], one_rank["jax_draws_losses"],
                               atol=TOL, rtol=TOL)


def test_one_rank_group_fit_is_the_fit_without_a_group(ranks):
    world, out = ranks
    a, b = out[0]["one_rank_group"]
    assert _same(a, b)
    assert all("one_rank_group" not in o for o in out[1:])


def test_fit_resilient_shrinks_by_halves(ranks, one_rank):
    """test_fault.py's mesh shrink: a participant lost at each width's
    first boundary degrades W -> ... -> 1, every rank recording the lowest
    losing rank's error; the rank that finishes ran every step, within
    5e-5 of the one-rank fit, and the ranks a shrink left return no
    encoder and the width they left."""
    world, out = ranks
    widths, n = [], world
    while n >= 1:
        widths.append(n)
        n //= 2
    want = [{"from_devices": a, "to_devices": b,
             "error": "injected participant loss"}
            for a, b in zip(widths, widths[1:])]
    fin = out[0]["resilient"]
    assert fin["degradations"] == want
    assert fin["data_shards"] == 1 and fin["steps"] == TC.steps
    _close(fin["params"], one_rank["params"])
    for rank, o in enumerate(out[1:], start=1):
        left = max(w for w in widths if w <= rank)
        assert o["resilient"]["params"] is None
        assert o["resilient"]["data_shards"] == left
        assert o["resilient"]["degradations"] == want[:widths.index(left)]


def test_psum_mean_matches_jax(ranks):
    import jax

    from repro.optim.grad_compress import psum_mean as jpsum_mean

    world, out = ranks
    grads, _ = _psum_inputs(world)
    want = jax.vmap(lambda g: jpsum_mean(g, "data"), axis_name="data")(grads)
    for rank, o in enumerate(out):
        for k in grads:
            np.testing.assert_allclose(o["psum_mean"][k],
                                       np.asarray(want[k])[rank], rtol=1e-6,
                                       atol=1e-7)


def test_compressed_psum_mean_matches_jax(ranks):
    """Means and residuals within one ulp of the shared scale of JAX's
    (the int8 codes summed as int32 here, int16 in JAX); the means within
    JAX's grid (amax / 127) of the exact mean."""
    import jax

    from repro.optim.grad_compress import (
        compressed_psum_mean as jcompressed,
    )

    world, out = ranks
    grads, err = _psum_inputs(world)
    mean, new_err = jax.vmap(lambda g, e: jcompressed(g, e, "data"),
                             axis_name="data")(grads, err)
    for rank, o in enumerate(out):
        got_mean, got_err = o["compressed"]
        for k in grads:
            g32 = grads[k] + err[k]
            ulp = np.spacing(np.float32(np.abs(g32).max() / 127.0))
            assert np.abs(got_mean[k] - np.asarray(mean[k])[rank]).max() \
                <= ulp
            assert np.abs(got_err[k] - np.asarray(new_err[k])[rank]).max() \
                <= ulp
            grid = np.abs(g32).max() / 127.0
            assert np.abs(got_mean[k] - g32.mean(0)).max() <= grid + 1e-6


# ---------------------------------------------------------------------------
# the sweep dispatch placed across devices
# ---------------------------------------------------------------------------

def _embs(n=16, dim=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(40 + 3 * i, dim)).astype(np.float32)
            for i in range(n)]


PLACED = ["cpu"] * 8


def _same_results(a, b):
    for (la, ia), (lb, ib) in zip(a, b):
        np.testing.assert_array_equal(la, lb)
        assert ia["k"] == ib["k"]
        assert ia.get("scores") == ib.get("scores")


def test_placed_sweep_matches_unplaced_and_sequential():
    """test_scaleout.py's sharded dispatch: labels and K equal to the
    sequential reference, and labels, K and scores bit-equal to the same
    chunks swept unplaced (one slice)."""
    embs = _embs()
    kw = dict(k_max=6, iters=8, max_batch=2, data_devices=8, device="cpu")
    placed = PlanEngine(devices=PLACED, **kw).cluster_many(embs)
    unplaced = PlanEngine(**kw).cluster_many(embs)
    reference = PlanEngine(k_max=6, iters=8, engine="sequential",
                           device="cpu").cluster_many(embs)
    _same_results(placed, unplaced)
    for (lab, info), (lab_r, info_r) in zip(placed, reference):
        np.testing.assert_array_equal(lab, lab_r)
        assert info["k"] == info_r["k"]


def test_placed_dispatch_scales_chunk_cap_like_jax():
    """One dispatch serves data_devices x max_batch programs (16
    same-bucket programs, 8 slices of 2), as JAX's engine counts it."""
    from repro.sampling.engine import PlanEngine as JPlanEngine

    rng = np.random.default_rng(2)
    embs = [rng.normal(size=(40 + i, 8)).astype(np.float32)
            for i in range(16)]
    kw = dict(k_max=6, iters=8, max_batch=2, data_devices=8)
    eng = PlanEngine(devices=PLACED, device="cpu", **kw)
    got = eng.cluster_many(embs)
    jeng = JPlanEngine(**kw)
    want = jeng.cluster_many(embs)
    for key in ("dispatches", "programs", "bucket_hist"):
        assert eng.stats[key] == jeng.stats[key], key
    assert eng.stats["dispatches"] == 1
    assert eng.engine_stats()["data_shards"] == 8 == \
        jeng.engine_stats()["data_shards"]
    for (lab, info), (lab_j, info_j) in zip(got, want):
        np.testing.assert_array_equal(lab, np.asarray(lab_j))
        assert info["k"] == info_j["k"]


def test_placed_sweep_degrade_keeps_parity():
    """test_fault.py's 8 -> 4 shard degrade mid-serve: labels and K still
    the sequential reference's, the width halved once."""
    rng = np.random.default_rng(1)
    embs = [rng.normal(size=(40 + i, 8)).astype(np.float32)
            for i in range(8)]
    reference = PlanEngine(k_max=6, iters=8, engine="sequential",
                           device="cpu").cluster_many(embs)
    eng = PlanEngine(k_max=6, iters=8, max_batch=1, data_devices=8,
                     devices=PLACED, device="cpu")
    fired = {"n": 0}

    def hook():
        if fired["n"] == 0:
            fired["n"] += 1
            raise DeviceLost("injected")

    eng.fault_hook = hook
    results = eng.cluster_many(embs)
    st = eng.engine_stats()
    assert st["degraded_dispatches"] == 1 and st["data_shards"] == 4
    for (lab, info), (lab_r, info_r) in zip(results, reference):
        np.testing.assert_array_equal(lab, lab_r)
        assert info["k"] == info_r["k"]


def test_data_devices_zero_is_every_device_of_the_placement():
    """JAX's default width, every device: the placement's (here a list),
    else the cards present (1 on the CPU)."""
    assert PlanEngine(device="cpu").engine_stats()["data_shards"] == 1
    assert PlanEngine(device="cpu", devices=["cpu"] * 4).engine_stats()[
        "data_shards"] == 4
    assert PlanEngine(device="cpu", devices=["cpu"] * 4,
                      data_devices=2).engine_stats()["data_shards"] == 2


def test_group_refuses_a_tensor_its_backend_cannot_carry():
    """No tensor changes device: an NCCL group refuses a CPU tensor."""
    g = Group.__new__(Group)
    g.backend, g.bytes = "nccl", 0
    with pytest.raises(ValueError, match="does not carry cpu"):
        g.all_reduce(torch.zeros(3))
    with pytest.raises(ValueError, match="backend must be"):
        init_group("mpi", 0, 1, "/nonexistent")


def test_meshes_count_a_groups_ranks():
    """With a group, ``widths`` and ``make_data_mesh`` count its ranks
    (a prefix of them), and a wider mesh raises."""
    from repro_torch.launch import mesh

    class FourRanks:
        size = 4

    g = FourRanks()
    assert list(mesh.widths("cpu", g)) == [1, 2, 3, 4]
    full = mesh.make_data_mesh(0, group=g)
    assert full.shape == (4, 1) and full.ranks == (0, 1, 2, 3)
    assert full.size == 4 and full.devices == ()
    assert mesh.make_data_mesh(2, group=g).ranks == (0, 1)
    with pytest.raises(ValueError, match="A9b"):
        mesh.make_data_mesh(8, group=g)
    with pytest.raises(ValueError, match="A9b"):
        fit_resilient(RGCNConfig(), TC, _graphs(), checkpoint_dir="ck",
                      device_counts=[8, 4], device="cpu", group=g)
