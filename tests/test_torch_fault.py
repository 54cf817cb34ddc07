"""The port's fault protocol on the CPU, against the JAX package's
single-device cases of ``tests/test_fault.py``: the plan engine degrades
its shard width on DeviceLost and raises at the one-shard floor, the
service surfaces the degradation, the fit checkpoints at a chunk boundary
before raising (from a hook or a fired watchdog), and ``fit_resilient``
degrades and finishes, needs a checkpoint directory, refuses widths above
the cards present, and raises once every width failed.  The fault hook
sees the same boundary steps as JAX's scan engine, in a whole fit and in a
resumed one.  ``distributed/fault.py`` itself is a verbatim copy (held
byte-equal in ``tests/test_torch_copies.py``).  Every port object runs
with ``device="cpu"``."""

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.rgcn import RGCNConfig
from repro_torch.core.train import (
    ContrastiveTrainer, FitInterrupted, GCLTrainConfig, fit_resilient,
)
from repro_torch.distributed import DeviceLost, Watchdog
from repro_torch.sampling.engine import PlanEngine, PlanRequest
from repro_torch.serving import PlanService


#: narrow encoder widths: the fault protocol does not depend on them
DIMS = (64, 32, 32, 48)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: several test processes on one host would
    otherwise oversubscribe the cores with spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rc():
    return RGCNConfig(dims=DIMS)


def _graphs(n=6, cap=48, jax=False):
    """JAX's ``tests/test_fault.py`` graphs, from either package."""
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


BASE = dict(steps=8, batch_size=4, scan_chunk=4, log_every=50,
            checkpoint_every=4)


def _tc(**kw):
    return GCLTrainConfig(**dict(BASE, **kw))


def _fit(tc=None, **kw):
    return ContrastiveTrainer(_rc(), tc or _tc(), device="cpu").fit(
        _graphs(), **kw)


def _once(at=None):
    """A hook that raises DeviceLost once (at the first boundary >= at,
    when given)."""
    fired = {"n": 0}

    def hook(*done):
        if fired["n"] == 0 and (at is None or done[0] >= at):
            fired["n"] += 1
            raise DeviceLost("injected")

    return hook


# -- the plan engine and the service -----------------------------------------

def _embs(n_req, n=40, d=4):
    rng = np.random.default_rng(0)
    return [rng.normal(size=(n, d)).astype(np.float32) for _ in range(n_req)]


def test_plan_engine_degrades_on_device_lost():
    """A DeviceLost from the hook halves the shard width and retries the
    same programs: every request served, the drop counted, labels equal
    to an engine that never lost a participant."""
    embs = _embs(4)
    eng = PlanEngine(k_max=4, iters=8, data_devices=2, device="cpu")
    eng.fault_hook = _once()
    results = eng.cluster_many(embs)
    st = eng.engine_stats()
    assert st["degraded_dispatches"] == 1
    assert st["data_shards"] == 1
    assert st["errors"] == 0
    ref = PlanEngine(k_max=4, iters=8, device="cpu").cluster_many(embs)
    for (lab, info), (lab_r, info_r) in zip(results, ref):
        np.testing.assert_array_equal(lab, lab_r)
        assert info["k"] == info_r["k"]


def test_plan_engine_raises_at_one_shard_floor():
    eng = PlanEngine(k_max=4, iters=8, data_devices=1, device="cpu")

    def hook():
        raise DeviceLost("hard down")

    eng.fault_hook = hook
    with pytest.raises(DeviceLost, match="hard down"):
        eng.cluster_many(_embs(1))
    assert eng.engine_stats()["degraded_dispatches"] == 0


def test_plan_engine_width_defaults_to_the_devices_present():
    """data_devices=0: one, the engine's own device (a dispatch is placed
    on it alone); an explicit width is kept."""
    assert PlanEngine(device="cpu").engine_stats()["data_shards"] == 1
    assert PlanEngine(data_devices=8, device="cpu").engine_stats()[
        "data_shards"] == 8


def test_plan_service_surfaces_degradation():
    rng = np.random.default_rng(0)
    with PlanService(max_batch=4, max_delay_ms=1.0, data_devices=2,
                     fault_hook=_once(), k_max=4, iters=8,
                     device="cpu") as svc:
        futs = [svc.submit(PlanRequest(
            rng.normal(size=(40, 4)).astype(np.float32), np.arange(40), "m"))
            for _ in range(4)]
        plans = [f.result(timeout=120) for f in futs]
    assert all(p is not None and not isinstance(p, Exception) for p in plans)
    st = svc.stats()
    assert st["engine"]["degraded_dispatches"] == 1
    assert st["engine"]["data_shards"] == 1
    assert st["failed"] == 0 and st["served"] == 4


# -- the fit ------------------------------------------------------------------

def test_fit_fault_hook_checkpoints_then_raises(tmp_path):
    ck = str(tmp_path / "ck")
    with pytest.raises(DeviceLost, match="injected"):
        _fit(checkpoint_dir=ck, fault_hook=_once(at=4))
    assert CheckpointManager(ck).latest_step() >= 4


def test_fit_fault_hook_checkpoints_without_cadence(tmp_path):
    """With no checkpoint cadence the boundary is still saved before the
    raise, and the history up to it is flushed into the snapshot."""
    ck = str(tmp_path / "ck")
    seen = []

    def hook(done):
        seen.append(done)
        raise DeviceLost("lost")

    with pytest.raises(DeviceLost):
        _fit(_tc(checkpoint_every=0), checkpoint_dir=ck, fault_hook=hook)
    step = CheckpointManager(ck).latest_step()
    assert step == seen[-1] and len(seen) == 1
    tree, _ = CheckpointManager(ck).restore_tree()
    assert len(tree["history"]["loss"]) == step


def test_fit_watchdog_slo_becomes_device_lost(tmp_path):
    ck = str(tmp_path / "ck")
    wd = Watchdog(min_timeout_s=1e-4)  # the first chunk always exceeds this
    with pytest.raises(DeviceLost, match="watchdog SLO"):
        _fit(checkpoint_dir=ck, watchdog=wd)
    assert wd.fired >= 1
    assert CheckpointManager(ck).latest_step() is not None


def test_fit_quiet_watchdog_changes_nothing():
    """A watchdog within its SLO and a hook that never raises leave the
    fit's losses bit-equal to a plain fit's."""
    wd = Watchdog(min_timeout_s=60.0)
    _, a = _fit(watchdog=wd, fault_hook=lambda done: None)
    _, b = _fit()
    assert wd.fired == 0 and wd._timer is None
    assert [h["loss"] for h in a["history"]] == [h["loss"]
                                                 for h in b["history"]]
    assert a["chunk_len"] == 4


def test_fit_resilient_degrades_and_finishes(tmp_path):
    """One injected loss: the next width resumes from the boundary's
    checkpoint and finishes every step, with parameters bit-equal to an
    uninterrupted fit (resume is exact)."""
    enc, info = fit_resilient(
        _rc(), _tc(), _graphs(), checkpoint_dir=str(tmp_path / "ck"),
        device_counts=[1, 1], fault_hook=_once(at=4), device="cpu")
    assert len(info["degradations"]) == 1
    assert info["degradations"][0] == {"from_devices": 1, "to_devices": 1,
                                       "error": "injected"}
    assert info["data_shards"] == 1
    assert info["resumed_from"] >= 4
    assert len(info["history"]) == 8
    full, full_info = _fit()
    for (k, p), q in zip(enc.state_dict().items(),
                         full.state_dict().values()):
        assert p.equal(q), k
    assert [h["loss"] for h in info["history"]] == [
        h["loss"] for h in full_info["history"]]


def test_fit_resilient_requires_checkpoint_dir():
    with pytest.raises(ValueError, match="checkpoint_dir"):
        fit_resilient(_rc(), _tc(), _graphs(), checkpoint_dir="",
                      device="cpu")


def test_fit_resilient_refuses_widths_above_the_cards_present(tmp_path):
    with pytest.raises(ValueError, match="A9b"):
        fit_resilient(_rc(), _tc(), _graphs(),
                      checkpoint_dir=str(tmp_path / "ck"),
                      device_counts=[2, 1], device="cpu")


def test_fit_resilient_exhausts_every_width(tmp_path):
    def always_lost(done):
        raise DeviceLost("hard down")

    with pytest.raises(DeviceLost, match="every mesh width"):
        fit_resilient(_rc(), _tc(), _graphs(),
                      checkpoint_dir=str(tmp_path / "ck"),
                      device_counts=[1, 1], fault_hook=always_lost,
                      device="cpu")


# -- boundaries equal JAX's ---------------------------------------------------

def _jax_fit(graphs, tc_kw, **kw):
    from repro.core.rgcn import RGCNConfig as JRGCNConfig
    from repro.core.train import ContrastiveTrainer as JTrainer
    from repro.core.train import GCLTrainConfig as JTrainConfig

    return JTrainer(JRGCNConfig(dims=DIMS), JTrainConfig(**tc_kw)).fit(
        graphs, **kw)


@pytest.mark.parametrize("tc_kw", [
    dict(BASE, checkpoint_every=0),
    dict(BASE, checkpoint_every=0, scan_chunk=32, steps=12)],
    ids=["chunk4", "chunk32_steps12"])
def test_fault_boundaries_equal_jax(tc_kw, tmp_path):
    """The steps at which the hook runs equal JAX's chunk boundaries (per
    segment of the epoch plan), in a whole fit and after a resume from a
    checkpoint inside a chunk (the port's cursor 3), where the port meets
    exactly JAX's boundaries past its cursor."""
    jseen, tseen = [], []
    _jax_fit(_graphs(jax=True), tc_kw, fault_hook=jseen.append)
    ContrastiveTrainer(_rc(), GCLTrainConfig(**tc_kw),
                       device="cpu").fit(_graphs(), fault_hook=tseen.append)
    assert tseen == jseen and jseen[-1] == tc_kw["steps"]
    ck = str(tmp_path / "ck")
    tc = GCLTrainConfig(**tc_kw)
    with pytest.raises(FitInterrupted):
        ContrastiveTrainer(_rc(), tc, device="cpu").fit(
            _graphs(), checkpoint_dir=ck, interrupt_after=3)
    resumed = []
    _, info = ContrastiveTrainer(_rc(), tc, device="cpu").fit(
        _graphs(), checkpoint_dir=ck, fault_hook=resumed.append)
    assert info["resumed_from"] == 3
    assert resumed == [b for b in jseen if b > 3]


def test_resumed_fault_boundaries_equal_jax(tmp_path):
    """Both packages interrupted at the same boundary and resumed: the
    hook sees the same steps."""
    tc_kw = dict(BASE, checkpoint_every=0, scan_chunk=2)
    seen = {}
    for side in ("jax", "port"):
        ck = str(tmp_path / side)
        dones = []
        if side == "jax":
            from repro.core.train import FitInterrupted as JInterrupted

            with pytest.raises(JInterrupted):
                _jax_fit(_graphs(jax=True), tc_kw, checkpoint_dir=ck,
                         interrupt_after=4)
            info = _jax_fit(_graphs(jax=True), tc_kw, checkpoint_dir=ck,
                            fault_hook=dones.append)[1]
        else:
            tc = GCLTrainConfig(**tc_kw)
            with pytest.raises(FitInterrupted):
                ContrastiveTrainer(_rc(), tc, device="cpu").fit(
                    _graphs(), checkpoint_dir=ck, interrupt_after=4)
            info = ContrastiveTrainer(_rc(), tc, device="cpu").fit(
                _graphs(), checkpoint_dir=ck, fault_hook=dones.append)[1]
        seen[side] = (info["resumed_from"], dones)
    assert seen["port"] == seen["jax"]
    assert seen["jax"][0] == 4 and seen["jax"][1][-1] == 8
