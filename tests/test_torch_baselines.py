"""The port's pka / sieve / stem_root methods against the JAX package's.

Same programs, same platform: the plans (labels, representatives) and the
evaluation (eq. 5 and eq. 6 on every platform) must be equal.  PKA
clusters its 12 z-scored features through the port's ``PlanEngine`` on the
CPU (K2 / K3's plain versions), JAX through its jnp sweep; its legacy
``pka_plan`` runs the sequential reference on both sides.  Sieve and
STEM+ROOT are numpy on both sides.  ``PlanService.submit_program`` with
sieve resolves at once through the method's own ``plan``.
"""

import numpy as np
import pytest
import torch

from repro.core.baselines.pka import pka_plan as jax_pka_plan
from repro.sampling import evaluate as jax_evaluate
from repro.sampling import get_method as jax_get_method
from repro.tracing.programs import get_program as jax_get_program
from repro_torch.core.baselines.pka import pka_plan
from repro_torch.sampling import available_methods, evaluate, get_method
from repro_torch.serving import PlanService
from repro_torch.tracing.programs import get_program

PROGRAMS = ["nw", "3mm", "backprop", "bfs"]
METHODS = ["pka", "sieve", "stem_root"]



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small torch ops, which
    several test processes on one host slow down by oversubscribing the
    cores with spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _kw(method_id):
    """PKA at k_max = 8 keeps the candidate sweep small on the CPU."""
    return {"k_max": 8} if method_id == "pka" else {}


def test_all_four_methods_are_registered():
    assert available_methods() == ["gcl", "pka", "sieve", "stem_root"]


@pytest.mark.parametrize("method_id", METHODS)
@pytest.mark.parametrize("name", PROGRAMS)
def test_baseline_plans_match_jax(method_id, name):
    prog, jprog = get_program(name), jax_get_program(name)
    kw = _kw(method_id)
    m = get_method(method_id, platform="P2",
                   **(dict(kw, device="cpu") if method_id == "pka" else kw))
    jm = jax_get_method(method_id, platform="P2", **kw)
    plan, art = m.run(prog)
    jplan, jart = jm.run(jprog)
    assert art.key == jart.key             # same configs: same content keys
    assert plan.method == jplan.method
    np.testing.assert_array_equal(plan.labels, jplan.labels)
    assert plan.reps == jplan.reps
    for platform in ("P1", "P3"):
        ev = evaluate(plan, prog, platform)
        jev = jax_evaluate(jplan, jprog, platform)
        assert ev.error_pct == jev.error_pct
        assert ev.speedup == jev.speedup


@pytest.mark.parametrize("name", PROGRAMS)
def test_legacy_pka_plan_matches_jax(name):
    """``pka_plan`` clusters through the sequential reference (K4's plain
    version here) on both sides."""
    plan = pka_plan(get_program(name), k_max=8, device="cpu")
    jplan = jax_pka_plan(jax_get_program(name), k_max=8)
    np.testing.assert_array_equal(plan.labels, jplan.labels)
    assert plan.reps == jplan.reps
    assert plan.extra["k"] == jplan.extra["k"]


def test_submit_program_with_sieve_resolves_through_plan():
    prog = get_program("3mm")
    m = get_method("sieve")
    assert m.plan_request(prog, m.prepare(prog)) is None
    with PlanService(device="cpu", max_delay_ms=1.0) as svc:
        fut = svc.submit_program(m, prog)
        assert fut.done()                  # resolved without the queue
        plan = fut.result()
        assert svc.stats()["submitted"] == 0
    jm = jax_get_method("sieve")
    jplan, _ = jm.run(jax_get_program("3mm"))
    np.testing.assert_array_equal(plan.labels, jplan.labels)
    assert plan.reps == jplan.reps


def test_submit_program_with_pka_is_batched():
    prog = get_program("bfs")
    m = get_method("pka", k_max=8, device="cpu")
    with PlanService(device="cpu", max_delay_ms=1.0, k_max=8) as svc:
        plan = svc.submit_program(m, prog).result(timeout=300)
        assert svc.stats()["served"] == 1
    np.testing.assert_array_equal(plan.labels, m.run(prog)[0].labels)
