"""The port's runtime sanitizer on the CPU, counterparts of
``tests/test_analysis_lint.py``'s runtime-sanitizer cases: the NaN/inf
tripwire over result trees holding torch tensors (and numpy arrays,
dataclasses, floats), ``nan_tripwire`` bare and as a decorator,
``recompile_guard`` on the kernel library's build counter (quiet on a
region that builds nothing, tripping on a forced build), and
``PlanService(sanitize=True)``, which fails only the non-finite plan's
future, counts it in ``sanitize_trips``, and trips on the same request
JAX's service trips on."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.analysis import (
    NonFiniteError, RecompileError, check_finite, nan_tripwire,
    recompile_guard,
)
from repro_torch.sampling.engine import PlanRequest
from repro_torch.serving import PlanService


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: several test processes on one host would
    otherwise oversubscribe the cores with spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@dataclasses.dataclass
class _Result:
    z: torch.Tensor
    meta: dict


def test_check_finite_passes_clean_trees():
    check_finite({"a": torch.ones(3), "b": [np.zeros(2), 1.5],
                  "c": _Result(torch.zeros(2, 2), {"n": 3}),
                  "i": torch.arange(4), "e": torch.empty(0)})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64])
@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf")])
def test_check_finite_names_the_torch_leaf(dtype, bad):
    t = torch.zeros(2, 3, dtype=dtype)
    t[1, 2] = bad
    with pytest.raises(NonFiniteError) as ei:
        check_finite({"out": [torch.ones(2), _Result(t, {})]}, name="fit")
    msg = str(ei.value)
    assert "fit['out'][1].z" in msg and "1/6" in msg
    assert str(dtype) in msg and "(2, 3)" in msg


def test_check_finite_numpy_float_and_int_leaves():
    with pytest.raises(NonFiniteError, match=r"r\['x'\]"):
        check_finite({"x": np.array([1.0, np.nan])}, name="r")
    with pytest.raises(NonFiniteError, match=r"r\['s'\]"):
        check_finite({"s": float("inf")}, name="r")
    check_finite({"k": np.array([1, 2]), "t": torch.tensor([1, 2])})
    grad = torch.ones(2, requires_grad=True) * float("nan")
    with pytest.raises(NonFiniteError):
        check_finite(grad)


def test_check_finite_survives_cycles():
    d: dict = {"t": torch.ones(1)}
    d["self"] = d
    check_finite(d)


def test_nan_tripwire_wraps_and_decorates():
    wrapped = nan_tripwire(lambda x: {"y": torch.log(x)}, name="logs")
    assert wrapped(torch.ones(2))["y"].sum() == 0
    with pytest.raises(NonFiniteError, match=r"logs\(\.\.\.\)\['y'\]"):
        wrapped(torch.zeros(2))

    @nan_tripwire
    def divide(a, b):
        return a / b

    assert float(divide(torch.tensor(1.0), torch.tensor(2.0))) == 0.5
    with pytest.raises(NonFiniteError, match="divide"):
        divide(torch.tensor(1.0), torch.tensor(0.0))


def test_recompile_guard_quiet_without_builds():
    with recompile_guard(label="cpu plan") as st:
        PlanService(device="cpu", k_max=4, iters=4).close()
    assert st.builds == 0


def test_recompile_guard_trips_on_a_forced_library_build(tmp_path,
                                                         monkeypatch):
    """A build of the kernel library inside the region counts (here the
    build finds its library for these sources in a scratch build
    directory, which needs no nvcc): a budget of 0 trips, 1 passes."""
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    lib = tmp_path / f"libreprotorch-{kernels._digest(kernels._sources())}.so"
    lib.write_bytes(b"")
    with pytest.raises(RecompileError, match="1 kernel library build"):
        with recompile_guard(label="warm serve"):
            assert kernels.build() == lib
    with recompile_guard(max_builds=1) as st:
        kernels.build()
    assert st.builds == 1


def _fleet(poison_at=1):
    rng = np.random.default_rng(0)
    reqs = [PlanRequest(rng.normal(size=(40, 4)).astype(np.float32),
                        np.arange(40), "m") for _ in range(3)]
    reqs[poison_at].extra = {"score": float("nan")}
    return reqs


def test_plan_service_sanitize_isolates_a_non_finite_plan():
    with PlanService(max_batch=4, max_delay_ms=1.0, sanitize=True, k_max=4,
                     iters=8, device="cpu") as svc:
        futs = [svc.submit(r) for r in _fleet()]
        with pytest.raises(NonFiniteError, match=r"plan\.extra\['score'\]"):
            futs[1].result(timeout=120)
        plans = [futs[i].result(timeout=120) for i in (0, 2)]
    assert all(np.isfinite(p.labels).all() for p in plans)
    st = svc.stats()
    assert st["sanitize_trips"] == 1
    assert st["served"] == 2 and st["failed"] == 1
    # off by default: the same request is served as is
    with PlanService(max_batch=4, max_delay_ms=1.0, k_max=4, iters=8,
                     device="cpu") as svc:
        plan = svc.submit(_fleet()[1]).result(timeout=120)
    assert np.isnan(plan.extra["score"])
    assert svc.stats()["sanitize_trips"] == 0


def test_plan_service_sanitize_trips_where_jax_trips():
    """The same poisoned request trips JAX's sanitizing service too, with
    the same stats keys."""
    from repro.analysis.sanitize import NonFiniteError as JNonFiniteError
    from repro.sampling.engine import PlanRequest as JPlanRequest
    from repro.serving import PlanService as JPlanService

    reqs = _fleet(poison_at=0)
    with JPlanService(max_batch=4, max_delay_ms=1.0, sanitize=True, k_max=4,
                      iters=8) as jsvc:
        jfuts = [jsvc.submit(JPlanRequest(r.embeddings, r.seqs, r.method,
                                          extra=r.extra)) for r in reqs]
        with pytest.raises(JNonFiniteError):
            jfuts[0].result(timeout=120)
    with PlanService(max_batch=4, max_delay_ms=1.0, sanitize=True, k_max=4,
                     iters=8, device="cpu") as svc:
        futs = [svc.submit(r) for r in reqs]
        with pytest.raises(NonFiniteError):
            futs[0].result(timeout=120)
        for f, jf in zip(futs[1:], jfuts[1:]):
            np.testing.assert_array_equal(f.result(120).labels,
                                          jf.result(120).labels)
    jst, st = jsvc.stats(), svc.stats()
    assert st["sanitize_trips"] == jst["sanitize_trips"] == 1
    assert set(st) == set(jst)
