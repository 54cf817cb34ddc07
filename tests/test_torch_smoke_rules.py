"""The acceptance rule of ``chip_smoke.device_ms`` on the CPU.

``chip_smoke.py`` times the port's kernels on the card from torch.profiler
records.  CUPTI now and then records only part of a run, so a record is
accepted only when it provably holds every call (``profile_verdict``): each
kernel the wrapper launches appears exactly ``iters`` x its launches per
call, and a call whose kernels cannot be listed shows at least ``iters`` x
the device events of one call recorded first.  Otherwise ``device_ms``
takes another record, up to ``RECORD_TRIES``, then the spin-primed device
span, and says which source gave the number.  Here the records are fakes of
``prof.key_averages()``; no card is needed.
"""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(smoke)

K3 = {"sil_rows_kernel": 1, "sil_compact_kernel": 1,
      "silhouette_sums_kernel": 1}


def _avg(key, count, us):
    return SimpleNamespace(key=key, count=count, self_device_time_total=us)


def _k3_record(iters, short=None, extra=None):
    """Fake ``key_averages()`` of ``iters`` K3 calls: ``short`` names a
    kernel recorded once less, ``extra`` one recorded once more."""
    return [_avg(f"(anonymous namespace)::{name}(float const*, ...)",
                 iters - (name == short) + (name == extra), us * iters)
            for name, us in (("sil_rows_kernel", 2.0),
                             ("sil_compact_kernel", 3.0),
                             ("silhouette_sums_kernel", 70.0))]


def test_profile_events_keeps_device_events_only():
    avgs = [_avg("kernel_a", 5, 10.0), _avg("aten::empty", 5, 0.0),
            _avg("Memcpy HtoD", 0, 3.0),
            SimpleNamespace(key="old_api", count=2, self_device_time_total=None,
                            self_cuda_time_total=4.0)]
    assert smoke.profile_events(avgs) == [("kernel_a", 5, 10.0),
                                          ("old_api", 2, 4.0)]


@pytest.mark.parametrize("case,accepted", [
    ("complete", True), ("one launch missing", False),
    ("one launch too many", False), ("a kernel missing", False),
    ("empty", False)])
def test_verdict_on_named_kernels(case, accepted):
    iters = 10
    events = {"complete": _k3_record(iters),
              "one launch missing": _k3_record(iters, short="silhouette_sums_kernel"),
              "one launch too many": _k3_record(iters, extra="sil_rows_kernel"),
              "a kernel missing": _k3_record(iters)[1:],
              "empty": []}[case]
    ok, why = smoke.profile_verdict(
        [(k, c) for k, c, _ in smoke.profile_events(events)], iters, K3)
    assert ok is accepted, why


@pytest.mark.parametrize("seen,accepted", [(30, True), (45, True),
                                           (29, False), (0, False)])
def test_verdict_on_unlisted_kernels(seen, accepted):
    """A library call launching 3 device events per call, recorded over 10
    calls: fewer than 30 events means part of the run went unrecorded."""
    events = [("sm90_xmma_gemm_f32f32_tf32f32", seen // 3),
              ("elementwise_kernel", seen - seen // 3)] if seen else []
    ok, _ = smoke.profile_verdict(events, 10, None, min_events=3)
    assert ok is accepted


def _fake_device_ms(monkeypatch, records, spin=1.5):
    """device_ms with torch.profiler replaced by ``records`` (one list of
    (name, count, us) per recorded pass) and the spin-primed span by
    ``spin``; returns the pending records."""
    queue = list(records)
    monkeypatch.setattr(smoke, "_record", lambda fn, iters: queue.pop(0))
    monkeypatch.setattr(smoke, "_spin_primed_ms", lambda fn, iters: spin)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(smoke, "log", lambda *a: None)
    return queue


def test_device_ms_accepts_a_complete_record(monkeypatch):
    _fake_device_ms(monkeypatch, [smoke.profile_events(_k3_record(10))])
    t = smoke.device_ms(lambda: None, 10, own=K3)
    assert t.source == "cupti"
    assert t.own == pytest.approx(0.075) and t.total == pytest.approx(0.075)


def test_device_ms_retries_a_partial_record(monkeypatch):
    queue = _fake_device_ms(monkeypatch, [
        smoke.profile_events(_k3_record(10, short="sil_compact_kernel")),
        smoke.profile_events(_k3_record(10))])
    t = smoke.device_ms(lambda: None, 10, own=K3)
    assert t.source == "cupti" and not queue


def test_device_ms_falls_back_to_the_spin_primed_span(monkeypatch):
    bad = [smoke.profile_events(_k3_record(10, short="sil_rows_kernel")),
           smoke.profile_events(_k3_record(10, extra="silhouette_sums_kernel"))]
    queue = _fake_device_ms(
        monkeypatch, [bad[i % 2] for i in range(smoke.RECORD_TRIES)], spin=1.5)
    t = smoke.device_ms(lambda: None, 10, own=K3)
    assert t == smoke.DeviceTime(1.5, 1.5, "spin-primed") and not queue


def test_device_ms_holds_a_library_call_to_its_first_pass(monkeypatch):
    one = [("gemm", 1, 5.0), ("elementwise", 2, 1.0)]
    partial = [("gemm", 10, 50.0), ("elementwise", 12, 6.0)]
    full = [("gemm", 10, 50.0), ("elementwise", 20, 10.0)]
    queue = _fake_device_ms(monkeypatch, [one, partial, full])
    t = smoke.device_ms(lambda: None, 10)
    assert t.source == "cupti" and t.total == pytest.approx(0.006)
    assert t.own == 0.0 and not queue


def test_device_ms_raises_without_any_device_time(monkeypatch):
    _fake_device_ms(monkeypatch, [[]] * smoke.RECORD_TRIES, spin=None)
    with pytest.raises(RuntimeError, match="no device time"):
        smoke.device_ms(lambda: None, 10)


def test_device_ms_takes_the_last_record_it_may(monkeypatch):
    """A record that drops one launch twice, as CUPTI did on K6 at the
    dense batch's shape, is taken again rather than given up."""
    short = smoke.profile_events(_k3_record(10, short="silhouette_sums_kernel"))
    queue = _fake_device_ms(
        monkeypatch, [short] * (smoke.RECORD_TRIES - 1)
        + [smoke.profile_events(_k3_record(10))], spin=None)
    t = smoke.device_ms(lambda: None, 10, own=K3)
    assert t.source == "cupti" and not queue


def test_own_split_takes_only_a_complete_record(monkeypatch):
    """The per-kernel split comes from an accepted record: an empty or
    partial one is taken again, never read as zeros."""
    queue = _fake_device_ms(monkeypatch, [
        [], smoke.profile_events(_k3_record(10, short="sil_rows_kernel")),
        smoke.profile_events(_k3_record(10))])
    split = smoke.own_split_ms(lambda: None, 10, K3)
    assert not queue
    assert split == pytest.approx({"sil_rows_kernel": 0.002,
                                   "sil_compact_kernel": 0.003,
                                   "silhouette_sums_kernel": 0.070})


def test_own_split_is_none_when_every_record_is_refused(monkeypatch):
    _fake_device_ms(monkeypatch, [[]] * smoke.RECORD_TRIES)
    assert smoke.own_split_ms(lambda: None, 10, K3) is None


def _source_kernels():
    """The names of the ``__global__`` kernels in ``src/repro_torch/csrc``."""
    import re

    csrc = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
    text = "\n".join(p.read_text() for p in sorted(csrc.glob("*.cu")))
    return set(re.findall(r"__global__[^;{]*?\b(\w+_kernel)\s*\(", text))


@pytest.mark.parametrize("group", ["K1", "K2", "K3", "K4", "K5", "K1b",
                                   "K6", "K7", "K7b", "K8", "K8b",
                                   "FIT_SPLIT"])
def test_timed_kernel_names_are_kernels_of_the_sources(group):
    """Every name chip_smoke's records are held to (``own=``) and the fit's
    device time is split by is a kernel the CUDA sources define: a name left
    behind by a redesign would have every record of that kernel refused."""
    names = {"K1": smoke.K1_KERNELS, "K2": smoke.K2_KERNELS,
             "K3": smoke.K3_KERNELS, "K4": smoke.K4_KERNELS,
             "K5": smoke.K5_KERNELS, "K1b": smoke.K1B_KERNELS,
             "K6": smoke.K6_KERNELS,
             "K7": {**smoke.k7_kernels(16, torch.bfloat16),
                    **smoke.k7_kernels(64, torch.bfloat16),
                    **smoke.k7_kernels(64, torch.float32)},
             "K7b": {**smoke.k7b_kernels(128, torch.bfloat16),
                     **smoke.k7b_kernels(256, torch.bfloat16),
                     **smoke.k7b_kernels(128, torch.float32)},
             "K8": smoke.K8_KERNELS, "K8b": smoke.K8B_KERNELS,
             "FIT_SPLIT": [m for label, marks in smoke.FIT_SPLIT
                           if label.startswith("K") for m in marks]}[group]
    defined = _source_kernels()
    assert names and all(n in defined for n in names), (
        sorted(set(names) - defined))
