"""The port's one-ahead staging (``core/train._OneAhead``) and the fit's and
embed's use of it, against the contract of JAX's ``_OneAhead``
(``tests/test_train_engine.py::test_prefetch_fit_bit_exact_vs_inline_staging``,
``tests/test_batching.py::test_embed_prefetch_parity``).

The pipeline keeps order, keeps at most ``depth`` staged items ahead of
the consumer, re-raises a stage's exception at that item, and leaves no
``stage-prefetch`` thread behind when the consumer leaves early.  The fit
with ``prefetch`` on (depth 1 and 2) and off gives equal parameters and
histories, a resume whose cursor falls inside a chunk included; ``embed``
and ``embed_stream`` give equal embeddings, ``embed_stream`` with at most
two micro-batches staged at once.  Narrow widths, one intra-op thread.
"""

import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core.graphs import build_kernel_graph
from repro_torch.core.rgcn import RGCNConfig, init_rgcn
from repro_torch.core.train import (
    ContrastiveTrainer, FitInterrupted, GCLTrainConfig, _OneAhead,
    fit_resilient,
)
from repro_torch.distributed import DeviceLost
from repro_torch.tracing.templates import make_kernel

RC = RGCNConfig(dims=(64, 32, 32, 48))
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
#: graphs of one size: every step's batch lands in one bucket, so the
#: epoch is one segment and its chunks are whole (boundaries 4 and 8)
UNIFORM = [build_kernel_graph(make_kernel(
    f"g{i}", "gemm", {"M": 128, "N": 128, "K": 128}, i, seed=i).trace(
        cap_warps=2, cap_instr=40)) for i in range(8)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stagers() -> list:
    return [t for t in threading.enumerate()
            if t.name.startswith("stage-prefetch")]


def _tc(**kw):
    base = dict(steps=8, batch_size=4, log_every=3, scan_chunk=4)
    base.update(kw)
    return GCLTrainConfig(**base)


def _fit(tc, graphs=GRAPHS, **kw):
    enc, info = ContrastiveTrainer(RC, tc, device="cpu").fit(graphs, **kw)
    return enc.state_dict(), info


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("enabled,depth", [(False, 1), (True, 1), (True, 2),
                                           (True, 3)])
def test_one_ahead_keeps_order_and_accounts(enabled, depth):
    calls = []

    def stage(x):
        calls.append(x)
        return 10 * x

    with _OneAhead(stage, range(9), enabled=enabled, depth=depth) as pipe:
        got = list(pipe)
    assert got == [(i, 10 * i) for i in range(9)]
    assert calls == list(range(9))
    assert pipe.stage_s > 0
    if not enabled:
        assert pipe.wait_s == pipe.stage_s and pipe.overlap_fraction == 0.0
    assert 0.0 <= pipe.overlap_fraction <= 1.0
    assert not _stagers()


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_one_ahead_stages_at_most_depth_ahead(depth):
    """Items staged and not yet released by a slow consumer: at most the
    one it holds plus ``depth``, and the window fills."""
    lock = threading.Lock()
    live, peak = [0], [0]

    def stage(x):
        with lock:
            live[0] += 1
            peak[0] = max(peak[0], live[0])
        return x

    with _OneAhead(stage, range(8), depth=depth) as pipe:
        for _ in pipe:
            time.sleep(0.01)
            with lock:
                live[0] -= 1
    assert peak[0] == depth + 1


@pytest.mark.parametrize("enabled,depth", [(False, 1), (True, 1), (True, 2)])
def test_one_ahead_stage_error_reaches_the_consumer_at_its_item(enabled,
                                                                depth):
    calls = []

    def stage(x):
        calls.append(x)
        if x == 3:
            raise ValueError("stage 3 failed")
        return x

    got = []
    with pytest.raises(ValueError, match="stage 3 failed"):
        with _OneAhead(stage, range(8), enabled=enabled,
                       depth=depth) as pipe:
            for item, _ in pipe:
                got.append(item)
    assert got == [0, 1, 2]
    assert calls.count(3) == 1                  # not retried
    assert calls == sorted(calls)
    assert not _stagers()


def test_one_ahead_iterator_error_reaches_the_consumer():
    def items():
        yield 0
        raise OSError("trace failed")

    got = []
    with pytest.raises(OSError, match="trace failed"):
        with _OneAhead(lambda x: x, items()) as pipe:
            for item, _ in pipe:
                got.append(item)
    assert got == [0] and not _stagers()


@pytest.mark.parametrize("how", ["break", "raise"])
def test_one_ahead_early_exit_stops_the_worker(how):
    started = threading.Event()

    def stage(x):
        started.set()
        time.sleep(0.02)
        return x

    pipe = _OneAhead(stage, range(100), depth=2)
    try:
        with pipe:
            for item, _ in pipe:
                assert started.is_set() and _stagers()
                if item == 2:
                    if how == "break":
                        break
                    raise KeyError("consumer failed")
    except KeyError:
        assert how == "raise"
    assert not _stagers()


# ---------------------------------------------------------------------------
# the fit
# ---------------------------------------------------------------------------

def test_prefetch_fit_bit_exact_vs_inline_staging():
    """JAX's twin: prefetch on (depth 1 and 2) and off give equal
    parameters and histories; the overlap accounting is reported."""
    p_on, i_on = _fit(_tc())
    p_off, i_off = _fit(_tc(prefetch=False))
    p_d2, i_d2 = _fit(_tc(prefetch_depth=2))
    assert _same(p_on, p_off) and _same(p_on, p_d2)
    assert i_on["history"] == i_off["history"] == i_d2["history"]
    assert i_on["val_loss"] == i_off["val_loss"] == i_d2["val_loss"]
    assert i_on["prefetch"] is True and i_off["prefetch"] is False
    assert i_on["prefetch_stage_s"] > 0
    assert 0.0 <= i_on["prefetch_overlap"] <= 1.0
    assert i_off["prefetch_overlap"] == 0.0
    assert i_off["prefetch_wait_s"] == i_off["prefetch_stage_s"]
    assert not _stagers()


@pytest.mark.parametrize("prefetch,depth", [(True, 1), (True, 2),
                                            (False, 1)])
def test_resume_inside_a_chunk_is_bit_exact(tmp_path, prefetch, depth):
    """Checkpoints every 3 steps, chunks of 4: interrupted at step 5 and
    resumed from it (a cursor inside the chunk 4..8), the fit equals the
    uninterrupted inline fit bit for bit."""
    bounds = []
    full, i_full = _fit(_tc(prefetch=False), UNIFORM,
                        fault_hook=bounds.append)
    assert bounds == [4, 8]
    tc = _tc(checkpoint_every=3, prefetch=prefetch, prefetch_depth=depth)
    ck = str(tmp_path / "ck")
    with pytest.raises(FitInterrupted):
        _fit(tc, UNIFORM, checkpoint_dir=ck, interrupt_after=5)
    assert not _stagers()
    res, i_res = _fit(tc, UNIFORM, checkpoint_dir=ck)
    assert i_res["resumed_from"] == 5
    assert _same(full, res)
    assert i_full["history"] == i_res["history"]


def test_device_lost_from_fault_hook_leaves_no_stager(tmp_path):
    def lose(done):
        raise DeviceLost(f"lost at {done}")

    with pytest.raises(DeviceLost, match="lost at"):
        ContrastiveTrainer(RC, _tc(prefetch_depth=2), device="cpu").fit(
            GRAPHS, fault_hook=lose)
    assert not _stagers()
    with pytest.raises(DeviceLost, match="every mesh width"):
        fit_resilient(RC, _tc(), GRAPHS, checkpoint_dir=str(tmp_path),
                      fault_hook=lose, device="cpu")
    assert not _stagers()


def test_eval_fold_seeds_the_validation_draws():
    """``eval_fold`` picks the validation generator's stream; the default
    is JAX's 123, and another fold gives another validation loss."""
    p, i_def = _fit(_tc(steps=2))
    _, i_123 = _fit(_tc(steps=2, eval_fold=123))
    _, i_7 = _fit(_tc(steps=2, eval_fold=7))
    assert GCLTrainConfig().eval_fold == 123
    assert i_def["val_loss"] == i_123["val_loss"]
    assert i_7["val_loss"] != i_def["val_loss"]
    assert i_7["history"] == i_def["history"]


# ---------------------------------------------------------------------------
# embed and embed_stream
# ---------------------------------------------------------------------------

def _embedder(prefetch, depth=1):
    return ContrastiveTrainer(RC, GCLTrainConfig(prefetch=prefetch,
                                                 prefetch_depth=depth),
                              device="cpu")


@pytest.mark.parametrize("stream", [False, True], ids=["embed", "stream"])
def test_embed_prefetch_parity(stream):
    """JAX's twin, for ``embed`` and ``embed_stream``: equal embeddings on
    and off (depth 2 too), the four staging keys in ``embed_stats``."""
    params = init_rgcn(2, RC)
    outs, stats = [], []
    for prefetch, depth in ((True, 1), (False, 1), (True, 2)):
        tr = _embedder(prefetch, depth)
        fn = tr.embed_stream if stream else tr.embed
        outs.append(fn(params, iter(GRAPHS) if stream else GRAPHS,
                       batch_size=4))
        stats.append(tr.embed_stats)
    for z in outs[1:]:
        np.testing.assert_array_equal(z, outs[0])
    on, off, _ = stats
    assert on["microbatches"] == off["microbatches"] == 3
    assert on["prefetch"] is True and off["prefetch"] is False
    assert on["prefetch_stage_s"] > 0
    assert 0.0 <= on["prefetch_overlap"] <= 1.0
    assert off["prefetch_overlap"] == 0.0
    assert not _stagers()


def test_embed_stream_holds_at_most_two_microbatches():
    """Micro-batches staged and not yet encoded, with a slow encoder: two
    at most (JAX's depth 1), whatever ``prefetch_depth`` says; the
    binner's own residency stays one micro-batch of graphs."""
    tr = _embedder(True, depth=3)
    lock = threading.Lock()
    live, peak = [0], [0]
    stage_bin, encode = tr._stage_bin, tr._encode

    def counting_stage(*a):
        with lock:
            live[0] += 1
            peak[0] = max(peak[0], live[0])
        return stage_bin(*a)

    def slow_encode(*a):
        z = encode(*a)
        time.sleep(0.02)
        with lock:
            live[0] -= 1
        return z

    tr._stage_bin, tr._encode = counting_stage, slow_encode
    tr.embed_stream(init_rgcn(2, RC), iter(GRAPHS), batch_size=2)
    assert tr.embed_stats["microbatches"] == 6
    assert peak[0] == 2
    assert tr.embed_stats["peak_resident_graphs"] <= 2


def test_embed_stage_error_raises_and_leaves_no_stager():
    tr = _embedder(True, depth=2)
    stage_bin, n = tr._stage_bin, [0]

    def failing(*a):
        n[0] += 1
        if n[0] == 2:
            raise RuntimeError("pack failed")
        return stage_bin(*a)

    tr._stage_bin = failing
    with pytest.raises(RuntimeError, match="pack failed"):
        tr.embed(init_rgcn(2, RC), GRAPHS, batch_size=4)
    assert not _stagers()


def test_embed_stream_under_fast_thread_switches():
    """The worker's LRU touches of the embedding cache and the consumer's
    inserts interleave at a 1 us switch interval over a stream that
    repeats every graph: the embeddings and the hit counts stay those of
    inline staging."""
    import sys

    params = init_rgcn(2, RC)
    stream = GRAPHS * 3
    on, off = _embedder(True), _embedder(False)
    off_z = off.embed_stream(params, iter(stream), batch_size=2)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.monotonic()
        on_z = on.embed_stream(params, iter(stream), batch_size=2)
        assert time.monotonic() - t0 < 60
    finally:
        sys.setswitchinterval(old)
    np.testing.assert_array_equal(on_z, off_z)
    for k in ("cache_hits", "encoded", "microbatches"):
        assert on.embed_stats[k] == off.embed_stats[k], k
    assert on.embed_stats["encoded"] == len(GRAPHS)
    assert not _stagers()
