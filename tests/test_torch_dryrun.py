"""The port's one-card dry run against the JAX package, on the CPU:
``models/specs.py`` (shapes and dtypes equal to JAX's for every arch x
shape), ``launch/roofline.py`` (JAX's terms after the change of peaks, and
the terms at the H100's), ``launch/steps.py``'s shape-only trees,
``launch/mesh.py`` (one card; wider meshes raise), and ``launch/dryrun.py``
(argument bytes equal to a real init's, FLOPs equal to a closed-form count,
no kernel launched and no plain version run, the CLI's record keys).

Nothing here allocates a full-size tensor: the port's specs are ``meta``
tensors and JAX's come from ``jax.eval_shape``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.config import SHAPES as J_SHAPES
from repro.configs import get_arch as j_get_arch
from repro.launch.roofline import roofline_terms as j_roofline_terms
from repro.models import specs as j_specs
from repro_torch.config import (
    SHAPES, ShapeConfig, TrainConfig,
)
from repro_torch.configs import get_arch, list_archs, smoke_arch
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import dryrun, mesh, roofline
from repro_torch.launch import steps as steps_mod
from repro_torch.models import specs
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import tree_leaves

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
#: the keys of JAX's dry-run record (``repro/launch/dryrun.py``'s
#: ``lower_cell``)
JAX_RECORD_KEYS = {
    "arch", "shape", "multi_pod", "status", "num_devices", "lower_s",
    "compile_s", "memory", "cost_scanned", "cost", "collectives",
    "model_flops", "params_total", "params_active", "roofline",
}
JAX_MEMORY_KEYS = {"argument_bytes_per_device", "output_bytes_per_device",
                   "temp_bytes_per_device", "code_bytes"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one intra-op thread: several test processes on one host
    slow down by oversubscribing the cores with spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shapes_dtypes(flat: dict) -> dict:
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in flat.items()}


def _flat(tree, prefix="") -> dict:
    """{"a/b/c": leaf} of a nested dict (either package's)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list_archs())
def test_specs_equal_jax_for_every_shape(arch):
    """batch_specs, batch_axes_tree and decode_state_specs: the same keys,
    shapes and dtypes as JAX's for all four shapes, every tensor on
    ``meta``; the decode state's index is the host int 0 where JAX's is an
    int32 scalar."""
    cfg, jcfg = get_arch(arch), j_get_arch(arch)
    for name in SHAPES:
        shape, jshape = SHAPES[name], J_SHAPES[name]
        got = specs.batch_specs(cfg, shape)
        want = j_specs.batch_specs(jcfg, jshape)
        assert all(t.device.type == "meta" for t in got.values())
        assert _shapes_dtypes(got) == _shapes_dtypes(want), name
        assert specs.batch_axes_tree(cfg, shape) == \
            j_specs.batch_axes_tree(jcfg, jshape)
        state = specs.decode_state_specs(cfg, shape)
        jstate = j_specs.decode_state_specs(jcfg, jshape)
        assert state["index"] == 0 and isinstance(state["index"], int)
        assert jstate["index"].shape == () and \
            jstate["index"].dtype == np.int32
        flat, jflat = _flat(state["caches"]), _flat(jstate["caches"])
        assert all(t.device.type == "meta" for t in flat.values())
        assert _shapes_dtypes(flat) == _shapes_dtypes(jflat), name
        inputs = specs.input_specs(cfg, shape)
        assert set(inputs) == set(j_specs.input_specs(jcfg, jshape))


@pytest.mark.parametrize("arch", ["llama3.2-3b", "jamba-v0.1-52b"])
def test_abstract_params_and_train_state_specs_match_a_real_init(arch):
    """abstract_params and train_state_specs: meta tensors of a real
    init's (and adamw_init's) shapes and dtypes, bf16 moments with
    opt_dtype bfloat16, and the same keys as JAX's abstract params."""
    cfg = smoke_arch(arch)
    tcfg = TrainConfig(opt_dtype="bfloat16")
    real = adamw_init(tf.init_params(cfg, torch.Generator().manual_seed(0),
                                     device="cpu"), tcfg)
    meta = steps_mod.train_state_specs(cfg, tcfg)
    for name in ("params", "mu", "nu"):
        a, b = tree_leaves(getattr(meta, name)), tree_leaves(getattr(real,
                                                                     name))
        assert [(t.shape, t.dtype) for t in a] == [(t.shape, t.dtype)
                                                   for t in b]
        assert all(t.device.type == "meta" for t in a)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(meta.mu))
    assert meta.step == 0
    from repro.configs import smoke_arch as j_smoke_arch
    from repro.launch.steps import abstract_params as j_abstract_params

    jflat = _flat(j_abstract_params(j_smoke_arch(arch)))
    pflat = _flat(steps_mod.abstract_params(cfg))
    assert _shapes_dtypes(pflat) == _shapes_dtypes(jflat)


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------


def test_roofline_terms_agree_with_jax_up_to_the_peaks():
    """A JAX record (no flops_by_dtype): the same keys; the compute term
    times the bf16 peak, the memory term times the bandwidth and the
    collective term times the link rate equal JAX's after its own peaks
    (NVLink 4's 450 GB/s a direction for JAX's ICI link); the useful-FLOP
    ratio equal."""
    from repro.launch import roofline as j_roofline

    rec = {
        "num_devices": 256,
        "cost": {"flops_per_device": 3.1e13, "bytes_per_device": 4.7e10},
        "collectives": {"per_device_bytes": 2.5e9},
        "model_flops": 3.1e13 * 256 * 0.37,
    }
    got, want = roofline.roofline_terms(rec), j_roofline_terms(rec)
    assert set(got) == set(want)
    assert got["compute_s"] * roofline.PEAK_BF16_S == pytest.approx(
        want["compute_s"] * j_roofline.PEAK_FLOPS)
    assert got["memory_s"] * roofline.PEAK_BYTES_S == pytest.approx(
        want["memory_s"] * j_roofline.HBM_BW)
    assert got["useful_flop_ratio"] == pytest.approx(
        want["useful_flop_ratio"])
    assert got["hlo_flops_total"] == want["hlo_flops_total"]
    assert got["collective_s"] * roofline.NVLINK_BYTES_S == pytest.approx(
        want["collective_s"] * j_roofline.LINK_BW)
    assert got["collective_s"] == pytest.approx(2.5e9 / 450e9)


def test_roofline_terms_math():
    """The port's version of JAX's test, at the H100's peaks: one second
    of each dtype's work, one second of bytes; one card moves no
    collective bytes."""
    rec = {
        "num_devices": 1,
        "cost": {"flops_per_device": 989e12, "bytes_per_device": 3.35e12,
                 "flops_by_dtype": {"bfloat16": 989e12}},
        "collectives": {"per_device_bytes": 0},
        "model_flops": 989e12 * 0.5,
    }
    rl = roofline.roofline_terms(rec)
    assert rl["compute_s"] == pytest.approx(1.0)
    assert rl["memory_s"] == pytest.approx(1.0)
    assert rl["collective_s"] == 0.0
    assert rl["useful_flop_ratio"] == pytest.approx(0.5)
    assert rl["step_time_bound_s"] == pytest.approx(1.0)
    rec["cost"]["flops_by_dtype"] = {"bfloat16": 989e12, "float32": 67e12,
                                     "tf32x3": 495e12 / 3}
    rl = roofline.roofline_terms(rec)
    assert rl["compute_s"] == pytest.approx(3.0)
    assert rl["dominant"] == "compute"
    assert rl["roofline_fraction"] == pytest.approx(1.0)
    assert roofline.bound(3.35e9, 1.0) == (pytest.approx(1.0), "bytes")
    assert roofline.bound(0.0, 989e9, roofline.PEAK_BF16_S) == (
        pytest.approx(1.0), "operations")
    assert roofline.tf32x3_bound(1.0, 165e9) == (pytest.approx(1.0),
                                                  "operations")


def test_summarize_rows(tmp_path):
    """summarize gives JAX's rows of an artifact with an ok and a skipped
    cell."""
    from repro.launch.roofline import summarize as j_summarize

    rec = {"arch": "a", "shape": "s", "multi_pod": False, "status": "ok",
           "num_devices": 1,
           "cost": {"flops_per_device": 1e12, "bytes_per_device": 1e9},
           "collectives": {"per_device_bytes": 0}, "model_flops": 5e11}
    rec["roofline"] = roofline.roofline_terms(rec)
    skip = {"arch": "b", "shape": "long_500k", "multi_pod": False,
            "status": "skipped", "reason": "pure full-attention arch"}
    path = tmp_path / "dr.json"
    path.write_text(json.dumps([rec, skip]))
    rows = roofline.summarize(str(path))
    assert rows == j_summarize(str(path))
    assert rows[0][3] == "ok" and "-> compute" in rows[0][4]
    assert rows[1][3] == "skipped"


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------


def test_meshes_describe_one_card_and_raise_wider():
    prod = mesh.make_production_mesh()
    assert prod.shape == (1, 1) and prod.axes == ("data", "model")
    assert prod.size == 1 and prod.devices[0].type == "cuda"
    # the multi-pod mesh lies over the ranks of a 512-rank group
    with pytest.raises(ValueError, match="512 ranks"):
        mesh.make_production_mesh(multi_pod=True)
    cpu = mesh.make_debug_mesh(1, 1, device_type="cpu")
    assert cpu.shape == (1, 1) and cpu.devices == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="A9b"):
        mesh.make_debug_mesh(2, 1, device_type="cpu")
    with pytest.raises(ValueError, match="A9b"):
        mesh.make_debug_mesh(1, 2, device_type="cpu")
    assert mesh.make_data_mesh(0, device_type="cpu").shape == (1, 1)
    with pytest.raises(ValueError, match="A9b"):
        mesh.make_data_mesh(2, device_type="cpu")
    assert list(mesh.widths("cpu")) == [1]
    cards = torch.cuda.device_count()
    data = mesh.make_data_mesh(cards, device_type="cuda") if cards else None
    if data is not None:                  # a host with cards: a prefix
        assert data.devices == tuple(mesh.visible_devices("cuda"))
    with pytest.raises(ValueError):
        mesh.make_data_mesh(cards + 1)
    with pytest.raises(ValueError):
        mesh.visible_devices("meta")


# ---------------------------------------------------------------------------
# dry run
# ---------------------------------------------------------------------------


def _real_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-780m"])
def test_argument_bytes_equal_a_real_init(arch):
    """At smoke width, a prefill cell's argument bytes are those of the
    compute-dtype params and the batch drawn on the CPU, and a train
    cell's those of adamw_init's state and the batch."""
    cfg = smoke_arch(arch)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    pre = ShapeConfig("pre", 512, 2, "prefill")
    rec = dryrun.lower_one(cfg, pre)
    want = _real_bytes(tree_leaves(tf.compute_params(cfg, params))) \
        + 2 * 512 * 4
    assert rec["memory"]["argument_bytes_per_device"] == want
    train = ShapeConfig("tr", 256, 2, "train")
    tcfg = TrainConfig()
    rec = dryrun.lower_one(cfg, train, tcfg)
    state = adamw_init(params, tcfg)
    want = _real_bytes(tree_leaves(state.params) + tree_leaves(state.mu)
                       + tree_leaves(state.nu)) + 2 * (2 * 256 * 4)
    assert rec["memory"]["argument_bytes_per_device"] == want
    assert rec["memory"]["temp_bytes_per_device"] > 0
    assert rec["memory"]["fits"]


def _mm(m, n, k):
    return 2 * m * n * k


def test_flops_equal_a_closed_form_count():
    """Prefill of a two-layer smoke llama and mamba: the dry run's FLOPs are
    each projection's 2mnk, the LM head on the last position, plus K7's /
    K8's own operation counts (``flash_attention_cost``,
    ``ssd_intra_chunk_cost``), and the SSD's inter-chunk product."""
    B, S = 2, 512
    shape = ShapeConfig("pre", S, B, "prefill")
    cfg = smoke_arch("llama3.2-3b").replace(num_layers=2)
    D, H, K, hd, F, V = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                         cfg.head_dim, cfg.d_ff, cfg.vocab_size)
    n = B * S
    layer = (_mm(n, H * hd, D) + 2 * _mm(n, K * hd, D) + _mm(n, D, H * hd)
             + 3 * _mm(n, F, D))
    k7 = fa_ops.flash_attention_cost(B, S, K, H // K, hd, 4)[0]
    rec = dryrun.lower_one(cfg, shape)
    assert rec["cost"]["flops_per_device"] == 2 * (layer + k7) + _mm(B, V, D)
    assert rec["cost"]["flops_by_dtype"] == {
        "float32": rec["cost"]["flops_per_device"]}
    assert rec["cost"]["kernels"]["flash_attention"]["calls"] == 2

    cfg = smoke_arch("mamba2-780m").replace(num_layers=2)
    D, din, ds, nh, hp, Q, cw, V = (
        cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
        cfg.ssm_headdim, cfg.ssm_chunk, cfg.ssm_conv, cfg.vocab_size)
    nc = S // Q
    layer = (_mm(n, 2 * din + 2 * ds + nh, D) + _mm(n, D, din)
             + _mm(B * (cw - 1), din + 2 * ds, D)          # the conv tails
             + _mm(B * nc * Q, nh * hp, ds))                # inter-chunk
    k8 = ssd_ops.ssd_intra_chunk_cost(B, nc, Q, nh, hp, ds)[0]
    rec = dryrun.lower_one(cfg, shape)
    flops = rec["cost"]["flops_by_dtype"]
    assert flops["float32"] == 2 * layer + _mm(B, V, D)
    assert flops["tf32x3"] == 2 * k8
    assert rec["cost"]["kernels"]["ssd_intra_chunk"]["calls"] == 2


def _refuse(*a, **k):
    raise AssertionError("a meta run reached a plain version or a launch")


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-780m"])
def test_meta_runs_launch_nothing_and_run_no_plain_version(arch,
                                                           monkeypatch):
    """A train cell (the forward kernel and its backward) on meta: no
    wrapper's launch count moves, neither the plain versions nor
    ``kernels.launch`` is called, and each kernel is tallied with its own
    formula: the backward once per layer, the forward once per layer and
    again in the recompute of JAX's default remat."""
    for mod, names in ((fa_ops, ("flash_attention_plain",
                                 "flash_attention_bwd_plain", "launch")),
                       (ssd_ops, ("ssd_intra_chunk_plain",
                                  "ssd_intra_chunk_bwd_plain", "launch"))):
        for name in names:
            monkeypatch.setattr(mod, name, _refuse)
    wrappers = (fa_ops.flash_attention, fa_ops.flash_attention_bwd,
                ssd_ops.ssd_intra_chunk, ssd_ops.ssd_intra_chunk_bwd)
    before = [w.launches for w in wrappers]
    cfg = smoke_arch(arch).replace(num_layers=2)
    B, S = 2, 256
    rec = dryrun.lower_one(cfg, ShapeConfig("tr", S, B, "train"))
    assert [w.launches for w in wrappers] == before
    kern = rec["cost"]["kernels"]
    fwd = 2 * (2 if cfg.remat else 1)       # 2 layers, and the recompute
    if arch.startswith("llama"):
        K, G, hd = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, \
            cfg.head_dim
        assert {k: v["calls"] for k, v in kern.items()} == {
            "flash_attention": fwd, "flash_attention_bwd": 2}
        assert kern["flash_attention_bwd"]["flops"] == 2 * \
            fa_ops.flash_attention_bwd_cost(B, S, K, G, hd, 4)[0]
    else:
        Q = cfg.ssm_chunk
        dims = (B, S // Q, Q, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state)
        assert {k: v["calls"] for k, v in kern.items()} == {
            "ssd_intra_chunk": fwd, "ssd_intra_chunk_bwd": 2}
        assert kern["ssd_intra_chunk_bwd"]["bytes"] == 2 * \
            ssd_ops.ssd_intra_chunk_bwd_cost(*dims)[1]


def test_a_meta_counter_holds_storages_not_tensors():
    """The temp peak counts a storage once however many views share it,
    frees what dies, and holds a tensor autograd saved until its graph is
    freed (4 KiB a 1024-element float32 tensor)."""
    a = torch.empty(1024, device="meta")
    counter = dryrun.StepCounter([a])
    with counter:
        b = a * 2.0
        views = (b[:512], b.view(32, 32), b.view(-1)[::2])
        c = b + 1.0
        del b, views
        e = c * 3.0                     # b is gone: c and e, 8 KiB
    assert counter.peak == 8192
    assert counter.bytes == 6 * 4096    # three ops, 4 KiB in and out each
    del c, e

    a.requires_grad_(True)
    counter = dryrun.StepCounter([a])
    with counter:
        x = a.exp()                     # saved by exp's backward
        s = x.sum()
        del x
        w = a * 3.0                     # x, s and w live: 8 KiB + 4 bytes
        del s, w                        # the graph and x go
        big = torch.empty(2048, device="meta")
    assert counter.peak == 8192 + 4
    del big


def test_dryrun_cli_record_keys(tmp_path):
    """JAX's smoke cell through the CLI: exit 0, one ok record with JAX's
    keys (memory and cost hold JAX's and more), one card, nothing
    compiled; the multi-pod flags record the decode cell on JAX's meshes
    (its decode state by JAX's specs among the arguments)."""
    out = tmp_path / "dr.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2-780m", "--shape", "long_500k", "--out", str(out)],
        capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    (rec,) = json.loads(out.read_text())
    assert rec["status"] == "ok" and set(rec) == JAX_RECORD_KEYS
    assert JAX_MEMORY_KEYS <= set(rec["memory"])
    assert {"flops_per_device", "bytes_per_device", "flops_by_dtype"} <= \
        set(rec["cost"])
    assert rec["num_devices"] == 1 and rec["compile_s"] is None
    assert rec["memory"]["fits"] is True
    assert rec["roofline"]["dominant"] == "memory"
    for flag, n in (("--multi-pod", 1), ("--both-meshes", 2)):
        path = tmp_path / f"x{n}.json"
        assert dryrun.main(["--arch", "mamba2-780m", "--shape", "long_500k",
                            "--out", str(path), flag]) == 0
        recs = json.loads(path.read_text())
        assert len(recs) == n and all(r["status"] == "ok" for r in recs)
        assert {r["num_devices"] for r in recs} == (
            {512} if n == 1 else {256, 512})
    rec = dryrun.lower_cell("mamba2-780m", "long_500k", multi_pod=True)
    assert rec["status"] == "ok" and "reason" not in rec
    mem = rec["memory"]
    assert mem["decode_state_bytes_per_device"] > 0
    assert mem["optimizer_bytes_per_device"] == 0
    assert mem["argument_bytes_per_device"] == (
        mem["params_bytes_per_device"] + mem["batch_bytes_per_device"]
        + mem["decode_state_bytes_per_device"])
    assert dryrun.lower_cell("llama3.2-3b", "long_500k")["status"] == \
        "skipped"
    assert dryrun.lower_cell("llama3.2-3b", "long_500k", pod=True)[
        "status"] == "skipped"


@pytest.mark.parametrize("multi_pod", [False, True])
def test_serving_mesh_records(multi_pod):
    """llama3.2-3b's serving cells on JAX's (16, 16) and (2, 16, 16)
    meshes: decode_32k holds nb x 8 x 2048 x 8 x 128 x 2 B of each of k
    and v a device on (16, 16) (its 128 rows over 16 data ranks, the
    32768 positions over 16 model ranks), half the rows on (2, 16, 16);
    prefill_32k holds no decode state; both carry the plan's collective
    bytes, and no record says training only."""
    cfg = get_arch("llama3.2-3b")
    rows = 4 if multi_pod else 8
    rec = dryrun.lower_cell("llama3.2-3b", "decode_32k", multi_pod=multi_pod,
                            pod=not multi_pod)
    assert rec["status"] == "ok"
    mem = rec["memory"]
    assert mem["decode_state_bytes_per_device"] == \
        2 * cfg.num_blocks * rows * 2048 * 8 * 128 * 2
    assert mem["batch_bytes_per_device"] == rows * 4
    coll = rec["collectives"]
    assert coll["per_device_bytes"] == sum(coll["by_kind_bytes"].values())
    assert coll["by_kind_bytes"]["attention"] > 0
    pre = dryrun.lower_cell("llama3.2-3b", "prefill_32k",
                            multi_pod=multi_pod, pod=not multi_pod)
    assert pre["status"] == "ok"
    assert pre["memory"]["decode_state_bytes_per_device"] == 0
    assert pre["memory"]["params_bytes_per_device"] == \
        mem["params_bytes_per_device"]
    assert pre["collectives"]["by_kind_bytes"]["attention"] == 0
    assert "training only" not in json.dumps([rec, pre])
