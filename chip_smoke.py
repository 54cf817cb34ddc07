#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each reported on its own lines:

1. device   the card's name and power limit (nvidia-smi) and torch's view;
2. build    the CUDA kernels built from ``src/repro_torch/csrc`` with nvcc
            for sm_90a, with the build time and ptxas's register /
            shared-memory report;
3. kernels  every kernel of the serving path (K1 rgcn_fused, K2
            kmeans_assign_fused, K3 silhouette_sums) against its plain
            PyTorch version on the card at the main-path shapes, with its
            time, the plain version's, one library call's where there is
            one, and the least time the card could take (bound);
4. reference the JAX-trained encoder committed in
            ``src/repro_torch/assets/reference_phi2.npz``: the card embeds
            and plans phi-2 and cfd and must match the JAX results stored
            there (embeddings 1e-4 relative, equal K and representatives,
            eq. 5 / eq. 6 within 1e-6);
5. serve    a PlanService answers submit_program for cfd, phi-2 and nw with
            that encoder; every kernel's launch count (zeroed just before)
            must be > 0 and no request may fail.

Any mismatch or exception exits non-zero.  The last lines are the kernel
table as one JSON object, the card's name and power limit, and
``{"ok": true, "device": {...}}``.  It needs one CUDA card and the
repository's ``src/`` beside it; it imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "src" / "repro_torch" / "assets" / "reference_phi2.npz"

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, float32
# outside the tensor cores (the kernels here run float32 FMAs)
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12

KERNEL_TOL = 1e-5       # max |kernel - plain| / max |plain|
EMBED_TOL = 1e-4        # card embeddings vs the JAX fixture, relative
METRIC_TOL = 1e-6       # eq. 5 / eq. 6 vs the JAX fixture, absolute


def log(*a):
    print(*a, flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def time_ms(fn, iters, warmup=3):
    """Host-visible time of one call: CUDA events around ``iters`` calls
    (launch overhead and any host work in the call included)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters, own=()):
    """Device time of one call from torch.profiler (CUPTI): (all kernels
    and copies the call runs, the kernels whose names contain one of
    ``own``), in ms per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = mine = 0.0
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        t = ev.self_cuda_time_total if t is None else t
        total += t
        if any(o in ev.key for o in own):
            mine += t
    if total <= 0:
        log("[kernels] torch.profiler recorded no device time: reporting "
            "CUDA-event call time instead")
        t = time_ms(fn, iters)
        return t, t
    return total / 1e3 / iters, mine / 1e3 / iters


def bound(bytes_, ops):
    t_bytes, t_ops = bytes_ / PEAK_BYTES_S, ops / PEAK_F32_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def rel_err(got, want):
    got, want = got.float(), want.float()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    return err, err / max(scale, 1e-30)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi_line = smi.splitlines()[0]
    log(f"[device] nvidia-smi: {smi_line}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return smi_line


def phase_build():
    from repro_torch import kernels

    t0 = time.perf_counter()
    kernels.library()
    info = kernels.BUILD_INFO
    log(f"[build] {len(list(kernels.CSRC.glob('*.cu')))} sources -> "
        f"{info['path']} in {info['seconds']:.2f} s "
        f"(load {time.perf_counter() - t0:.2f} s, cached={info['cached']})")
    for line in info.get("ptxas", "").splitlines():
        line = line.strip()
        if line.startswith("==") or "Used" in line or "spill" in line \
                or "Compiling entry" in line:
            log(f"[build] {line}")


def _main_path_batch():
    """The first micro-batch ``embed`` packs for phi-2's distinct graphs
    (budget 4096 nodes / 8192 edges): the encoder's main-path bucket."""
    from repro_torch.core.batching import (
        bucket_size, graph_content_hash, pack_graphs, plan_microbatches,
    )
    from repro_torch.core.sampler import GCLSampler
    from repro_torch.tracing.programs import get_program

    seen = {}
    for g in GCLSampler(device="cpu").iter_graphs(get_program("phi-2")):
        seen.setdefault(graph_content_hash(g), g)
    graphs = list(seen.values())
    first = [graphs[i] for i in plan_microbatches(graphs)[0]]
    packed, _ = pack_graphs(first, pad_graphs_to=bucket_size(len(first), 8))
    return packed


def phase_kernels(rows, dev):
    import numpy as np
    import torch

    from repro_torch.kernels.kmeans_assign.ops import (
        kmeans_assign_fused, kmeans_assign_fused_plain, silhouette_sums,
        silhouette_sums_plain,
    )
    from repro_torch.kernels.rgcn_fused.ops import (
        rgcn_fused_agg_flat, rgcn_fused_agg_flat_plain,
    )

    rng = np.random.default_rng(0)

    # ---- K1 at the main path's packed bucket, every layer shape ----------
    packed = _main_path_batch()
    P, Q = len(packed["node_mask"]), len(packed["edge_mask"])
    src = torch.from_numpy(packed["edge_src"]).to(dev)
    dst = torch.from_numpy(packed["edge_dst"]).to(dev)
    wnorm = torch.from_numpy(packed["edge_mask"] * packed["edge_norm"]).to(dev)
    etype = torch.from_numpy(packed["edge_type"]).long()
    node_mask = torch.from_numpy(packed["node_mask"]).to(dev)
    q_live = int((wnorm != 0).sum())
    rows_live = int(torch.unique(dst[wnorm != 0]).numel())
    log(f"[kernels] K1 batch: P={P} Q={Q} live edges={q_live} "
        f"destination rows={rows_live}")
    k1 = None
    for D, O in ((64, 128), (128, 128), (128, 256)):
        for dt in (torch.float32, torch.bfloat16):
            nb = 2
            comb = torch.from_numpy(rng.standard_normal((4, nb))
                                    .astype(np.float32))
            coef = comb[etype].contiguous().to(dev)
            h = (torch.from_numpy(rng.standard_normal((P, D))
                                  .astype(np.float32)).to(dev)
                 * node_mask[:, None]).to(dt).contiguous()
            basis = torch.from_numpy((rng.standard_normal((nb, D, O))
                                      / np.sqrt(D)).astype(np.float32)).to(dev)
            args = (h, basis, src, dst, coef, wnorm, P)
            got = rgcn_fused_agg_flat(*args)
            torch.cuda.synchronize()
            want = rgcn_fused_agg_flat_plain(*args)
            err, rel = rel_err(got, want)
            require(rel <= KERNEL_TOL,
                    f"K1 D={D} O={O} {dt}: rel err {rel:.3e} > {KERNEL_TOL}")
            call_ms = time_ms(lambda: rgcn_fused_agg_flat(*args), 50)
            wrap_ms, ms = device_ms(lambda: rgcn_fused_agg_flat(*args), 20,
                                    own=("rgcn_fused_flat_kernel",))
            plain_ms, _ = device_ms(
                lambda: rgcn_fused_agg_flat_plain(*args), 20)
            esz = h.element_size()
            bytes_ = (P * D * esz + Q * 4 * 2 + Q * nb * 4 + Q * 4
                      + nb * D * O * 4 + P * O * 4)
            ops = 2 * q_live * nb * D + 2 * rows_live * nb * D * O
            b_ms, b_by = bound(bytes_, ops)
            dname = "f32" if dt == torch.float32 else "bf16"
            log(f"[kernels] K1 rgcn_fused D={D} O={O} h={dname}: "
                f"max_abs_err {err:.3e} rel {rel:.3e} (tol {KERNEL_TOL}) "
                f"kernel device ms {ms:.4f} (wrapper device ms {wrap_ms:.4f}, "
                f"call ms {call_ms:.4f}) plain device ms {plain_ms:.4f} "
                f"bound_us {b_ms * 1e3:.2f} ({b_by})")
            if (D, O, dt) == (128, 256, torch.float32):
                k1 = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by, library_ms=None)
    rows.append(("rgcn_fused_flat", "src/repro_torch/csrc/rgcn_fused.cu",
                 "src/repro/kernels/rgcn_fused/kernel.py:107",
                 rgcn_fused_agg_flat, k1))

    # ---- K2 / K3 at the sweep's main-path shape (cfd: n=2425 -> 4096) ----
    n, d, k, n_real, n_sil = 4096, 256, 48, 2425, 1200
    centers = rng.standard_normal((k, d)).astype(np.float32) * 5
    lab_true = rng.integers(0, k, n)
    x_np = centers[lab_true] + rng.standard_normal((n, d)).astype(np.float32)
    x = torch.from_numpy(x_np.astype(np.float32)).to(dev)
    cent = torch.from_numpy(centers + 0.1 * rng.standard_normal((k, d))
                            .astype(np.float32)).to(dev)
    k_live = 40
    cmask = (torch.arange(k, device=dev) < k_live).float()
    pmask = (torch.arange(n, device=dev) < n_real).float()
    args = (x, cent, cmask, pmask)
    got = kmeans_assign_fused(*args)
    torch.cuda.synchronize()
    want = kmeans_assign_fused_plain(*args)
    require(torch.equal(got[0], want[0]), "K2 labels differ from plain")
    errs = [rel_err(g, w) for g, w in zip(got[1:], want[1:])]
    err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
    require(rel <= KERNEL_TOL, f"K2: rel err {rel:.3e} > {KERNEL_TOL}")
    call_ms = time_ms(lambda: kmeans_assign_fused(*args), 200)
    _, ms = device_ms(lambda: kmeans_assign_fused(*args), 50,
                      own=("kmeans_assign_kernel", "kmeans_reduce_kernel"))
    plain_ms, _ = device_ms(lambda: kmeans_assign_fused_plain(*args), 50)

    def k2_library():
        dist = torch.cdist(x, cent) ** 2
        dist = torch.where(cmask[None, :] > 0, dist, float("inf"))
        return torch.min(dist, dim=1)

    lib_ms, _ = device_ms(k2_library, 50)
    bytes_ = n * d * 4 + k * d * 4 + k * 4 + n * 4 + n * 8 + k * d * 4 + k * 4
    ops = 2 * n * k_live * d + 2 * n * d + n_real * d
    b_ms, b_by = bound(bytes_, ops)
    log(f"[kernels] K2 kmeans_assign_fused n={n} d={d} k={k}: labels equal, "
        f"max_abs_err {err:.3e} rel {rel:.3e} (tol {KERNEL_TOL}) kernel "
        f"device ms {ms:.4f} (call ms {call_ms:.4f}) plain device ms "
        f"{plain_ms:.4f} library device ms {lib_ms:.4f} (cdist^2 + mask + "
        f"min) bound_us {b_ms * 1e3:.2f} ({b_by})")
    rows.append(("kmeans_assign_fused", "src/repro_torch/csrc/kmeans_assign.cu",
                 "src/repro/kernels/kmeans_assign/kernel.py:113",
                 kmeans_assign_fused,
                 dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                      bound_by=b_by, library_ms=lib_ms)))

    sil = torch.zeros(n, device=dev)
    sil[torch.from_numpy(rng.choice(n_real, n_sil, replace=False)).to(dev)] = 1
    onehot = (torch.nn.functional.one_hot(want[0].long(), k).float()
              * sil[:, None]).contiguous()
    got = silhouette_sums(x, onehot)
    torch.cuda.synchronize()
    want3 = silhouette_sums_plain(x, onehot)
    err, rel = rel_err(got, want3)
    require(rel <= KERNEL_TOL, f"K3: rel err {rel:.3e} > {KERNEL_TOL}")
    call_ms = time_ms(lambda: silhouette_sums(x, onehot), 20)
    _, ms = device_ms(lambda: silhouette_sums(x, onehot), 10,
                      own=("silhouette_sums_kernel", "sqnorm_kernel"))
    plain_ms, _ = device_ms(lambda: silhouette_sums_plain(x, onehot), 10)
    lib_ms, _ = device_ms(lambda: torch.cdist(x, x) @ onehot, 10)
    j_live = int((onehot != 0).any(1).sum())
    nnz = int((onehot != 0).sum())
    bytes_ = n * d * 4 + n * k * 4 * 2
    ops = 2 * n * j_live * d + 2 * n * nnz
    b_ms, b_by = bound(bytes_, ops)
    log(f"[kernels] K3 silhouette_sums n={n} d={d} k={k} live rows "
        f"{j_live}: max_abs_err {err:.3e} rel {rel:.3e} (tol {KERNEL_TOL}) "
        f"kernel device ms {ms:.4f} (call ms {call_ms:.4f}) plain device ms "
        f"{plain_ms:.4f} library device ms {lib_ms:.4f} (cdist @ onehot) "
        f"bound_us {b_ms * 1e3:.2f} ({b_by})")
    rows.append(("silhouette_sums", "src/repro_torch/csrc/silhouette_sums.cu",
                 "src/repro/kernels/kmeans_assign/kernel.py:173",
                 silhouette_sums,
                 dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                      bound_by=b_by, library_ms=lib_ms)))


def _reference_method(dev):
    import numpy as np

    from repro_torch.sampling import Artifacts, get_method

    with np.load(FIXTURE) as z:
        ref = {k: z[k] for k in z.files}
    params = {k[len("param:"):]: v for k, v in ref.items()
              if k.startswith("param:")}
    method = get_method("gcl", device=dev)
    method.adopt(Artifacts("gcl", "phi-2", "jax", payload={"params": params},
                           meta={"trained_on": "phi-2"}))
    return method, ref


def phase_reference(dev):
    import numpy as np

    from repro_torch.sampling import evaluate
    from repro_torch.tracing.programs import get_program

    method, ref = _reference_method(dev)
    for name in ("phi-2", "cfd"):
        t0 = time.perf_counter()
        prog = get_program(name)
        art = method.prepare(prog)
        emb = np.asarray(art.payload["embeddings"])
        index = ref[f"{name}:index"]
        want = ref[f"{name}:emb_distinct"]
        firsts = [int(np.argmax(index == i)) for i in range(len(want))]
        got = emb[firsts]
        require(np.array_equal(emb, got[index]),
                f"{name}: embeddings of identical graphs differ")
        err = float(np.abs(got - want).max()) / float(np.abs(want).max())
        require(err <= EMBED_TOL,
                f"{name}: embeddings rel err {err:.3e} > {EMBED_TOL}")
        plan = method.plan(prog, art)
        ev = evaluate(plan, prog, "P1")
        k_ref, reps_ref = int(ref[f"{name}:k"]), ref[f"{name}:reps"].tolist()
        scores = plan.extra.get("scores", {})
        ref_scores = dict(zip(ref[f"{name}:scores_k"].tolist(),
                              ref[f"{name}:scores"].tolist()))
        gap = max((abs(scores[k] - ref_scores[k]) for k in ref_scores
                   if k in scores), default=0.0)
        log(f"[reference] {name}: n={len(emb)} distinct={len(want)} "
            f"emb rel err {err:.3e} (tol {EMBED_TOL}) K {plan.num_clusters} "
            f"(jax {k_ref}) reps {plan.rep_indices()} eq5 "
            f"{ev.error_pct['cycles']!r} (jax "
            f"{float(ref[f'{name}:error_cycles'])!r}) eq6 {ev.speedup!r} "
            f"(jax {float(ref[f'{name}:speedup'])!r}) max per-K silhouette "
            f"gap {gap:.3e} ({time.perf_counter() - t0:.2f} s)")
        require(plan.num_clusters == k_ref, f"{name}: K differs from JAX")
        require(plan.rep_indices() == reps_ref,
                f"{name}: representatives differ from JAX")
        require(abs(ev.error_pct["cycles"]
                    - float(ref[f"{name}:error_cycles"])) <= METRIC_TOL,
                f"{name}: eq. 5 differs from JAX")
        require(abs(ev.speedup - float(ref[f"{name}:speedup"])) <= METRIC_TOL,
                f"{name}: eq. 6 differs from JAX")


def phase_serve(rows, dev):
    import numpy as np
    import torch

    from repro_torch.sampling import evaluate
    from repro_torch.serving import PlanService
    from repro_torch.tracing.programs import get_program

    method, _ = _reference_method(dev)        # fresh embedding cache
    wrappers = [r[3] for r in rows]
    for w in wrappers:
        w.launches = 0
    with PlanService(device=dev, max_delay_ms=2.0) as svc:
        svc.warmup()
        for name in ("cfd", "phi-2", "nw"):
            prog = get_program(name)
            t0 = time.perf_counter()
            plan = svc.submit_program(method, prog).result(timeout=600)
            lat = time.perf_counter() - t0
            ev = evaluate(plan, prog, "P1")
            require(np.isfinite(ev.error_pct["cycles"])
                    and np.isfinite(ev.speedup), f"{name}: non-finite eval")
            log(f"[serve] {name}: n={len(prog)} latency_s {lat:.3f} K "
                f"{plan.num_clusters} eq5 {ev.error_pct['cycles']!r} eq6 "
                f"{ev.speedup!r} mode {plan.extra.get('mode')}")
        stats = svc.stats()
    launches = {r[0]: r[3].launches for r in rows}
    log(f"[serve] stats {json.dumps(stats, default=str)}")
    log(f"[serve] launches {json.dumps(launches)}")
    require(stats["errors"] == 0 and stats["served"] == 3,
            f"serve: {stats['served']} served, {stats['errors']} errors")
    for name, count in launches.items():
        require(count > 0, f"serve: kernel {name} was never launched")
    profile_request(dev, "cfd")
    return launches


def profile_request(dev, name):
    """One more cold request (fresh encoder cache) under torch.profiler:
    wall time, how much of it the dispatcher's sweep took, and the share of
    it the device was busy (sum of device time over wall)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import PlanService
    from repro_torch.tracing.programs import get_program

    method, _ = _reference_method(dev)
    prog = get_program(name)
    with PlanService(device=dev, max_delay_ms=2.0) as svc:
        svc.warmup()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            svc.submit_program(method, prog).result(timeout=600)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        stats = svc.stats()
    busy = 0.0
    top = []
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        t = ev.self_cuda_time_total if t is None else t
        busy += t
        top.append((t, ev.key, ev.count))
    busy_s = busy / 1e6
    top.sort(reverse=True)
    log(f"[profile] {name}: wall_s {wall:.3f} (profiled) sweep dispatch_s "
        f"{stats['mean_dispatch_ms'] / 1e3:.3f} device busy_s {busy_s:.4f} "
        f"busy share {busy_s / wall:.4f} idle share {1 - busy_s / wall:.4f}")
    for t, key, count in top[:8]:
        log(f"[profile]   {t / 1e3:9.3f} ms  x{count:<6d} {key[:70]}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir() or not FIXTURE.exists():
        print("chip_smoke: src/repro_torch (and its reference fixture) must "
              "sit beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.utils.device import resolve_device

    dev = resolve_device("cuda")              # TF32 off, device bound
    t_all = time.perf_counter()
    smi_line = phase_device()
    t0 = time.perf_counter()
    phase_build()
    log(f"[phase] build {time.perf_counter() - t0:.2f} s")
    rows: list = []
    t0 = time.perf_counter()
    phase_kernels(rows, dev)
    log(f"[phase] kernels {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_reference(dev)
    log(f"[phase] reference {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    launches = phase_serve(rows, dev)
    log(f"[phase] serve {time.perf_counter() - t0:.2f} s")
    log(f"[phase] total {time.perf_counter() - t_all:.2f} s")
    table = {"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": repl,
         "launches": launches[name], "max_abs_err": m["err"], "ms": m["ms"],
         "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
         "bound_by": m["bound_by"], "library_ms": m["library_ms"]}
        for name, source, repl, _, m in rows]}
    print(json.dumps(table))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
