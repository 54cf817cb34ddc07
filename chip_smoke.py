#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each reported on its own lines:

1. device   the card's name and power limit (nvidia-smi) and torch's view;
2. build    the CUDA kernels built from ``src/repro_torch/csrc`` with nvcc
            for sm_90a, with the build time and ptxas's register /
            shared-memory report;
3. kernels  every kernel of the serving and training paths (K1
            rgcn_fused, K2 kmeans_assign_fused, K3 silhouette_sums, K5
            rgcn_spmm_flat, K1b rgcn_fused_bwd) against its plain PyTorch
            version on the card at the main-path shapes (K5 / K1b also at
            the training batch's bucket), with its time, the plain
            version's, one library call's where there is one, and the least
            time the card could take (bound);
4. reference the JAX-trained encoder committed in
            ``src/repro_torch/assets/reference_phi2.npz``: the card embeds
            and plans phi-2 and cfd and must match the JAX results stored
            there (embeddings 1e-4 relative, equal K and representatives,
            eq. 5 / eq. 6 within 1e-6);
5. serve    a PlanService answers submit_program for cfd, phi-2 and nw with
            that encoder; the serving kernels' launch counts (zeroed just
            before) must be > 0 and no request may fail;
6. train    three training steps of the full-width encoder on the card
            against the same steps on the CPU with the same draws (loss
            1e-5, parameters 1e-4 relative);
7. resume   a fit interrupted at a checkpoint and resumed against the
            uninterrupted fit, on the card (parameters 1e-5; whether the
            bits are equal is printed);
8. fit      the default fit on phi-2 (120 steps, batch 16, subsample 400):
            losses, validation, steps/s, launches of K1 / K1b / K5, then the
            same fit under torch.profiler for the busy share and top ops;
9. fit+serve a fresh ``gcl`` method with no encoder behind a PlanService:
            submit_program(phi-2) fits its own encoder (prepare), then cfd,
            phi-2 and nw are served with it; K, eq. 5 and eq. 6 are printed
            beside the JAX-trained fixture's (reported, not held equal: the
            draws differ); every kernel's launch count over this run must
            be > 0 and no request may fail.  This is the slice's main path:
            its counts are the ``launches`` of the kernel table.

Any mismatch or exception exits non-zero.  The last lines are the kernel
table as one JSON object, the card's name and power limit, and
``{"ok": true, "device": {...}}``.  It needs one CUDA card and the
repository's ``src/`` beside it; it imports nothing of JAX.
"""

from __future__ import annotations

import functools
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
# Training on the card against the CPU.  The encoder's gradient jumps where
# a pre-activation crosses zero (ReLU), and the card's forward differs from
# the CPU's by ~1e-6, enough to move one element across: on the CPU, one
# such flip moves one basis gradient by 2.5e-3 of its largest element and
# the whole gradient by ~2e-4 of its norm, and three Adam steps later the
# whole parameter vector by ~3e-6 of its norm (zero-initialized biases by
# up to 8e-4 of theirs).  Gradients and parameters are therefore held as
# whole vectors, relative to their norms; per-leaf gaps are printed.
LOSS_TOL = 1e-5         # card vs CPU training loss, relative, every step
GRAD_TOL = 1e-3         # card vs CPU step-0 gradient, relative norm
PARAM_TOL = 1e-4        # card vs CPU parameters after step 3, relative norm
RESUME_TOL = 1e-5       # resumed vs uninterrupted fit on the card, ditto
#: how the fit's device time is split in the report (first match wins)
FIT_SPLIT = (
    ("K1 rgcn_fused_flat_kernel", ("rgcn_fused_flat_kernel",)),
    ("K1b rgcn_fused_bwd_kernel", ("rgcn_fused_bwd_kernel",)),
    ("K5 rgcn_spmm_flat_kernel", ("rgcn_spmm_flat_kernel",)),
    ("CSR views (sort, searchsorted)", ("RadixSort", "radix", "searchsorted",
                                        "Sort")),
    ("matmuls (cuBLAS / CUTLASS)", ("gemm", "Gemm", "cutlass", "sm90_xmma",
                                    "splitKreduce")),
    ("copies and fills", ("Memcpy", "Memset")),
)
#: the kernels the serving path launches (K1-K3); fitting adds K5 and K1b
SERVE_KERNELS = ("rgcn_fused_flat", "kmeans_assign_fused", "silhouette_sums")
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
    _k5_k1b(rows, dev, rng, {"main path": packed,
                             "training bucket": _training_batches(1)[0]})

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


def _training_batches(n_steps):
    """The first ``n_steps`` packed batches of the default fit on phi-2
    (the same subsample, split and selections as ``GCLSampler.train``)."""
    from repro_torch.core.batching import (
        MAX_EDGES_PER_MICROBATCH, MAX_NODES_PER_MICROBATCH, plan_epoch,
    )
    from repro_torch.core.rgcn import RGCNConfig
    from repro_torch.core.train import ContrastiveTrainer

    graphs = _phi2_training_graphs()
    _, _, selections = ContrastiveTrainer(
        RGCNConfig(), device="cpu").split(len(graphs))
    plan = plan_epoch(graphs, selections[:n_steps],
                      max_nodes_per_graph=MAX_NODES_PER_MICROBATCH,
                      max_edges_per_graph=MAX_EDGES_PER_MICROBATCH)
    return [{f: a[i] for f, a in seg.batches.items()}
            for seg in plan.segments for i in range(len(seg))]


def _k5_k1b(rows, dev, rng, batches):
    """K5 and K1b against their plain versions at each batch's shape, h of
    width D in {64, 128} (the layers' input widths), float32 and bfloat16;
    timed at every shape, the table rows from the main path at D = 128,
    float32."""
    import numpy as np
    import torch

    from repro_torch.kernels.rgcn_fused.ops import (
        rgcn_fused_bwd, rgcn_fused_bwd_plain,
    )
    from repro_torch.kernels.rgcn_spmm.ops import (
        rgcn_spmm_flat, rgcn_spmm_flat_plain,
    )

    nb = 2
    k5 = k1b = None
    for label, packed in batches.items():
        P, Q = len(packed["node_mask"]), len(packed["edge_mask"])
        src = torch.from_numpy(packed["edge_src"]).to(dev)
        dst = torch.from_numpy(packed["edge_dst"]).to(dev)
        wnorm = torch.from_numpy(packed["edge_mask"] * packed["edge_norm"]
                                 ).to(dev)
        etype = torch.from_numpy(packed["edge_type"]).long()
        node_mask = torch.from_numpy(packed["node_mask"]).to(dev)
        live = wnorm != 0
        q_live = int(live.sum())
        log(f"[kernels] K5/K1b {label}: P={P} Q={Q} live edges={q_live}")
        for D in (64, 128):
            comb = torch.from_numpy(rng.standard_normal((4, nb))
                                    .astype(np.float32))
            coef = comb[etype].contiguous().to(dev)
            w = (coef * wnorm[:, None]).contiguous()
            h32 = (torch.from_numpy(rng.standard_normal((P, D))
                                    .astype(np.float32)).to(dev)
                   * node_mask[:, None]).contiguous()
            t = torch.from_numpy(rng.standard_normal((P, nb * D))
                                 .astype(np.float32)).to(dev)
            # the library yardstick for K5: one sparse product computing s
            # (rows k*P + v of the (nb*P, P) matrix hold w[e, k] at src_e)
            rows_k = torch.cat([k * P + dst[live].long() for k in range(nb)])
            cols_k = torch.cat([src[live].long()] * nb)
            vals = torch.cat([w[live, k] for k in range(nb)])
            A = torch.sparse_coo_tensor(torch.stack([rows_k, cols_k]), vals,
                                        (nb * P, P)).coalesce().to_sparse_csr()
            for dt in (torch.float32, torch.bfloat16):
                h = h32.to(dt).contiguous()
                dname = "f32" if dt == torch.float32 else "bf16"
                esz = h.element_size()
                # ---- K5 --------------------------------------------------
                got = rgcn_spmm_flat(h, src, dst, w, P)
                torch.cuda.synchronize()
                err, rel = rel_err(got, rgcn_spmm_flat_plain(h, src, dst, w,
                                                             P))
                require(rel <= KERNEL_TOL, f"K5 {label} D={D} {dname}: rel "
                        f"err {rel:.3e} > {KERNEL_TOL}")
                call_ms = time_ms(lambda: rgcn_spmm_flat(h, src, dst, w, P),
                                  50)
                wrap_ms, ms = device_ms(
                    lambda: rgcn_spmm_flat(h, src, dst, w, P), 20,
                    own=("rgcn_spmm_flat_kernel",))
                plain_ms, _ = device_ms(
                    lambda: rgcn_spmm_flat_plain(h, src, dst, w, P), 20)
                lib_ms = None
                if dt == torch.float32:
                    lib = torch.sparse.mm(A, h).reshape(nb, P, D)
                    err_lib, _ = rel_err(lib.permute(1, 0, 2).reshape(P, -1),
                                         got)
                    require(err_lib <= 1e-3 * float(got.abs().max()),
                            f"K5 library yardstick disagrees ({err_lib:.3e})")
                    lib_ms, _ = device_ms(lambda: torch.sparse.mm(A, h), 20)
                bytes_ = P * D * esz + Q * 4 * 2 + Q * nb * 4 + P * nb * D * 4
                ops = 2 * q_live * nb * D
                b_ms, b_by = bound(bytes_, ops)
                lib_txt = (f"{lib_ms:.4f} (sparse.mm)" if lib_ms is not None
                           else "none (no bf16 sparse product)")
                log(f"[kernels] K5 rgcn_spmm_flat {label} D={D} h={dname}: "
                    f"max_abs_err {err:.3e} rel {rel:.3e} (tol {KERNEL_TOL}) "
                    f"kernel device ms {ms:.4f} (wrapper device ms "
                    f"{wrap_ms:.4f}, call ms {call_ms:.4f}) plain device ms "
                    f"{plain_ms:.4f} library device ms {lib_txt} bound_us "
                    f"{b_ms * 1e3:.2f} ({b_by})")
                if (label, D, dt) == ("main path", 128, torch.float32):
                    k5 = dict(err=err, ms=ms, plain_ms=plain_ms,
                              bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
                # ---- K1b -------------------------------------------------
                dh, dcoef = rgcn_fused_bwd(h, t, src, dst, coef, wnorm, P)
                torch.cuda.synchronize()
                want = rgcn_fused_bwd_plain(h, t, src, dst, coef, wnorm, P)
                e1, r1 = rel_err(dh, want[0])
                e2, r2 = rel_err(dcoef, want[1])
                tol_dh = 2 ** -7 if dt == torch.bfloat16 else KERNEL_TOL
                require(r1 <= tol_dh and r2 <= KERNEL_TOL,
                        f"K1b {label} D={D} {dname}: rel err dh {r1:.3e} "
                        f"dcoef {r2:.3e}")
                args = (h, t, src, dst, coef, wnorm, P)
                call_ms = time_ms(lambda: rgcn_fused_bwd(*args), 50)
                wrap_ms, ms = device_ms(lambda: rgcn_fused_bwd(*args), 20,
                                        own=("rgcn_fused_bwd_kernel",))
                plain_ms, _ = device_ms(lambda: rgcn_fused_bwd_plain(*args),
                                        20)
                bytes_ = (2 * P * D * esz + P * nb * D * 4 + Q * 4 * 2
                          + Q * nb * 4 * 2 + Q * 4)
                ops = 4 * q_live * nb * D
                b_ms, b_by = bound(bytes_, ops)
                log(f"[kernels] K1b rgcn_fused_bwd {label} D={D} h={dname}: "
                    f"max_abs_err dh {e1:.3e} rel {r1:.3e} (tol {tol_dh:.1e}) "
                    f"dcoef {e2:.3e} rel {r2:.3e} (tol {KERNEL_TOL}) kernel "
                    f"device ms {ms:.4f} (wrapper device ms {wrap_ms:.4f}, "
                    f"call ms {call_ms:.4f}) plain device ms {plain_ms:.4f} "
                    f"library none (dh and dcoef: no one call) bound_us "
                    f"{b_ms * 1e3:.2f} ({b_by})")
                if (label, D, dt) == ("main path", 128, torch.float32):
                    k1b = dict(err=max(e1, e2), ms=ms, plain_ms=plain_ms,
                               bound_ms=b_ms, bound_by=b_by, library_ms=None)
    rows.append(("rgcn_spmm_flat", "src/repro_torch/csrc/rgcn_spmm.cu",
                 "src/repro/kernels/rgcn_spmm/kernel.py:119",
                 rgcn_spmm_flat, k5))
    rows.append(("rgcn_fused_bwd", "src/repro_torch/csrc/rgcn_fused_bwd.cu",
                 "src/repro/kernels/rgcn_fused/ops.py:47", rgcn_fused_bwd,
                 k1b))


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
    rows = [r for r in rows if r[0] in SERVE_KERNELS]
    for r in rows:
        r[3].launches = 0
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


# ---------------------------------------------------------------------------
# training phases
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _phi2_training_graphs():
    """The phi-2 graphs the default fit trains on (``train_subsample``
    draw), traced once per run."""
    from repro_torch.core.sampler import GCLSampler
    from repro_torch.tracing.programs import get_program

    sampler = GCLSampler(device="cpu")
    prog = get_program("phi-2")
    return sampler.training_graphs(sampler.iter_graphs(prog), len(prog))


def _param_gap(got: dict, want: dict):
    """(largest max|got - want| / max|want| over the leaves, whether every
    bit is equal)."""
    import torch

    worst, equal = 0.0, True
    for k, w in want.items():
        g = got[k].detach().float().cpu()
        w = w.detach().float().cpu()
        equal &= torch.equal(g, w)
        worst = max(worst, rel_err(g, w)[1])
    return worst, equal


def _norm_gap(got: dict, want: dict) -> float:
    """|got - want| / |want| over all leaves as one vector (2-norms)."""
    import torch

    num = sum(float(torch.sum((got[k].detach().double().cpu()
                               - w.detach().double().cpu()) ** 2))
              for k, w in want.items())
    den = sum(float(torch.sum(w.detach().double().cpu() ** 2))
              for w in want.values())
    return (num / max(den, 1e-300)) ** 0.5


def phase_train(dev):
    """Three steps of the full-width encoder on the card and on the CPU from
    the same initial parameters, batches and draws (made on the CPU); the
    step-0 gradients of both are compared too."""
    import torch

    from repro_torch.core.rgcn import RGCNConfig, init_rgcn
    from repro_torch.core.train import (
        GCLTrainConfig, draw_seed, draw_step, packed_loss, train_step,
    )
    from repro_torch.optim import adamw_init

    batches = _training_batches(3)
    rc, tc = RGCNConfig(), GCLTrainConfig()
    out = {}
    for where in ("cpu", dev):
        enc = init_rgcn(tc.seed, rc).to(where)
        params = dict(enc.named_parameters())
        mu, nu = adamw_init(params)
        losses, grads = [], None
        t0 = time.perf_counter()
        for i, packed in enumerate(batches):
            b_cpu = {k: torch.from_numpy(v) for k, v in packed.items()}
            gen = torch.Generator().manual_seed(draw_seed(tc.seed, i))
            draws = draw_step(gen, b_cpu, rc)
            batch = {k: v.to(where) for k, v in b_cpu.items()}
            draws = tuple(d.to(where) for d in draws)
            if i == 0:
                loss, _ = packed_loss(enc, rc, tc.tau, batch, draws)
                grads = dict(zip(params, torch.autograd.grad(
                    loss, list(params.values()))))
            m = train_step(enc, rc, tc.tau, tc.opt, batch, draws, mu, nu, i)
            losses.append(float(m[0]))
        out[str(where)] = (losses, grads, params, time.perf_counter() - t0)
    (l_cpu, g_cpu, p_cpu, s_cpu), (l_card, g_card, p_card, s_card) = \
        out["cpu"], out[str(dev)]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(l_card, l_cpu))
    grad_gap = _norm_gap(g_card, g_cpu)
    grad_elem, _ = _param_gap(g_card, g_cpu)
    param_gap = _norm_gap(p_card, p_cpu)
    param_elem, _ = _param_gap(p_card, p_cpu)
    leaf_gap = max((_norm_gap({k: p_card[k]}, {k: p_cpu[k]}), k)
                   for k in p_cpu)
    P = [len(b["node_mask"]) for b in batches]
    log(f"[train] 3 steps, batches P={P}: losses card {l_card} cpu {l_cpu} "
        f"max rel loss gap {loss_gap:.3e} (tol {LOSS_TOL}); step-0 gradient "
        f"|card - cpu| / |cpu| {grad_gap:.3e} (tol {GRAD_TOL}; largest "
        f"element gap / max of its leaf {grad_elem:.3e}); parameters after "
        f"step 3 |card - cpu| / |cpu| {param_gap:.3e} (tol {PARAM_TOL}; "
        f"worst leaf {leaf_gap[1]} {leaf_gap[0]:.3e}, largest element gap / "
        f"max of its leaf {param_elem:.3e}); wall card {s_card:.2f} s cpu "
        f"{s_cpu:.2f} s")
    require(loss_gap <= LOSS_TOL, f"train: loss gap {loss_gap:.3e}")
    require(grad_gap <= GRAD_TOL, f"train: gradient gap {grad_gap:.3e}")
    require(param_gap <= PARAM_TOL, f"train: parameter gap {param_gap:.3e}")


def phase_resume(dev):
    """A fit interrupted at step 8 and resumed from its checkpoint against
    the uninterrupted fit, both on the card."""
    import tempfile

    from repro_torch.core.rgcn import RGCNConfig
    from repro_torch.core.train import (
        ContrastiveTrainer, FitInterrupted, GCLTrainConfig,
    )

    graphs = _phi2_training_graphs()
    tc = GCLTrainConfig(steps=16, checkpoint_every=4, log_every=8)
    full, i_full = ContrastiveTrainer(RGCNConfig(), tc, device=dev).fit(graphs)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ck:
        try:
            ContrastiveTrainer(RGCNConfig(), tc, device=dev).fit(
                graphs, checkpoint_dir=ck, interrupt_after=8)
            raise SmokeFailure("resume: the fit was not interrupted")
        except FitInterrupted:
            pass
        res, i_res = ContrastiveTrainer(RGCNConfig(), tc, device=dev).fit(
            graphs, checkpoint_dir=ck)
    p_res, p_full = dict(res.named_parameters()), dict(full.named_parameters())
    gap = _norm_gap(p_res, p_full)
    _, equal = _param_gap(p_res, p_full)
    same_hist = [h["loss"] for h in i_full["history"]] == \
        [h["loss"] for h in i_res["history"]]
    log(f"[resume] 16 steps, interrupted at 8, resumed from "
        f"{i_res['resumed_from']}: |resumed - full| / |full| over the "
        f"parameters {gap:.3e} (tol "
        f"{RESUME_TOL}) bits equal {equal} loss history equal {same_hist} "
        f"val_loss {i_full['val_loss']!r} vs {i_res['val_loss']!r}")
    require(i_res["resumed_from"] == 8, "resume: did not resume from step 8")
    require(gap <= RESUME_TOL, f"resume: parameter gap {gap:.3e}")


def _device_profile(prof):
    """(busy seconds, [(device us, name, count)] sorted) of a profile."""
    busy, top = 0.0, []
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        t = ev.self_cuda_time_total if t is None else t
        busy += t
        top.append((t, ev.key, ev.count))
    top.sort(reverse=True)
    return busy / 1e6, top


def phase_fit(dev):
    """The default fit on phi-2 through ``GCLSampler.train``, then the same
    fit under torch.profiler for the device's busy share and top ops."""
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.sampler import GCLSampler
    from repro_torch.kernels.rgcn_fused.ops import (
        rgcn_fused_agg_flat, rgcn_fused_bwd,
    )
    from repro_torch.kernels.rgcn_spmm.ops import rgcn_spmm_flat

    graphs = _phi2_training_graphs()
    wrappers = {"rgcn_fused_flat": rgcn_fused_agg_flat,
                "rgcn_fused_bwd": rgcn_fused_bwd,
                "rgcn_spmm_flat": rgcn_spmm_flat}
    for w in wrappers.values():
        w.launches = 0
    sampler = GCLSampler(device=dev)
    t0 = time.perf_counter()
    info = sampler.train(graphs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    hist = info["history"]
    steps = len(hist)
    pick = [i for i in (0, 50, steps - 1) if i < steps]
    losses = {i: hist[i]["loss"] for i in pick}
    log(f"[fit] phi-2: {len(graphs)} graphs, {steps} steps, bucket keys "
        f"{info['bucket_keys']}: loss at steps {losses} val_loss "
        f"{info['val_loss']!r} val_acc {info['val_acc']!r} steps/s "
        f"{steps / info['fit_s']:.2f} (step loop {info['fit_s']:.2f} s, "
        f"whole fit with packing and validation {wall:.2f} s) host syncs "
        f"{info['host_syncs']} launches {json.dumps(launches)} "
        f"({ {k: v / max(steps, 1) for k, v in launches.items()} } per step)")
    require(all(math.isfinite(h["loss"]) for h in hist),
            "fit: non-finite loss")
    require(hist[-1]["loss"] < hist[0]["loss"],
            f"fit: last loss {hist[-1]['loss']} not below the first "
            f"{hist[0]['loss']}")
    for name, count in launches.items():
        require(count > 0, f"fit: kernel {name} was never launched")

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        p_info = GCLSampler(device=dev).train(graphs)
        torch.cuda.synchronize()
        p_wall = time.perf_counter() - t0
    busy_s, top = _device_profile(prof)
    split: dict = {}
    for t, key, count in top:
        kind = next((k for k, marks in FIT_SPLIT if any(m in key for m in marks)),
                    "other (elementwise, reductions: autograd, LayerNorm, "
                    "AdamW, InfoNCE)")
        split[kind] = split.get(kind, 0.0) + t / 1e6
    launches_per_step = sum(c for t, k, c in top
                            if not k.startswith("Mem")) / len(hist)
    log(f"[fit] profiled fit: wall_s {p_wall:.3f} (step loop "
        f"{p_info['fit_s']:.3f} s) device busy_s {busy_s:.4f} busy share "
        f"{busy_s / p_wall:.4f} idle share {1 - busy_s / p_wall:.4f}; device "
        f"kernels per step {launches_per_step:.0f} (validation included)")
    for kind, t in sorted(split.items(), key=lambda kv: -kv[1]):
        log(f"[fit]   split {t * 1e3:9.3f} ms {100 * t / busy_s:5.1f} %  {kind}")
    for t, key, count in top[:12]:
        log(f"[fit]   {t / 1e3:9.3f} ms {100 * t / 1e6 / busy_s:5.1f} %  "
            f"x{count:<7d} {key[:70]}")
    return launches


def phase_fit_serve(rows, dev):
    """The slice's main path: a ``gcl`` method with no encoder behind a
    PlanService; submit_program(phi-2) fits (prepare) and serves, then cfd
    and nw are served with the fitted encoder."""
    import numpy as np

    from repro_torch.sampling import evaluate, get_method
    from repro_torch.serving import PlanService
    from repro_torch.tracing.programs import get_program

    with np.load(FIXTURE) as z:
        ref = {k: z[k] for k in z.files}
    for r in rows:
        r[3].launches = 0
    method = get_method("gcl", device=dev)
    with PlanService(device=dev, max_delay_ms=2.0) as svc:
        svc.warmup()
        for name in ("phi-2", "cfd", "nw"):
            prog = get_program(name)
            t0 = time.perf_counter()
            plan = svc.submit_program(method, prog).result(timeout=900)
            lat = time.perf_counter() - t0
            ev = evaluate(plan, prog, "P1")
            require(np.isfinite(ev.error_pct["cycles"])
                    and np.isfinite(ev.speedup), f"{name}: non-finite eval")
            jax = (f"(JAX fixture K {int(ref[f'{name}:k'])} eq5 "
                   f"{float(ref[f'{name}:error_cycles'])!r} eq6 "
                   f"{float(ref[f'{name}:speedup'])!r})"
                   if f"{name}:k" in ref else "(not in the JAX fixture)")
            train = plan.extra.get("train")
            log(f"[fit+serve] {name}: n={len(prog)} latency_s {lat:.3f} K "
                f"{plan.num_clusters} eq5 {ev.error_pct['cycles']!r} eq6 "
                f"{ev.speedup!r} {jax}"
                + (f" fitted here: {json.dumps(train)}" if train else
                   " encoder reused"))
        stats = svc.stats()
    launches = {r[0]: r[3].launches for r in rows}
    log(f"[fit+serve] stats {json.dumps(stats, default=str)}")
    log(f"[fit+serve] launches {json.dumps(launches)}")
    require(stats["errors"] == 0 and stats["served"] == 3,
            f"fit+serve: {stats['served']} served, {stats['errors']} errors")
    for name, count in launches.items():
        require(count > 0, f"fit+serve: kernel {name} was never launched")
    return launches


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
    phase_serve(rows, dev)
    log(f"[phase] serve {time.perf_counter() - t0:.2f} s")
    for name, phase in (("train", phase_train), ("resume", phase_resume),
                        ("fit", phase_fit)):
        t0 = time.perf_counter()
        phase(dev)
        log(f"[phase] {name} {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    launches = phase_fit_serve(rows, dev)
    log(f"[phase] fit+serve {time.perf_counter() - t0:.2f} s")
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
