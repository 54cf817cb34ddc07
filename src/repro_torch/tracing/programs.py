"""Copy of ``repro/tracing/programs.py`` for the PyTorch port (imports rewritten to
``repro_torch``; the port imports nothing of ``repro``).

The paper's 11 workloads (PolyBench / Rodinia / Tango / LLM) as synthetic
kernel-invocation streams.  The original's ``lm_program`` and its
``scn:`` / ``lm:`` / ``model:`` name spaces are left out of this copy:
``get_program`` raises ``KeyError`` for them until the port carries
``workloads/`` and ``configs/``.

Program structure encodes the behaviors the paper's evaluation hinges on:
- nw:   255 invocations with DISTINCT names, 2 behavior groups
        (name-based methods find no reduction; GCL-Sampler finds 2 clusters)
- lu:   2225 near-identical invocations with distinct names (massive speedup)
- 3mm:  9 invocations, distinct names, 3 shape groups
- AlexNet: two conv layers with ~equal instruction counts but different
        cache behavior (Sieve's instruction-count signature fails)
- backprop: 2 singleton kernels (no reduction opportunity; speedup 1x)
- phi-2: attention kernels whose library algorithm differs per platform
        (cuDNN heuristic quirk -> Table 3 cross-arch anomaly)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


from repro_torch.tracing.templates import make_kernel
from repro_torch.utils.registry import Registry


@dataclass
class Program:
    name: str
    kernels: list
    # extra content folded into `program_fingerprint` — generated programs
    # (repro.workloads) put their ScenarioSpec hash there so two same-named
    # programs built from different specs/seeds never share artifact keys,
    # and model-zoo programs record their trace window there (a caps change
    # must never replay another window's artifacts)
    fingerprint_extra: str = ""
    # default (cap_warps, cap_instr) trace window for this program; None =
    # the repo-wide defaults (repro_torch.config).  Model-zoo programs carry
    # 10-100x larger windows here (resolve_trace_caps consults it).
    trace_caps: Optional[tuple] = None

    def __len__(self):
        return len(self.kernels)


# name -> zero-arg builder; the paper suite registers below
PROGRAMS: Registry = Registry("program")


def _build_nw():
    # Two behavior groups with IDENTICAL instruction mix / count / grid
    # (PKA's feature space cannot separate them) but different spatial
    # locality: group 0 reuses cache lines (stride 32), group 1 streams
    # (stride 512, no reuse) -> different cycles.  The HRG sees the reuse as
    # shared memory-variable nodes.  All 255 invocation names are distinct
    # (name-keyed methods find no reduction).
    ks = []
    for i in range(255):
        which = i % 2
        params = (
            {"nx": 2048, "ny": 16, "pts": 5, "iters": 8,
             "stride": 32, "reuse": 4.0, "ilp": 3.0}
            if which == 0
            else {"nx": 2048, "ny": 16, "pts": 5, "iters": 8,
                  "stride": 512, "reuse": 1.0, "ilp": 3.0}
        )
        ks.append(
            make_kernel(
                f"needle_cuda_shared_{which + 1}_diag{i}", "stencil", params,
                i, seed=7,
            )
        )
    return Program("nw", ks)


def _build_lu():
    ks = []
    for i in range(2225):
        ks.append(
            make_kernel(
                f"lu_kernel_step{i}", "gemv",
                {"n": 2048, "m": 2048}, i, seed=11,
            )
        )
    return Program("lu", ks)


def _build_3mm():
    ks = []
    shapes = [
        ("mm3_kernel_E", {"M": 512, "N": 512, "K": 512}),
        ("mm3_kernel_F", {"M": 512, "N": 512, "K": 1024}),
        ("mm3_kernel_G", {"M": 512, "N": 1024, "K": 512}),
    ]
    seq = 0
    for run in range(3):
        for nm, p in shapes:
            ks.append(make_kernel(f"{nm}_run{run}", "gemm", p, seq, seed=13))
            seq += 1
    return Program("3mm", ks)


def _build_bfs():
    ks = []
    frontier = 256
    seq = 0
    for it in range(13):
        for which in range(2):
            ks.append(
                make_kernel(
                    "Kernel" if which == 0 else "Kernel2", "traversal",
                    {"nodes": 1_000_000, "degree": 8,
                     "frontier": int(frontier), "divergence": 0.4},
                    seq, seed=17,
                )
            )
            seq += 1
        frontier = frontier * 4 if it < 5 else max(frontier // 3, 64)
    return Program("bfs", ks)


def _build_cfd():
    ks = []
    seq = 0
    kinds = [
        ("cuda_compute_step_factor", "elementwise", {"n": 97_000 * 4, "nops": 6, "iters": 4}),
        ("cuda_compute_flux", "stencil", {"nx": 97_000, "ny": 4, "pts": 9, "iters": 16}),
        ("cuda_time_step", "elementwise", {"n": 97_000 * 4, "nops": 3, "iters": 4}),
        ("cuda_initialize_variables", "elementwise", {"n": 97_000 * 4, "nops": 1, "iters": 2}),
    ]
    for it in range(606):
        for nm, tmpl, p in kinds:
            ks.append(make_kernel(nm, tmpl, p, seq, seed=19))
            seq += 1
    ks.append(
        make_kernel("memset_like", "elementwise",
                    {"n": 97_000, "nops": 1, "iters": 1}, seq, seed=19)
    )
    return Program("cfd", ks)


def _build_lud():
    """40 decomposition steps whose launch geometry shrinks in quantized
    plateaus (the scheduler reuses tile configurations), so each name has a
    few repeated size groups.  PKA's z-scored feature space collapses here:
    the instruction MIX is identical across all gemm kernels, leaving a
    near-1-D instruction-count axis whose silhouette prefers 2-3 coarse
    clusters -> large reconstruction error (the paper's 60.8% lud failure);
    the HRG sees per-group footprints/strides and separates exactly."""
    ks = []
    seq = 0
    sizes = [2048, 1536, 1024, 512]
    for step in range(40):
        rem = sizes[step // 10]
        ks.append(make_kernel("lud_diagonal", "gemm",
                              {"M": 64, "N": 64, "K": 64}, seq, seed=23))
        seq += 1
        ks.append(make_kernel("lud_perimeter", "gemm",
                              {"M": rem, "N": 128, "K": 64}, seq, seed=23))
        seq += 1
        ks.append(make_kernel("lud_internal", "gemm",
                              {"M": rem, "N": rem, "K": 64}, seq, seed=23))
        seq += 1
    return Program("lud", ks)


def _build_backprop():
    # Same template, same instruction mix AND total count — but one kernel is
    # a 1-CTA latency-bound reduction and the other a 576-CTA streaming pass.
    # PKA's microarch-independent features are identical -> it merges them
    # (the paper's 55.2% backprop error); the traces differ structurally
    # (S2R ctaid values, loop trip counts), so GCL-Sampler separates them.
    ks = [
        make_kernel("bpnn_layerforward_CUDA", "gemv",
                    {"n": 16, "m": 147_456, "acc_regs": 1}, 0, seed=29),
        make_kernel("bpnn_adjust_weights_cuda", "gemv",
                    {"n": 36_864, "m": 256, "acc_regs": 2}, 1, seed=29),
    ]
    return Program("backprop", ks)


def _build_alexnet():
    """All convolutions run under the SAME library kernel name (the cuDNN
    reality).  conv2 (implicit-gemm) and conv3 (winograd) are tuned to ~equal
    dynamic instruction counts with very different ILP behavior — Sieve's
    instruction-count signature merges them (the paper's 29.2% AlexNet
    error); GCL-Sampler sees the different loop bodies."""
    ks = []
    seq = 0
    layers = [
        ("implicit_convolve_sgemm", "conv", {"c": 3, "hw": 55, "k": 96, "r": 11}),
        ("activation_fw_4d_kernel", "elementwise", {"n": 96 * 55 * 55, "nops": 1, "iters": 2}),
        ("pooling_fw_4d_kernel", "stencil", {"nx": 96 * 27, "ny": 27, "pts": 9, "iters": 4}),
        # conv2: implicit gemm, 15-instr body x 75 iters x 680 CTAs
        # (convs dominate AlexNet runtime, as on real hardware)
        ("implicit_convolve_sgemm", "conv",
         {"c": 96, "hw": 27, "k": 256, "r": 5, "ctas": 2000}),
        ("activation_fw_4d_kernel", "elementwise", {"n": 256 * 27 * 27, "nops": 1, "iters": 2}),
        ("pooling_fw_4d_kernel", "stencil", {"nx": 256 * 13, "ny": 13, "pts": 9, "iters": 4}),
        # conv3: winograd, 12-instr body x 93 iters x 680 CTAs (~equal count,
        # very different ILP -> Sieve's instruction-count signature merges
        # two kernels whose cycles differ ~2x)
        ("implicit_convolve_sgemm", "conv",
         {"c": 186, "hw": 13, "k": 256, "r": 4, "ctas": 2000, "algo": "winograd"}),
        ("activation_fw_4d_kernel", "elementwise", {"n": 384 * 13 * 13, "nops": 1, "iters": 2}),
        ("implicit_convolve_sgemm", "conv", {"c": 384, "hw": 13, "k": 384, "r": 3}),
        ("activation_fw_4d_kernel", "elementwise", {"n": 384 * 13 * 13, "nops": 1, "iters": 2}),
        ("implicit_convolve_sgemm", "conv", {"c": 384, "hw": 13, "k": 256, "r": 3}),
        ("activation_fw_4d_kernel", "elementwise", {"n": 256 * 13 * 13, "nops": 1, "iters": 2}),
        ("pooling_fw_4d_kernel", "stencil", {"nx": 256 * 6, "ny": 6, "pts": 9, "iters": 4}),
        ("ampere_sgemm_fc", "gemm", {"M": 128, "N": 4096, "K": 9216}),
        ("activation_fw_4d_kernel", "elementwise", {"n": 4096 * 128, "nops": 1, "iters": 2}),
        ("ampere_sgemm_fc", "gemm", {"M": 128, "N": 4096, "K": 4096}),
        ("activation_fw_4d_kernel", "elementwise", {"n": 4096 * 128, "nops": 1, "iters": 2}),
        ("ampere_sgemm_fc", "gemm", {"M": 128, "N": 1000, "K": 4096}),
        ("softmax_fw_kernel", "softmax", {"rows": 128, "cols": 1000}),
    ]
    for nm, tmpl, p in layers:
        ks.append(make_kernel(nm, tmpl, p, seq, seed=31))
        seq += 1
    # training-style backward pass (wgrad/dgrad kernels reuse the shapes)
    for nm, tmpl, p in layers:
        ks.append(make_kernel(f"{nm}_wgrad", tmpl, p, seq, seed=31))
        seq += 1
    return Program("AlexNet", ks)


# ---------------------------------------------------------------------------
# LLM programs
# ---------------------------------------------------------------------------


def _lm_layer_kernels(prefix, d_model, d_ff, n_heads, seq_len, decode,
                      seq_start, seed, attn_algo="implicit_gemm",
                      moe=None, mamba=None):
    """Kernel stream for one transformer layer step."""
    ks = []
    s = seq_start
    T = 1 if decode else seq_len
    gem = "gemv" if decode else "gemm"

    def gemm_p(m, n, k):
        return {"n": n, "m": k} if decode else {"M": max(m, 64), "N": n, "K": k}

    ks.append(make_kernel(f"{prefix}_rmsnorm", "softmax",
                          {"rows": T, "cols": d_model}, s, seed)); s += 1
    if mamba is not None:
        din = mamba["d_inner"]
        ks.append(make_kernel(f"vectorized_elementwise_conv", "elementwise",
                              {"n": T * din, "nops": 4, "iters": 4}, s, seed)); s += 1
        ks.append(make_kernel(f"cutlass_80_ssd_{din}x{d_model}", gem,
                              gemm_p(T, 2 * din, d_model), s, seed)); s += 1
        ks.append(make_kernel(f"ssd_chunk_scan", "reduction",
                              {"n": T * din}, s, seed)); s += 1
        ks.append(make_kernel(f"cutlass_80_out_{d_model}x{din}", gem,
                              gemm_p(T, d_model, din), s, seed)); s += 1
    else:
        ks.append(make_kernel(f"cutlass_80_tensorop_qkv_{d_model}", gem,
                              gemm_p(T, 3 * d_model, d_model), s, seed)); s += 1
        ks.append(make_kernel(f"{attn_algo}_attention_fwd", "conv",
                              {"c": n_heads, "hw": min(seq_len, 128), "k": 64,
                               "r": 3, "algo": attn_algo}, s, seed)); s += 1
        ks.append(make_kernel(f"softmax_warp_fwd", "softmax",
                              {"rows": T * n_heads, "cols": seq_len}, s, seed)); s += 1
        ks.append(make_kernel(f"cutlass_80_tensorop_o_{d_model}", gem,
                              gemm_p(T, d_model, d_model), s, seed)); s += 1
    if moe is not None:
        E, topk = moe["experts"], moe["top_k"]
        ks.append(make_kernel("moe_router_topk", "softmax",
                              {"rows": T, "cols": E}, s, seed)); s += 1
        ks.append(make_kernel(f"grouped_gemm_moe_{d_ff}", gem,
                              gemm_p(T * topk // max(E // 4, 1), d_ff, d_model), s, seed)); s += 1
        ks.append(make_kernel(f"grouped_gemm_moe_down_{d_ff}", gem,
                              gemm_p(T * topk // max(E // 4, 1), d_model, d_ff), s, seed)); s += 1
    elif d_ff > 0:
        ks.append(make_kernel(f"cutlass_80_tensorop_ffn_up_{d_ff}", gem,
                              gemm_p(T, d_ff, d_model), s, seed)); s += 1
        ks.append(make_kernel(f"cutlass_80_tensorop_ffn_down_{d_ff}", gem,
                              gemm_p(T, d_model, d_ff), s, seed)); s += 1
    return ks, s


def _build_llm(name, layers, d_model, d_ff, n_heads, steps, seq_len, seed,
               platform_sensitive=False):
    ks = []
    s = 0
    for step in range(steps):
        decode = step > 0  # step 0 = prefill, rest = decode
        algo = "cudnn_heuristic" if platform_sensitive else "implicit_gemm"
        for layer in range(layers):
            lk, s = _lm_layer_kernels(
                f"L{layer}", d_model, d_ff, n_heads, seq_len, decode, s, seed,
                attn_algo=algo,
            )
            ks.extend(lk)
        ks.append(make_kernel("lm_head_logits", "gemv" if decode else "gemm",
                              {"n": 50_000, "m": d_model} if decode
                              else {"M": max(seq_len, 64), "N": 50_000, "K": d_model},
                              s, seed)); s += 1
    for k in ks:
        k.seq = ks.index(k) if False else k.seq  # seq already assigned
    # re-sequence deterministically
    for i, k in enumerate(ks):
        k.seq = i
    return Program(name, ks)


def _build_qwen15():
    return _build_llm("qwen1.5", layers=24, d_model=2048, d_ff=5504,
                      n_heads=16, steps=4, seq_len=512, seed=37)


def _build_phi2():
    return _build_llm("phi-2", layers=32, d_model=2560, d_ff=10240,
                      n_heads=32, steps=5, seq_len=512, seed=41,
                      platform_sensitive=True)


def _build_pythia():
    return _build_llm("pythia", layers=24, d_model=2048, d_ff=8192,
                      n_heads=16, steps=5, seq_len=512, seed=43)


_BUILDERS = {
    "nw": _build_nw, "lu": _build_lu, "3mm": _build_3mm, "bfs": _build_bfs,
    "cfd": _build_cfd, "lud": _build_lud, "backprop": _build_backprop,
    "AlexNet": _build_alexnet, "qwen1.5": _build_qwen15,
    "phi-2": _build_phi2, "pythia": _build_pythia,
}
for _name, _builder in _BUILDERS.items():
    PROGRAMS.add(_name, _builder)

PAPER_PROGRAMS = list(_BUILDERS)


_cache: dict = {}

#: name prefixes of the original's generated programs; their builders need
#: ``workloads/`` and ``configs/``, which the port has not copied yet
PENDING_PREFIXES = ("scn:", "lm:", "model:")


def get_program(name: str) -> Program:
    if name.startswith(PENDING_PREFIXES):
        raise KeyError(
            f"program {name!r}: scenario, lm: and model: programs are not in "
            f"the PyTorch port yet (ROADMAP.md, queue A: ingest/workloads/"
            f"configs slice); the 11 paper programs are")
    if name not in _cache:
        if name in PROGRAMS:
            _cache[name] = PROGRAMS.get(name)()
        else:
            raise KeyError(f"unknown program {name!r}")
    return _cache[name]
