"""Copy of ``repro/workloads/scenarios.py`` for the PyTorch port (imports rewritten to
``repro_torch``; the port imports nothing of ``repro``).

Scenario families: seeded generators composing the kernel template
library (`tracing/templates.py`) into phase-structured synthetic programs.

Each family stresses one axis of the paper's evaluation space that the fixed
11-program suite samples only once (or not at all):

  iterative   — loop-heavy convergence phases: a stencil sweep + periodic
                residual reduction repeated per phase, with per-phase
                locality shifts (the `nw` structure, parameterized)
  phase_shift — distinct behavior regimes back-to-back (gemm phase ->
                elementwise phase -> traversal phase ...), every invocation
                distinctly named so name-keyed methods find no reduction
  mem_mix     — compute-bound / memory-bound interleaving with a seeded mix
                ratio (roofline coverage: both sides of the ridge)
  divergent   — graph-traversal phases with frontier growth/decay and
                per-phase branch divergence (the `bfs` axis, generalized)
  pipeline    — multi-kernel pipelines repeated per frame (preproc ->
                gemm -> softmax -> postproc), steady-state invocation reuse
  long_tail   — Zipf-skewed invocation counts over a pool of distinct
                kernels: few hot kernels dominate, many appear once (the
                reduction-opportunity profile of real LLM serving traces)

Every generator is a pure function of its :class:`ScenarioSpec`: same spec
-> identical kernel stream (names, templates, params, seeds).
"""

from __future__ import annotations

import numpy as np

from repro_torch.tracing.programs import Program
from repro_torch.tracing.templates import make_kernel
from repro_torch.utils.registry import Registry
from repro_torch.workloads.spec import ScenarioSpec, is_scenario_name, spec_from_name

# family id -> generator(spec, rng) yielding (name, template, params)
FAMILIES: Registry = Registry("scenario family")


def _dim(rng, lo, hi, scale, quant=64):
    """Seeded problem dimension in [lo, hi] * scale, quantized."""
    v = int(rng.integers(lo, hi + 1) * scale)
    return max(quant, (v // quant) * quant)


@FAMILIES.register("iterative")
def _gen_iterative(spec: ScenarioSpec, rng):
    for p in range(spec.phases):
        nx = _dim(rng, 512, 4096, spec.scale)
        ny = int(rng.integers(8, 32))
        pts = int(rng.choice([5, 9]))
        stride = int(rng.choice([32, 128, 512]))
        reuse = float(rng.choice([1.0, 2.0, 4.0]))
        for it in range(spec.phase_len):
            yield (f"sweep_p{p}_it{it}", "stencil",
                   {"nx": nx, "ny": ny, "pts": pts, "iters": 8,
                    "stride": stride, "reuse": reuse})
            if it % 4 == 3:  # periodic convergence check
                yield (f"residual_norm_p{p}", "reduction", {"n": nx * ny})


@FAMILIES.register("phase_shift")
def _gen_phase_shift(spec: ScenarioSpec, rng):
    regimes = ["gemm", "elementwise", "traversal", "softmax", "gemv"]
    seq = 0
    for p in range(spec.phases):
        tmpl = regimes[int(rng.integers(0, len(regimes)))]
        if tmpl == "gemm":
            d = _dim(rng, 128, 1024, spec.scale)
            params = {"M": d, "N": d, "K": _dim(rng, 128, 2048, spec.scale)}
        elif tmpl == "elementwise":
            params = {"n": _dim(rng, 65536, 1 << 20, spec.scale),
                      "nops": int(rng.integers(1, 6)), "iters": 4}
        elif tmpl == "traversal":
            params = {"nodes": _dim(rng, 1 << 16, 1 << 20, spec.scale),
                      "degree": int(rng.integers(4, 16)),
                      "frontier": _dim(rng, 256, 4096, 1.0),
                      "divergence": float(rng.uniform(0.1, 0.6))}
        elif tmpl == "softmax":
            params = {"rows": _dim(rng, 64, 512, spec.scale),
                      "cols": _dim(rng, 256, 4096, spec.scale)}
        else:  # gemv
            params = {"n": _dim(rng, 256, 2048, spec.scale),
                      "m": _dim(rng, 1024, 8192, spec.scale)}
        for it in range(spec.phase_len):
            # distinct names per invocation: name-keyed methods see no reuse
            yield (f"{tmpl}_phase{p}_call{seq + it}", tmpl, params)
        seq += spec.phase_len


@FAMILIES.register("mem_mix")
def _gen_mem_mix(spec: ScenarioSpec, rng):
    ratio = float(rng.uniform(0.2, 0.8))  # fraction of compute-bound calls
    d = _dim(rng, 256, 1024, spec.scale)
    k_big = _dim(rng, 1024, 4096, spec.scale)
    n_stream = _dim(rng, 1 << 18, 1 << 21, spec.scale)
    for p in range(spec.phases):
        for it in range(spec.phase_len):
            if rng.random() < ratio:  # compute-bound: deep-K gemm
                yield (f"compute_gemm_p{p}_{it}", "gemm",
                       {"M": d, "N": d, "K": k_big})
            else:  # memory-bound: 1-op streaming pass
                yield (f"stream_pass_p{p}_{it}", "elementwise",
                       {"n": n_stream, "nops": 1, "iters": 2})


@FAMILIES.register("divergent")
def _gen_divergent(spec: ScenarioSpec, rng):
    nodes = _dim(rng, 1 << 18, 1 << 21, spec.scale)
    degree = int(rng.integers(4, 16))
    frontier = 256.0
    for p in range(spec.phases):
        div = float(rng.uniform(0.1, 0.8))
        growth = float(rng.uniform(2.0, 4.0)) if p < spec.phases / 2 \
            else float(rng.uniform(0.25, 0.6))
        for it in range(spec.phase_len):
            yield (f"expand_frontier_p{p}", "traversal",
                   {"nodes": nodes, "degree": degree,
                    "frontier": int(max(frontier, 64)), "divergence": div})
            yield (f"compact_frontier_p{p}", "elementwise",
                   {"n": int(max(frontier, 64)) * 4, "nops": 2, "iters": 2})
            frontier = min(frontier * growth, nodes / 4)


@FAMILIES.register("pipeline")
def _gen_pipeline(spec: ScenarioSpec, rng):
    # one steady-state pipeline shape per program; `phases * phase_len` frames
    d_in = _dim(rng, 128, 512, spec.scale)
    d_mid = _dim(rng, 256, 1024, spec.scale)
    rows = _dim(rng, 64, 256, spec.scale)
    stages = [
        ("pre_normalize", "elementwise",
         {"n": rows * d_in, "nops": 3, "iters": 4}),
        ("stage_gemm_a", "gemm", {"M": rows, "N": d_mid, "K": d_in}),
        ("stage_softmax", "softmax", {"rows": rows, "cols": d_mid}),
        ("stage_gemm_b", "gemm", {"M": rows, "N": d_in, "K": d_mid}),
        ("post_reduce", "reduction", {"n": rows * d_in}),
    ]
    for frame in range(spec.phases * spec.phase_len):
        for nm, tmpl, params in stages:
            yield (nm, tmpl, params)


@FAMILIES.register("long_tail")
def _gen_long_tail(spec: ScenarioSpec, rng):
    # pool of distinct kernels; rank r gets ~ N / r^skew invocations
    pool = []
    templates = ["gemm", "elementwise", "stencil", "softmax", "gemv",
                 "reduction"]
    n_distinct = max(2, spec.phases * spec.phase_len // 2)
    for r in range(n_distinct):
        tmpl = templates[int(rng.integers(0, len(templates)))]
        if tmpl == "gemm":
            d = _dim(rng, 128, 768, spec.scale)
            params = {"M": d, "N": d, "K": d}
        elif tmpl == "elementwise":
            params = {"n": _dim(rng, 1 << 16, 1 << 19, spec.scale),
                      "nops": int(rng.integers(1, 5)), "iters": 3}
        elif tmpl == "stencil":
            params = {"nx": _dim(rng, 512, 2048, spec.scale),
                      "ny": int(rng.integers(8, 32)), "pts": 5, "iters": 6}
        elif tmpl == "softmax":
            params = {"rows": _dim(rng, 64, 256, spec.scale),
                      "cols": _dim(rng, 256, 2048, spec.scale)}
        elif tmpl == "gemv":
            params = {"n": _dim(rng, 256, 1024, spec.scale),
                      "m": _dim(rng, 1024, 4096, spec.scale)}
        else:
            params = {"n": _dim(rng, 1 << 17, 1 << 20, spec.scale)}
        count = max(1, int(spec.phases * spec.phase_len
                           / float(r + 1) ** spec.skew))
        pool.append((f"hot_{tmpl}_{r}", tmpl, params, count))
    # interleave invocations in a seeded shuffled order
    stream = [entry[:3] for entry in pool for _ in range(entry[3])]
    for i in rng.permutation(len(stream)):
        yield stream[int(i)]


def build_scenario(spec: ScenarioSpec) -> Program:
    """Materialize the kernel-invocation stream for one spec.

    KernelInvocation objects are lightweight (traces are generated lazily),
    so building the Program is cheap; the streaming path
    (`repro_torch.workloads.streaming`) keeps the expensive trace->graph stage
    bounded.
    """
    gen = FAMILIES.get(spec.family)
    rng = np.random.default_rng(spec.rng_seed())
    kseed = spec.kernel_seed()
    kernels = [
        make_kernel(name, tmpl, params, seq, seed=kseed)
        for seq, (name, tmpl, params) in enumerate(gen(spec, rng))
    ]
    if not kernels:
        raise ValueError(f"scenario {spec.name!r} generated no kernels")
    return Program(spec.name, kernels, fingerprint_extra=spec.content_hash())


def scenario_program(name: str) -> Program:
    """`scn:<family>[:k=v,...]` -> Program (the `get_program` hook)."""
    return build_scenario(spec_from_name(name))


def scenario_families() -> list[str]:
    return FAMILIES.names()


def scenario_matrix(families=None, seeds=(0,), *, phases=None, phase_len=None,
                    scale=None) -> list[str]:
    """Spec names for a family x seed grid (the `--suite scenarios` axis)."""
    kwargs = {k: v for k, v in
              [("phases", phases), ("phase_len", phase_len), ("scale", scale)]
              if v is not None}
    return [
        ScenarioSpec(family=f, seed=int(s), **kwargs).name
        for f in (families or scenario_families())
        for s in seeds
    ]


def scenario_family_of(program_name: str) -> str:
    """Grouping key for results rows: scenario family, or 'paper'."""
    if is_scenario_name(program_name):
        return spec_from_name(program_name).family
    return "paper"
