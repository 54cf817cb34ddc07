"""Copy of ``repro/workloads/modelzoo.py`` for the PyTorch port (imports rewritten to
``repro_torch``; the port imports nothing of ``repro``).

The in-repo model zoo as a trace-pack workload suite.

``model:<arch_id>[:phase]`` derives a `Program` from an assigned
architecture config (`repro_torch.configs.ARCHS`) by walking its per-layer specs
(attention / mamba mixers, dense / MoE FFNs) through the same library-kernel
stream builder the paper's LLM workloads use — but at REAL phase shapes and
with a 10-100x larger trace window than the scenario families:

    phase     shapes                       trace window (cap_warps, cap_instr)
    prefill   seq 2048, full-layer gemms   (4, 2048)   -> ~42x default graphs
    decode    4 steps against a 4096 ctx   (4, 1024)   -> ~21x default graphs

The window rides on `Program.trace_caps` (resolved by
``repro_torch.config.resolve_trace_caps``) and is ALSO folded into
``fingerprint_extra``, so artifacts and cached graphs for one window can
never be replayed at another.  This is the ROADMAP's "real-model trace pack"
item — the SimNet/NPS-style real-workload stress test for the ingestion
engine (DESIGN.md §13).
"""

from __future__ import annotations

from repro_torch.tracing.programs import Program, _lm_layer_kernels

#: default model-zoo grid: one dense-attention, one pure-SSM, one MoE arch
MODEL_ZOO = ("llama3.2-3b", "mamba2-780m", "dbrx-132b")
PHASES = ("prefill", "decode")

#: per-phase trace window — the "10-100x larger graphs" knob
PHASE_CAPS = {"prefill": (4, 2048), "decode": (4, 1024)}
#: prefill sequence length / decode KV-context length
PHASE_SEQ = {"prefill": 2048, "decode": 4096}
#: decode emits several steps (real decode is many small identical launches
#: — the ingest engine's dedup memo is what makes this cheap)
DECODE_STEPS = 4


def zoo_names(archs=MODEL_ZOO, phases=PHASES) -> list[str]:
    return [f"model:{a}:{p}" for a in archs for p in phases]


def model_program(name: str) -> Program:
    """Build ``model:<arch_id>[:phase]`` (phase defaults to prefill)."""
    parts = name.split(":")
    if len(parts) not in (2, 3) or parts[0] != "model":
        raise KeyError(f"bad model program name {name!r} "
                       "(want model:<arch_id>[:phase])")
    arch_id = parts[1]
    phase = parts[2] if len(parts) == 3 else "prefill"
    if phase not in PHASES:
        raise KeyError(f"unknown phase {phase!r} (want one of {PHASES})")

    from repro_torch.config import FFN_MOE, MIXER_MAMBA2
    from repro_torch.configs import get_arch

    cfg = get_arch(arch_id)
    seq_len = PHASE_SEQ[phase]
    decode = phase == "decode"
    steps = DECODE_STEPS if decode else 1
    seed = 211 if decode else 199

    ks = []
    s = 0
    for _step in range(steps):
        for layer in range(cfg.num_layers):
            spec = cfg.layer_specs()[layer % cfg.block_size]
            moe = (
                {"experts": cfg.num_experts, "top_k": cfg.top_k}
                if spec.ffn == FFN_MOE else None
            )
            mamba = (
                {"d_inner": cfg.d_inner}
                if spec.mixer == MIXER_MAMBA2 else None
            )
            lk, s = _lm_layer_kernels(
                f"L{layer}", cfg.d_model, cfg.d_ff, max(cfg.num_heads, 1),
                seq_len, decode, s, seed=seed, moe=moe, mamba=mamba,
            )
            ks.extend(lk)
        ks.append(
            make_head_kernel(cfg, seq_len, decode, s, seed))
        s += 1
    for i, k in enumerate(ks):
        k.seq = i

    caps = PHASE_CAPS[phase]
    full_name = f"model:{arch_id}:{phase}"
    return Program(
        full_name, ks,
        fingerprint_extra=f"modelzoo|{arch_id}|{phase}"
                          f"|cw{caps[0]}ci{caps[1]}",
        trace_caps=caps,
    )


def make_head_kernel(cfg, seq_len, decode, seq, seed):
    from repro_torch.tracing.templates import make_kernel

    if decode:
        return make_kernel("lm_head_logits", "gemv",
                           {"n": cfg.vocab_size, "m": cfg.d_model},
                           seq, seed)
    return make_kernel("lm_head_logits", "gemm",
                       {"M": max(seq_len, 64), "N": cfg.vocab_size,
                        "K": cfg.d_model}, seq, seed)
