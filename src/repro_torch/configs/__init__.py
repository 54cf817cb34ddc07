"""Copy of ``repro/configs/__init__.py`` for the PyTorch port (imports rewritten to
``repro_torch``; the port imports nothing of ``repro``).

Assigned-architecture registry: ``--arch <id>`` resolves here.

One module per architecture (public config, with [source] notes inline).
``get_arch(id)`` returns the full published config; ``smoke_arch(id)`` returns
a reduced same-family config for CPU smoke tests.
"""

from __future__ import annotations

import dataclasses

from repro_torch.config import ModelConfig
from repro_torch.utils.registry import Registry

from repro_torch.configs import (
    jamba_v0_1_52b,
    musicgen_medium,
    granite_3_2b,
    llama3_2_3b,
    qwen2_72b,
    yi_34b,
    mamba2_780m,
    grok_1_314b,
    dbrx_132b,
    paligemma_3b,
)

ARCHS: Registry[ModelConfig] = Registry("architecture")

for _mod in (
    jamba_v0_1_52b,
    musicgen_medium,
    granite_3_2b,
    llama3_2_3b,
    qwen2_72b,
    yi_34b,
    mamba2_780m,
    grok_1_314b,
    dbrx_132b,
    paligemma_3b,
):
    ARCHS.add(_mod.CONFIG.arch_id, _mod.CONFIG)


def get_arch(arch_id: str) -> ModelConfig:
    return ARCHS.get(arch_id)


def list_archs() -> list[str]:
    return ARCHS.names()


def smoke_arch(arch_id: str) -> ModelConfig:
    """Reduced same-family config: small widths, few experts, tiny vocab.

    Preserves the structural skeleton (block layout, mixer kinds, MoE top-k,
    GQA grouping, frontend) so smoke tests exercise the same code paths as the
    full config.
    """
    cfg = get_arch(arch_id)
    num_kv = min(cfg.num_kv_heads, 2) if cfg.num_heads else 0
    num_heads = 4 if cfg.num_heads else 0
    kw = dict(
        num_layers=cfg.block_size,  # one block
        d_model=64,
        num_heads=num_heads,
        num_kv_heads=max(1, num_kv) if num_heads else 0,
        head_dim=16 if num_heads else 0,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=512,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_headdim=16 if cfg.ssm_state else 64,
        ssm_chunk=32,
        attn_chunk=64,
        attn_chunk_threshold=128,
        loss_chunk=64,
        frontend_tokens=8 if cfg.frontend_tokens else 0,
        num_experts=min(cfg.num_experts, 4),
        top_k=min(cfg.top_k, 2),
        param_dtype="float32",
        compute_dtype="float32",
    )
    # keep MQA archs MQA
    if cfg.num_kv_heads == 1:
        kw["num_kv_heads"] = 1
    return dataclasses.replace(cfg, **kw)
