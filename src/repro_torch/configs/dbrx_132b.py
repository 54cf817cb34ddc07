"""Copy of ``repro/configs/dbrx_132b.py`` for the PyTorch port (imports rewritten to
``repro_torch``; the port imports nothing of ``repro``).

dbrx-132b [moe] — fine-grained 16-expert top-4 MoE transformer.

[hf:databricks/dbrx-base; unverified].  40L, d_model=6144, 48 heads
(GQA kv=8), d_ff=10752 per expert, vocab=100352, MoE 16 experts top-4.
"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    num_experts=16,
    top_k=4,
)
