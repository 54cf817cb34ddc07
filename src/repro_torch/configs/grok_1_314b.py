"""Copy of ``repro/configs/grok_1_314b.py`` for the PyTorch port (imports rewritten to
``repro_torch``; the port imports nothing of ``repro``).

grok-1-314b [moe] — 8-expert top-2 MoE transformer.

[hf:xai-org/grok-1; unverified].  64L, d_model=6144, 48 heads (GQA kv=8),
d_ff=32768 per expert, vocab=131072, MoE 8 experts top-2.

Scale note: 314B params.  Expert count (8) does not divide the model axis
(16), so the sharding rules shard expert d_ff over 'model' (TP-MoE) and the
expert stack over the FSDP axes; bf16 optimizer moments for the train cell.
"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    num_experts=8,
    top_k=2,
)
