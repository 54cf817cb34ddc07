"""Copy of ``repro/configs/yi_34b.py`` for the PyTorch port (imports rewritten to
``repro_torch``; the port imports nothing of ``repro``).

yi-34b [dense] — llama-architecture GQA transformer.

[arXiv:2403.04652; hf].  60L, d_model=7168, 56 heads (GQA kv=8), d_ff=20480,
vocab=64000, rope_theta=5e6.
"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="yi-34b",
    family="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    rope_theta=5_000_000.0,
)
