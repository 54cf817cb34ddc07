"""Copy of ``repro/configs/llama3_2_3b.py`` for the PyTorch port (imports rewritten to
``repro_torch``; the port imports nothing of ``repro``).

llama3.2-3b [dense] — small llama3-family GQA transformer.

[hf:meta-llama/Llama-3.2-1B; unverified].  28L, d_model=3072, 24 heads
(GQA kv=8), d_ff=8192, vocab=128256, rope_theta=500k, tied embeddings.
"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama3.2-3b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500_000.0,
    tie_embeddings=True,
)
