"""Copy of ``repro/configs/granite_3_2b.py`` for the PyTorch port (imports rewritten to
``repro_torch``; the port imports nothing of ``repro``).

granite-3-2b [dense] — GQA dense transformer.

[hf:ibm-granite/granite-3.0-2b-base; hf].  40L, d_model=2048, 32 heads
(GQA kv=8), d_ff=8192, vocab=49155 (not divisible by 16; GSPMD pads the vocab
shard — exercised deliberately in the dry-run).  Tied embeddings.
"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-3-2b",
    family="dense",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=49155,
    tie_embeddings=True,
)
