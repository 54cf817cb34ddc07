"""Copy of ``repro/configs/musicgen_medium.py`` for the PyTorch port (imports rewritten to
``repro_torch``; the port imports nothing of ``repro``).

musicgen-medium [audio] — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284; hf].  48L, d_model=1536, 24 heads (kv=24, i.e. MHA),
d_ff=6144, vocab=2048.  The EnCodec frontend is a STUB: ``input_specs()``
provides precomputed frame embeddings (B, S, d_model); the backbone consumes
them alongside token embeddings.
"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    frontend="audio",
)
