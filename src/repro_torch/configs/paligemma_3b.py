"""Copy of ``repro/configs/paligemma_3b.py`` for the PyTorch port (imports rewritten to
``repro_torch``; the port imports nothing of ``repro``).

paligemma-3b [vlm] — SigLIP vision frontend + gemma decoder backbone.

[arXiv:2407.07726; hf].  Backbone: 18L, d_model=2048, 8 heads (GQA kv=1,
i.e. MQA), head_dim=256, d_ff=16384, vocab=257216.

The SigLIP frontend is a STUB: ``input_specs()`` provides 256 precomputed
patch embeddings (B, 256, d_model) that the backbone prepends to the token
embeddings (prefix-LM style; the dry-run subject is the transformer backbone).
"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    frontend="vision",
    frontend_tokens=256,
)
