"""Copy of ``repro/configs/jamba_v0_1_52b.py`` for the PyTorch port (imports rewritten to
``repro_torch``; the port imports nothing of ``repro``).

jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave with MoE.

[arXiv:2403.19887; hf].  32L, d_model=4096, 32 heads (GQA kv=8), d_ff=14336,
vocab=65536, MoE 16 experts top-2.  Period-8 block: attention at in-block
position 4 (1:7 attn:mamba), MoE FFN every other layer.

Adaptation note (DESIGN.md §3): Jamba v0.1 uses Mamba-1 mixers; our SSM layer
is the Mamba-2/SSD form (the TPU-native chunked formulation shared with
mamba2-780m).  State size kept at 128.
"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    num_experts=16,
    top_k=2,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    block_size=8,
    attn_positions=(4,),
    moe_positions=(1, 3, 5, 7),
)
