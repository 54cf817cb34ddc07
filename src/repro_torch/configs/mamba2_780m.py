"""Copy of ``repro/configs/mamba2_780m.py`` for the PyTorch port (imports rewritten to
``repro_torch``; the port imports nothing of ``repro``).

mamba2-780m [ssm] — attention-free SSD (state-space duality) model.

[arXiv:2405.21060; unverified].  48L, d_model=1536, attn-free, d_ff=0
(mamba blocks only), vocab=50280, ssm_state=128, expand=2, headdim=64
(-> d_inner=3072, 48 SSD heads), conv window 4.

Runs the long_500k shape (sub-quadratic; O(1)-state decode).
"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_conv=4,
    tie_embeddings=True,
)
