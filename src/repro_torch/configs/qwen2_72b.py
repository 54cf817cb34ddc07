"""Copy of ``repro/configs/qwen2_72b.py`` for the PyTorch port (imports rewritten to
``repro_torch``; the port imports nothing of ``repro``).

qwen2-72b [dense] — large GQA transformer with QKV bias.

[arXiv:2407.10671; hf].  80L, d_model=8192, 64 heads (GQA kv=8), d_ff=29568,
vocab=152064, QKV bias, rope_theta=1e6.

Scale note: 72B params -> the train_4k dry-run uses bf16 optimizer moments
(TrainConfig.opt_dtype='bfloat16' in the launcher for >30B archs) to fit
HBM; recorded in EXPERIMENTS.md §Dry-run.
"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-72b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
