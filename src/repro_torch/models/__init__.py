"""The LM backbone of the model zoo (counterpart of ``repro/models``):
prefill through K7 (attention) and K8 (SSD), the MoE FFN
(``models/moe.py``), KV / SSM-cache decode, and ``lm_loss`` for
training."""

from repro_torch.models.transformer import (  # noqa: F401
    decode_step,
    forward,
    init_decode_state,
    init_params,
    prefill,
)
