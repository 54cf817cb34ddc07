"""The LM backbone of the model zoo (counterpart of ``repro/models``):
prefill through K7 (attention) and K8 (SSD), KV / SSM-cache decode.
``lm_loss`` waits for LM training; MoE archs raise."""

from repro_torch.models.transformer import (  # noqa: F401
    decode_step,
    forward,
    init_decode_state,
    init_params,
    prefill,
)
